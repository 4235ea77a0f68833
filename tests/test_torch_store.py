"""The port's durable store (``repro_torch.serving.store``) against the
JAX package's (``repro.serving.store``): the grid and network hashes equal
for the same inputs; entries, journals and checkpoints written by either
package read in the other, stream payloads bit for bit; every damage mode
quarantines, or is dropped from the journal, exactly as in the reference
(the same reasons, the same counters)."""

import json
import os

import numpy as np
import pytest

from repro.core import accelerator as ref_acc
from repro.core import energymodel as ref_em
from repro.serving import store as ref_store
from repro_torch.core import accelerator, convert, energymodel as em
from repro_torch.serving import store

from torch_service_pairs import paired_networks, small_grids

KEY = ("g0", "nets", "answer", "best_config", "edp")
KEY2 = ("g0", "nets", "stream", "edp")
PKGS = {"ref": ref_store, "port": store}


@pytest.fixture(scope="module")
def space():
    g, pg = small_grids()
    nets, pnets = paired_networks()
    return g, pg, nets, pnets


@pytest.mark.parametrize("grid_name", ["small", "paper150",
                                       "extended_sub"])
def test_grid_hash_equals_reference(grid_name):
    g = {"small": lambda: small_grids()[0],
         "paper150": ref_acc.ConfigGrid.product,
         "extended_sub": lambda: ref_acc.extended_grid().take(
             np.arange(0, 5400, 7))}[grid_name]()
    pg = convert.grid_from_fields(g.fields)
    assert store.grid_hash(pg) == ref_store.grid_hash(g)


@pytest.mark.parametrize("names", [("AlexNet", "MobileNet"), ("VGG16",),
                                   None])
def test_networks_hash_equals_reference(names):
    from repro.core import topology as ref_topo
    nets, pnets = paired_networks(names or ref_topo.NETWORKS)
    assert store.networks_hash(pnets) == ref_store.networks_hash(nets)
    assert store.networks_hash(pnets) != store.grid_hash(
        accelerator.ConfigGrid.product())


@pytest.fixture(scope="module")
def streams(space):
    g, pg, nets, pnets = space
    return {"ref": ref_em.stream_layer_topk(g, nets, backend="numpy",
                                            topk=4, bound=0.05,
                                            chunk_size=5),
            "port": em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                         bound=0.05, chunk_size=5)}


def _assert_same_stream(a, b):
    assert (a.networks, a.n_cfg, a.metric, a.bound) == \
        (b.networks, b.n_cfg, b.metric, b.bound)
    for k in store._STREAM_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    for field in ("boundary_idx", "boundary_energy", "boundary_latency"):
        for nm in a.networks:
            np.testing.assert_array_equal(getattr(a, field)[nm],
                                          getattr(b, field)[nm])


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref")])
def test_stream_entries_cross_packages_bit_for_bit(streams, tmp_path,
                                                   writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    arrays, meta = w.stream_payload(streams[writer])
    w.DurableStore(tmp_path).put(KEY2, arrays=arrays, meta=meta)
    st = r.DurableStore(tmp_path)
    got = st.get(KEY2)
    assert got is not None and st.stats["quarantined"] == 0
    back = r.stream_from_payload(*got)
    _assert_same_stream(back, streams[writer])
    assert st.health().keys() == w.DurableStore(tmp_path).health().keys()


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref")])
def test_journals_cross_packages(tmp_path, writer, reader):
    p = tmp_path / "journal.jsonl"
    j = PKGS[writer].Journal(p)
    for rid in range(4):
        j.submit(rid, dict(kind="best_config", metric="edp",
                           network=None, deadline=2.0, deadline_s=None))
    j.done(1)
    j.close()
    with open(p, "a") as f:
        f.write('{"op": "submit", "rid": 9, "ki')      # torn tail
    want = ref_store.Journal.replay(p)
    got = PKGS[reader].Journal.replay(p)
    assert (got.pending, got.next_rid, got.n_done, got.n_torn) == \
        (want.pending, want.next_rid, want.n_done, want.n_torn) == \
        (want.pending, 4, 1, 1)
    assert [r["rid"] for r in got.pending] == [0, 2, 3]


def _put_one(st, key=KEY):
    return st.put(key, arrays={"x": np.arange(6.0).reshape(2, 3)},
                  meta={"answer": [1, 2.5, "s"], "ok": True})


def _truncate(pkg, tmp):
    path = _put_one(pkg.DurableStore(tmp))
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    return KEY


def _flip(pkg, tmp):
    path = _put_one(pkg.DurableStore(tmp))
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    x = np.array(payload["a_x"], copy=True)
    x.reshape(-1)[0] += 1.0
    payload["a_x"] = x
    with open(path, "wb") as f:
        np.savez(f, **payload)
    return KEY


def _schema(pkg, tmp):
    _put_one(pkg.DurableStore(tmp, schema=999))
    return KEY


def _collision(pkg, tmp):
    st = pkg.DurableStore(tmp)
    os.replace(_put_one(st), st._path(KEY2))
    return KEY2


def _torn(pkg, tmp):
    st = pkg.DurableStore(tmp)
    st._path(KEY).write_bytes(b"PK\x03\x04 torn half-write, not a zip")
    return KEY


DAMAGE = dict(truncated=_truncate, checksum=_flip, schema=_schema,
              key_collision=_collision, torn=_torn)


@pytest.mark.parametrize("damage", sorted(DAMAGE))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_damage_quarantines_as_in_reference(tmp_path, damage, writer):
    """The same damage, done to an entry either package wrote, makes both
    readers miss, move the file aside with the same reason and count the
    same."""
    out = {}
    for reader in ("ref", "port"):
        root = tmp_path / reader
        key = DAMAGE[damage](PKGS[writer], root)
        st = PKGS[reader].DurableStore(root)
        first = st.get(key)
        second = st.get(key)
        reasons = [p.read_text() for p in st.quarantine.glob("*.reason")]
        out[reader] = (first, second, dict(st.stats), reasons,
                       st.health()["n_quarantined_files"],
                       st._path(key).exists())
    assert out["port"] == out["ref"]
    assert out["port"][0] is None and out["port"][2]["quarantined"] == 1


def test_scrub_cursor_and_integrity_as_in_reference(streams, tmp_path):
    """Incremental one-entry scrub passes over three entries, one of them
    bit-rotted: the same walk, the same quarantines, in both packages."""
    out = {}
    for pkg in ("ref", "port"):
        mod = PKGS[pkg]
        st = mod.DurableStore(tmp_path / pkg)
        arrays, meta = mod.stream_payload(streams[pkg])
        for i in range(3):
            st.put(("g", i), arrays=arrays, meta=meta)
        victim = sorted(st.entries.glob("*.npz"))[1]
        victim.write_bytes(victim.read_bytes()[:-7])
        cursor, walk = None, []
        for _ in range(4):
            res = st.scrub(lambda k, a, m: "bad" if k == repr(("g", 2))
                           else None, max_entries=1, cursor=cursor)
            cursor = res["cursor"]
            walk.append((res["scanned"], res["bad"], res["bad_keys"]))
        out[pkg] = (walk, dict(st.stats))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref")])
def test_checkpoints_cross_packages(space, tmp_path, writer, reader):
    """A mid-stream checkpoint either package spilled loads in the other,
    and the port finishes a reference checkpoint to its own result."""
    g, pg, nets, pnets = space
    states = []
    if writer == "ref":
        ref_em.stream_layer_topk(g, nets, backend="numpy", topk=4,
                                 bound=0.05, chunk_size=5,
                                 on_chunk=states.append)
    else:
        em.stream_layer_topk(pg, pnets, device="cpu", topk=4, bound=0.05,
                             chunk_size=5, on_chunk=states.append)
    PKGS[writer].DurableStore(tmp_path).save_ckpt(states[1])
    (tmp_path / "ckpt" / "ckpt_deadbeef.npz").write_bytes(b"not an npz")
    st = PKGS[reader].DurableStore(tmp_path)
    loaded = list(st.iter_ckpts())
    assert len(loaded) == 1 and st.stats["quarantined"] == 1
    fs = loaded[0][1]
    assert (fs.input_hash, fs.next_chunk) == (states[1].input_hash, 2)
    if reader == "port":
        full = em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                    bound=0.05, chunk_size=5)
        resumed = em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                       bound=0.05, chunk_size=5,
                                       resume_from=fs)
        for k in ("argmin", "topk_idx", "layer_argmin"):
            np.testing.assert_array_equal(getattr(resumed, k),
                                          getattr(full, k))
    assert st.drop_ckpt(fs.input_hash) and not st.drop_ckpt(fs.input_hash)


def test_answer_meta_round_trip(tmp_path):
    """An answer cached by one package comes back in the other with the
    JSON note's lists in place of tuples."""
    ans = dict(network="AlexNet", frontier=[(9, 4.5e7, 1.9e10)],
               pool=[14, 17])
    store.DurableStore(tmp_path).put(KEY, meta=ans)
    _, meta = ref_store.DurableStore(tmp_path).get(KEY)
    assert meta == json.loads(json.dumps(ans))
    assert store.SCHEMA_VERSION == ref_store.SCHEMA_VERSION
