"""The port's DSE service (``repro_torch.serving.dse_service``) against the
JAX package's (``repro.serving.dse_service``, on its numpy engine) on the
same queries: best-config, best-chip, Pareto and reschedule answers equal
(ints exact, floats within 1e-12), the same degraded flags under a fake
clock, the same counters and ``health()`` keys (but the reference's
``jit``) under the same seeded chaos; and, port against port, bit for
bit: kill and restart at every chunk, ``extend_grid`` against a fresh
service, the scrub's quarantine and recompute, ``shard=True`` against
``shard=False`` on one device, and its refusal with several.  The 18-point grid in chunks of 5 (three full
chunks and one of 3); the chaos cases take chunks of 6, so no chunk is
partial: the reference pads its last chunk and the port does not, so a
seeded corruption can land on a padding row there, which only the
reference's guard skips."""

import numpy as np
import pytest
import torch

from repro.ft import faults as ref_faults
from repro.ft import hw_faults as ref_hw
from repro.serving import dse_service as ref_svc
from repro_torch.core import energymodel as em
from repro_torch.ft import faults, hw_faults
from repro_torch.serving import dse_service, store

from torch_service_pairs import (FakeClock, close, paired_networks,
                                 reference_on_numpy, same, small_grids)

NETS = ("AlexNet", "MobileNet")


@pytest.fixture(scope="module")
def space():
    g, pg = small_grids()
    nets, pnets = paired_networks()
    return g, pg, nets, pnets


@pytest.fixture(scope="module", autouse=True)
def numpy_reference():
    with reference_on_numpy():
        yield


def _one(space, pkg, clock=None, **kw):
    """One package's service over the space (on a fake clock if given)."""
    g, pg, nets, pnets = space
    kw.setdefault("chunk_size", 5)
    if clock is not None:
        kw.update(clock=clock, sleep=clock.sleep)
    if pkg == "ref":
        return ref_svc.DSEService(g, nets, backend="numpy", **kw)
    return dse_service.DSEService(pg, pnets, device="cpu", **kw)


def _pair(space, fake_clock=False, **kw):
    """(reference service, port service) over the same space, each on a
    fake clock of its own if asked."""
    return tuple(_one(space, pkg, FakeClock() if fake_clock else None,
                      **kw) for pkg in ("ref", "port"))


MIX = [dict(kind="best_config"), dict(kind="best_config", network="AlexNet"),
       dict(kind="best_chip", deadline=1.5),
       dict(kind="best_chip", deadline=2.0),
       dict(kind="best_chip", deadline=3.0),
       dict(kind="pareto", network="AlexNet", deadline=2.0),
       dict(kind="pareto", network="MobileNet", deadline=1.2)]


def _drain(svc, mix, metric="edp"):
    for q in mix:
        assert svc.submit(metric=metric, **q).accepted
    out, drained = svc.run_until_drained()
    assert drained
    return sorted(out, key=lambda r: r.rid)


def _same_responses(port, ref, exact=False):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p.rid, p.kind, p.ok, p.degraded, p.deadline_missed) == \
            (r.rid, r.kind, r.ok, r.degraded, r.deadline_missed)
        (same if exact else close)(p.answer, r.answer, path=f"rid {p.rid}")


@pytest.mark.parametrize("metric", ["edp", "energy", "latency"])
def test_answers_equal_reference(space, metric):
    ref, port = _pair(space)
    _same_responses(_drain(port, MIX, metric), _drain(ref, MIX, metric))
    assert all(r.ok and not r.degraded for r in port.responses)
    assert port.responses[0].backend == "torch"


def test_reschedule_equals_reference(space):
    """The fault-event path: a single-core loss and a degraded PE array
    on the best chip, coalesced into one union-grid solve."""
    ref, port = _pair(space)
    chips = {}
    for name, svc in (("ref", ref), ("port", port)):
        (r,) = _drain(svc, [dict(kind="best_chip", deadline=2.0)])
        chips[name] = r.answer
    same(chips["port"], chips["ref"])
    ct, cc = chips["port"]["chip_types"], chips["port"]["chip_counts"]
    scen = [hw_faults.all_single_core_failures(cc)[0],
            hw_faults.FaultScenario(
                name="pe_loss", events=(hw_faults.DegradedArray(0, 2, 2),))]
    for name, svc, hw in (("ref", ref, ref_hw), ("port", port, hw_faults)):
        for s in scen:
            assert svc.fault_event(
                ct, cc, hw.scenario_from_json(hw_faults.scenario_to_json(s))
            ).accepted
        svc.run_until_drained()
    _same_responses(sorted(port.responses, key=lambda r: r.rid),
                    sorted(ref.responses, key=lambda r: r.rid))
    assert port.stats["reschedules"] == 2
    assert port.stats["coalesced_batches"] == ref.stats["coalesced_batches"]


def test_degraded_flags_equal_under_fake_clock(space):
    """Projected-cost degradation, a budget abort that leaves its
    checkpoint, and the resume that finishes it: the same flags and
    counters in both packages."""
    ref, port = _pair(space, fake_clock=True, degrade_stride=4,
                      safety_factor=0.1)
    outs = {}
    for name, svc, fmod in (("ref", ref, ref_faults),
                            ("port", port, faults)):
        with fmod.inject_chunk_faults(svc._clock.per_chunk_hook(1.0)):
            outs[name] = (
                _drain(svc, [dict(kind="best_config", deadline_s=3.0)])
                + _drain(svc, [dict(kind="best_config", deadline_s=0.0)])
                + _drain(svc, [dict(kind="best_config")])
                + _drain(svc, [dict(kind="best_chip", deadline_s=0.0)])
                + _drain(svc, [dict(kind="best_chip", deadline_s=50.0)]))
    _same_responses(outs["port"], outs["ref"])
    assert [r.degraded for r in outs["port"]] == [True, True, False, True,
                                                  False]
    assert port.stats["budget_aborts"] == 1 and port.stats["resumes"] >= 1
    h_ref, h_port = ref.health(), port.health()
    assert h_port.keys() == h_ref.keys() - {"jit"}
    assert {k: v for k, v in h_port.items() if k != "last_backend"} == \
        {k: v for k, v in h_ref.items()
         if k not in ("jit", "last_backend")}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_counters_equal_reference(space, seed, tmp_path):
    """The same seeded chaos plan (failures, NaN/inf, finite
    perturbations) with every chunk shadow-checked, a durable store and
    a fake clock: the same answers, the same counters, the same health
    keys; and the port's answers bit-identical to its clean run."""
    ref, port = (_one(space, pkg, FakeClock(), chunk_size=6,
                      verify_fraction=1.0, state_dir=tmp_path / pkg)
                 for pkg in ("ref", "port"))
    outs = {}
    for name, svc, fmod in (("ref", ref, ref_faults),
                            ("port", port, faults)):
        plan = fmod.FaultPlan.random(seed, 3, p_perturb=0.25)
        with fmod.inject_chunk_faults(plan):
            outs[name] = _drain(svc, MIX)
        outs[name + "_fired"] = plan.fired
    assert outs["port_fired"] == outs["ref_fired"]
    _same_responses(outs["port"], outs["ref"])
    assert all(r.ok and not r.degraded for r in outs["port"])
    h_ref, h_port = ref.health(), port.health()
    assert h_port.keys() == h_ref.keys() - {"jit"}
    for k in h_port:
        if k not in ("last_backend", "state_dir", "uptime_s"):
            assert h_port[k] == h_ref[k], k
    assert h_port["backend_fallbacks"] == 0
    n_perturb = sum(kind == "perturb" for _, kind in outs["port_fired"])
    assert h_port["shadow_mismatches"] == n_perturb
    clean = _one(space, "port", chunk_size=6, verify_fraction=1.0)
    _same_responses(outs["port"], _drain(clean, MIX), exact=True)


def test_exhausted_retries_answer_not_ok(space):
    """A chunk that fails on every attempt: the reference's ladder with
    its numpy backend has nowhere to go, and the port has no ladder; both
    answer ``ok=False`` with the same counters, and the port never
    answers from another backend."""
    outs, stats = {}, {}
    for name, fmod in (("ref", ref_faults), ("port", faults)):
        svc = _one(space, name, FakeClock(), max_retries=2)
        with fmod.inject_chunk_faults(fmod.FaultPlan(fail_at={0: 99})):
            outs[name] = _drain(svc, [dict(kind="best_config")])
        stats[name] = svc.stats
    _same_responses(outs["port"], outs["ref"])
    assert not outs["port"][0].ok and "backend 'torch'" in \
        outs["port"][0].error
    assert stats["port"] == stats["ref"]
    assert stats["port"]["backend_fallbacks"] == 0


def _mix(seed, n=6):
    rng = np.random.default_rng(seed)
    kinds = ("best_config", "best_chip", "pareto")
    out = []
    for _ in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        out.append(dict(
            kind=kind, metric=("edp", "energy")[int(rng.integers(2))],
            network=(None if kind == "best_config"
                     else NETS[int(rng.integers(len(NETS)))]),
            deadline=float(rng.choice([1.5, 2.0, 3.0]))))
    return out


def _port(space, state_dir, **kw):
    return _one(space, "port", ckpt_every=1, state_dir=state_dir, **kw)


@pytest.mark.parametrize("kill", range(4))
def test_kill_restart_parity_every_chunk(space, tmp_path, kill):
    """A ``ProcessKill`` at chunk ``kill`` passes every ``try`` of the
    service; a fresh service over the same directory replays the
    unanswered requests, resumes the spilled checkpoint, and drains to
    answers bit-identical to the clean run; exactly once; a second
    restart replays nothing.  The reference replays the same count."""
    mix = _mix(kill)
    clean = _port(space, tmp_path / "clean")
    for q in mix:
        clean.submit(**q)
    clean_out, _ = clean.run_until_drained()
    clean.close()
    by_rid = {r.rid: r for r in clean_out}
    replayed = {}
    for name, fmod in (("ref", ref_faults), ("port", faults)):
        sd = tmp_path / name
        def mk(name=name, sd=sd):
            return _one(space, name, ckpt_every=1, state_dir=sd)
        s1 = mk()
        for q in mix:
            s1.submit(**q)
        with fmod.inject_chunk_faults(fmod.FaultPlan(pkill_at=kill)) as plan:
            with pytest.raises(fmod.ProcessKill):
                s1.run_until_drained()
        assert (kill, "pkill") in plan.fired
        killed = list(s1.responses)
        s2 = mk()
        replayed[name] = (s2.stats["replayed"], len(killed))
        restart, drained = s2.run_until_drained()
        s2.close()
        assert drained
        if name == "port":
            rids = [r.rid for r in killed + restart]
            assert len(rids) == len(set(rids)) == len(mix)
            for r in killed + restart:
                want = by_rid[r.rid]
                assert (r.kind, r.ok, r.degraded) == \
                    (want.kind, want.ok, want.degraded)
                same(r.answer, want.answer, path=f"kill {kill} rid {r.rid}")
            s3 = mk()
            assert s3.stats["replayed"] == 0 and s3.stats["ckpt_gc"] == 0
            s3.close()
    assert replayed["port"] == replayed["ref"]
    assert replayed["port"][0] == len(mix) - replayed["port"][1] > 0


def test_warm_restart_answers_from_the_store(space, tmp_path):
    mix = _mix(1)
    s1 = _port(space, tmp_path)
    for q in mix:
        s1.submit(**q)
    first, _ = s1.run_until_drained()
    s1.close()
    s2 = _port(space, tmp_path)
    for q in mix:
        s2.submit(**q)
    warm, _ = s2.run_until_drained()
    h = s2.health()
    s2.close()
    assert h["answer_hits"] == len(mix) and h["sweep_cache_misses"] == 0
    for r, want in zip(sorted(warm, key=lambda r: r.rid),
                       sorted(first, key=lambda r: r.rid)):
        same(r.answer, want.answer)


def test_extend_grid_equals_fresh_service(space, tmp_path):
    """Delta-folding the appended rows into the warm streams answers bit
    for bit like a fresh service over the grown grid."""
    _, pg, _, pnets = space
    base = pg.take(np.arange(13))
    rows = pg.take(np.arange(13, pg.n))
    warm = dse_service.DSEService(base, pnets, device="cpu", chunk_size=5,
                                  degrade_stride=4,
                                  state_dir=tmp_path / "warm")
    _drain(warm, MIX)
    res = warm.extend_grid(rows)
    assert res["added"] == 5 and res["n_cfg"] == pg.n
    assert res["delta_folds"] == 2 and res["invalidated"] > 0
    fresh = dse_service.DSEService(pg, pnets, device="cpu", chunk_size=5,
                                   degrade_stride=4)
    for metric in ("edp", "energy"):
        for tier in ("exact", "sub"):
            if (tier, metric) in warm._streams:
                a = warm._streams[(tier, metric)]
                b = fresh._get_stream(metric, exact=tier == "exact")
                for k in store._STREAM_ARRAYS:
                    np.testing.assert_array_equal(getattr(a, k),
                                                  getattr(b, k))
    w_out, f_out = _drain(warm, MIX), _drain(fresh, MIX)
    for w, f in zip(w_out, f_out):
        same(w.answer, f.answer)


def test_scrub_quarantines_and_recomputes(space, tmp_path):
    """A clean store scrubs clean; a stream payload poisoned
    self-consistently is quarantined with a reason, evicted and
    recomputed, and later answers are the clean ones.  Every top-k cell
    is re-derived (``scrub_rows`` covers them all), as the reference's
    scrub test does."""
    svc = _port(space, tmp_path, scrub_rows=999)
    first = _drain(svc, MIX)
    res = svc.scrub()
    assert res["scanned"] >= 2 and res["bad"] == 0
    key = svc._stream_key("exact", "edp")
    arrays, meta = svc.store.get(key)
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    k, j = 1, 0
    li = int(np.nonzero(a["layer_energy"][k, j])[0][0])
    a["layer_energy"][k, j, li] *= 1.001
    a["topk_metric"][k, j] = a["layer_energy"][k, j].sum() * \
        a["layer_latency"][k, j].sum()
    svc.store.put(key, arrays=a, meta=meta)
    res = svc.scrub()
    assert res["bad"] == 1 and res["recomputed"] == 1
    assert res["bad_keys"] == [repr(key)]
    reasons = [p.read_text() for p in svc.store.quarantine.glob("*.reason")]
    assert len(reasons) == 1 and "diverges from the plain-path" in \
        reasons[0]
    assert svc.stats["scrubbed_bad"] == 1
    assert svc.stats["scrub_recomputed"] == 1
    again = svc.store.get(key)
    for name in store._STREAM_ARRAYS:
        np.testing.assert_array_equal(again[0][name], arrays[name])
    svc._streams.clear()
    svc._points.clear()
    for r, want in zip(_drain(svc, MIX), first):
        same(r.answer, want.answer)
    svc.close()


def test_idle_steps_scrub_one_entry_each(space, tmp_path):
    svc = _port(space, tmp_path)
    _drain(svc, MIX[:1])
    n = svc.store.health()["n_entries"]
    for _ in range(n):
        assert svc.step() == []
    assert svc.stats["scrub_entries"] == n
    svc.close()


SHARD_CALLS = {
    "evaluate_networks": lambda pg, nets, **kw: em.evaluate_networks(
        pg, nets, device="cpu", **kw),
    "evaluate_per_layer": lambda pg, nets, **kw: em.evaluate_networks(
        pg, nets, device="cpu", per_layer=True, chunk_size=7, **kw),
    "stream_networks": lambda pg, nets, **kw: em.stream_networks(
        pg, nets, device="cpu", chunk_size=5, bound=0.05, **kw),
    "stream_layer_topk": lambda pg, nets, **kw: em.stream_layer_topk(
        pg, nets, device="cpu", chunk_size=5, bound=0.05, **kw),
}


def _bits(x):
    """Every array and scalar of a result, in a fixed order."""
    if isinstance(x, dict):
        return [b for k in sorted(x) for b in _bits(x[k])]
    if isinstance(x, (list, tuple)):
        return [b for v in x for b in _bits(v)]
    if hasattr(x, "__dataclass_fields__"):
        return _bits({k: getattr(x, k) for k in x.__dataclass_fields__})
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)] if isinstance(x, (np.ndarray, float, int)) \
        else [repr(x)]


@pytest.mark.parametrize("call", sorted(SHARD_CALLS))
def test_shard_true_equals_false(space, call, monkeypatch):
    """With one device ``shard=True`` is the unsharded evaluation, bit for
    bit; with several visible each entry point refuses it rather than
    run on one."""
    _, pg, _, pnets = space
    a = _bits(SHARD_CALLS[call](pg, pnets, shard=False))
    b = _bits(SHARD_CALLS[call](pg, pnets, shard=True))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    monkeypatch.setattr(em, "visible_devices", lambda dev: 2)
    with pytest.raises(NotImplementedError, match="shard=True over 2"):
        SHARD_CALLS[call](pg, pnets, shard=True)
    assert len(_bits(SHARD_CALLS[call](pg, pnets, shard=False))) == len(a)


@pytest.mark.parametrize("kind,cards,shard,raises", [
    ("cpu", 4, True, False), ("cuda", 1, True, False),
    ("cuda", 2, True, True), ("cuda", 2, False, False)])
def test_check_shard(monkeypatch, kind, cards, shard, raises):
    """The guard counts the visible cards of a CUDA device and one CPU,
    and refuses only ``shard=True`` over more than one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    dev = torch.device(kind)
    assert em.visible_devices(dev) == (cards if kind == "cuda" else 1)
    if raises:
        with pytest.raises(NotImplementedError):
            em.check_shard(shard, dev)
    else:
        em.check_shard(shard, dev)
