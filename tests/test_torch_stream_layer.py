"""The port's streamed per-layer sweep (``stream_layer_topk``),
``merge_layer_topk`` and ``dse.stream_layer_grid``, held against the JAX
package's numpy stream on the same inputs.

Agreement: minima at rtol 1e-12, atol 0; ``argmin``, ``topk_idx``,
``layer_argmin`` and ``boundary_idx`` equal; the top-k rows'
``layer_energy`` / ``layer_latency`` bit-equal (the per-layer outputs are
bit-equal to the reference's; only the sum over layers rounds in another
order).  The port against itself — other chunk sizes, a kill and resume
at every chunk boundary, a fold of its own dense per-layer
``evaluate_networks``, a merge of two halves — bit for bit.  Tests marked
``cuda`` run on the card and skip elsewhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import energymodel as ref_em
from repro.core import topology as ref_topo
from repro_torch.core import convert, dse, energymodel as em
from repro_torch.kernels.count_terms import ops

NETS = ("AlexNet", "VGG16", "MobileNet", "ResNet50", "DenseNet121",
        "Xception")
RTOL = 1e-12
GRIDS = {
    "paper150": lambda: ref_acc.ConfigGrid.product(),
    "extended_sub": lambda: ref_acc.extended_grid().take(
        np.arange(0, 5400, 30)),
}
VALUES = ("min_energy", "min_latency", "min_edp", "min_metric",
          "topk_metric", "layer_min_metric")
INDICES = ("argmin", "topk_idx", "layer_argmin", "layer_counts")
BITS = ("layer_energy", "layer_latency")
FIELDS = [f.name for f in dataclasses.fields(ref_em.LayerTopK)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the count-terms kernels are built "
                    "with nvcc and run only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ref_nets():
    return {n: ref_topo.get_network(n) for n in NETS}


@pytest.fixture(scope="module")
def port_nets(ref_nets):
    return convert.networks_from_dicts(
        {n: [dataclasses.asdict(l) for l in v] for n, v in ref_nets.items()})


@pytest.fixture(scope="module")
def grids():
    """{name: (reference grid, port grid)} over the same columns."""
    out = {}
    for name, make in GRIDS.items():
        g = make()
        out[name] = (g, convert.grid_from_fields(g.fields))
    return out


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def assert_same(a, b):
    """Two per-layer streamed results equal bit for bit, field by field."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, dict):
            assert list(x) == list(y), f
            for nm in x:
                _bits(x[nm], y[nm], f"{f}[{nm}]")
        elif isinstance(x, np.ndarray):
            _bits(x, y, f)
        else:
            assert x == y, f


def assert_agrees(port, ref):
    """The port's result against the reference's (the module docstring's
    tolerances)."""
    assert port.networks == ref.networks
    assert (port.n_cfg, port.metric, port.bound) == \
        (ref.n_cfg, ref.metric, ref.bound)
    for f in VALUES:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=RTOL, atol=0, err_msg=f)
    for f in INDICES:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    for f in BITS:
        _bits(getattr(port, f), getattr(ref, f), f)
    if ref.bound is None:
        assert port.boundary_idx is None and port.boundary_energy is None
        return
    for nm in ref.networks:
        np.testing.assert_array_equal(port.boundary_idx[nm],
                                      ref.boundary_idx[nm], err_msg=nm)
        for f in ("boundary_energy", "boundary_latency"):
            np.testing.assert_allclose(getattr(port, f)[nm],
                                       getattr(ref, f)[nm], rtol=RTOL,
                                       atol=0, err_msg=f"{f}[{nm}]")


def dense_fold(e, t, networks, metric, bound, topk, device="cpu"):
    """The streamed per-layer reductions computed in one piece from dense
    [n, n_net, n_layer] outputs (the layer sums in torch on ``device``, as
    the stream sums them; the rest in numpy)."""
    es, ts = (torch.as_tensor(a, device=device).sum(dim=-1).cpu().numpy()
              for a in (e, t))
    v = ref_em._metric_of(metric, es, ts)
    n = v.shape[0]
    idx = np.broadcast_to(np.arange(n)[:, None], v.shape)
    order = np.lexsort((idx, v), axis=0)[:topk]
    counts = em.network_layer_counts(networks)
    valid = np.arange(e.shape[2])[None, :] < counts[:, None]
    vl = np.where(valid[None], ref_em._metric_of(metric, e, t), np.inf)
    min_m = v.min(axis=0)
    b_idx = b_e = b_t = None
    if bound is not None:
        b_idx, b_e, b_t = {}, {}, {}
        for j, nm in enumerate(networks):
            sel = np.flatnonzero(v[:, j] <= min_m[j] * (1.0 + bound))
            sel = sel[np.lexsort((sel, v[sel, j]))]
            b_idx[nm], b_e[nm], b_t[nm] = sel, es[sel, j], ts[sel, j]
    return ref_em.LayerTopK(
        networks=tuple(networks), n_cfg=n, metric=metric,
        layer_counts=counts,
        topk_idx=np.take_along_axis(idx, order, axis=0),
        topk_metric=np.take_along_axis(v, order, axis=0),
        layer_energy=np.take_along_axis(e, order[:, :, None], axis=0),
        layer_latency=np.take_along_axis(t, order[:, :, None], axis=0),
        min_energy=es.min(axis=0), min_latency=ts.min(axis=0),
        min_edp=(es * ts).min(axis=0), min_metric=min_m,
        argmin=v.argmin(axis=0), layer_min_metric=vl.min(axis=0),
        layer_argmin=np.where(np.isfinite(vl.min(axis=0)),
                              vl.argmin(axis=0), -1),
        bound=bound, boundary_idx=b_idx, boundary_energy=b_e,
        boundary_latency=b_t)


def _states(run):
    states = []
    return run(on_chunk=states.append), states


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("metric", ["edp", "energy", "latency"])
def test_layer_stream_matches_reference(grids, ref_nets, port_nets,
                                        grid_name, metric):
    g, pg = grids[grid_name]
    ref = ref_em.stream_layer_topk(g, ref_nets, backend="numpy",
                                   chunk_size=50, metric=metric, bound=0.05)
    port = em.stream_layer_topk(pg, port_nets, device="cpu", chunk_size=50,
                                metric=metric, bound=0.05)
    assert em.last_backend() == "torch"
    assert_agrees(port, ref)


@pytest.mark.parametrize("grid_name, bound", [("paper150", 0.05),
                                              ("extended_sub", 0.05),
                                              ("extended_sub", None)])
def test_layer_chunk_sizes_and_dense_fold_bit_identical(grids, port_nets,
                                                        grid_name, bound):
    _, pg = grids[grid_name]
    runs = [em.stream_layer_topk(pg, port_nets, device="cpu", chunk_size=c,
                                 bound=bound) for c in (7, 50, pg.n)]
    for r in runs[1:]:
        assert_same(r, runs[0])
    e, t = em.evaluate_networks(pg, port_nets, device="cpu", per_layer=True)
    assert_same(runs[0], dense_fold(e, t, port_nets, "edp", bound, 8))
    wrapped = dse.stream_layer_grid(port_nets, pg, device="cpu",
                                    chunk_size=50, bound=bound)
    assert_same(wrapped, runs[1])


def test_layer_ties_from_duplicated_rows(grids, ref_nets, port_nets):
    """Every value has an exact twin: the top-k (with its layer rows),
    argmin and boundary sets keep the reference's indices at every chunk
    size, the LOWER twin first."""
    g, pg = grids["paper150"]
    idx = np.concatenate([np.arange(g.n), np.arange(g.n)])
    dg, dpg, n = g.take(idx), pg.take(idx), g.n
    ref = ref_em.stream_layer_topk(dg, ref_nets, backend="numpy", topk=6,
                                   chunk_size=7, bound=0.05)
    runs = [em.stream_layer_topk(dpg, port_nets, device="cpu", topk=6,
                                 chunk_size=c, bound=0.05)
            for c in (3, 7, 16, dpg.n)]
    for r in runs:
        assert_agrees(r, ref)
        assert_same(r, runs[0])
    top = runs[0].topk_idx
    assert (top[0] < n).all() and (runs[0].argmin < n).all()
    assert (runs[0].layer_argmin < n).all()
    tied = runs[0].topk_metric[:-1] == runs[0].topk_metric[1:]
    assert tied.any() and (top[:-1][tied] < top[1:][tied]).all()


@pytest.mark.parametrize("bound", [0.05, None])
def test_layer_resume_at_every_kill_point(grids, port_nets, bound):
    _, pg = grids["paper150"]

    def run(**kw):
        return em.stream_layer_topk(pg, port_nets, device="cpu",
                                    chunk_size=40, bound=bound, **kw)

    full, states = _states(run)
    assert [s.next_chunk for s in states] == [1, 2, 3, 4]
    for s in states:
        assert s.kind == "layer_topk" and len(s.state) == 11
        assert_same(run(resume_from=s), full)
        assert_same(run(resume_from=em.StreamFoldState.from_export(
            s.export_state())), full)


def test_layer_state_crosses_packages(grids, ref_nets, port_nets, tmp_path):
    g, pg = grids["extended_sub"]
    ref_full, ref_states = _states(lambda **kw: ref_em.stream_layer_topk(
        g, ref_nets, backend="numpy", chunk_size=50, bound=0.05, **kw))
    _, port_states = _states(lambda **kw: em.stream_layer_topk(
        pg, port_nets, device="cpu", chunk_size=50, bound=0.05, **kw))
    p_exp, r_exp = port_states[2].export_state(), ref_states[2].export_state()
    assert list(p_exp) == list(r_exp) and p_exp["meta"] == r_exp["meta"]
    for k in r_exp:
        if k != "meta":
            assert p_exp[k].dtype == r_exp[k].dtype, k
            assert p_exp[k].shape == r_exp[k].shape, k

    port_states[2].save(tmp_path / "port.npz")
    finished_by_ref = ref_em.stream_layer_topk(
        g, ref_nets, backend="numpy", chunk_size=50, bound=0.05,
        resume_from=ref_em.StreamFoldState.load(tmp_path / "port.npz"))
    assert_agrees(finished_by_ref, ref_full)
    ref_states[2].save(tmp_path / "ref.npz")
    finished_by_port = em.stream_layer_topk(
        pg, port_nets, device="cpu", chunk_size=50, bound=0.05,
        resume_from=em.StreamFoldState.load(tmp_path / "ref.npz"))
    assert_agrees(finished_by_port, ref_full)


def test_layer_chunk_hook_nan_gives_reference_provenance(
        grids, ref_nets, port_nets, monkeypatch):
    """The guard reads the layer sums: a NaN in one layer of chunk 1
    raises the reference's provenance before that chunk is folded."""
    g, pg = grids["paper150"]

    def poison(ci, e, t):
        if ci == 1:
            e = e.copy() if isinstance(e, np.ndarray) else e.clone()
            e[7, 2, 3] = np.nan
        return e, t

    got = {}
    for name, mod, run in (
            ("ref", ref_em, lambda **kw: ref_em.stream_layer_topk(
                g, ref_nets, backend="numpy", chunk_size=40, **kw)),
            ("port", em, lambda **kw: em.stream_layer_topk(
                pg, port_nets, device="cpu", chunk_size=40, **kw))):
        monkeypatch.setattr(mod, "_CHUNK_HOOK", poison)
        seen = []
        with pytest.raises(mod.ChunkCorruption) as info:
            run(on_chunk=seen.append)
        err = info.value
        got[name] = (err.chunk, err.start, err.stop, err.networks, len(seen))
    assert got["port"] == got["ref"] == (1, 40, 80, (NETS[2],), 1)


def test_layer_verifier_sees_reference_call_sequence(grids, ref_nets,
                                                     port_nets):
    g, pg = grids["paper150"]
    calls = {}
    for name, run in (
            ("ref", lambda v: ref_em.stream_layer_topk(
                g, ref_nets, backend="numpy", chunk_size=40, bound=0.05,
                verify=v)),
            ("port", lambda v: em.stream_layer_topk(
                pg, port_nets, device="cpu", chunk_size=40, bound=0.05,
                verify=v))):
        seq = []

        class Rec:
            def bind(self, **kw):
                seq.append(("bind", kw["kind"], kw["topk"], kw["bound"]))
                self.ref_eval = kw["ref_eval"]

            def check_chunk(self, ci, start, stop, fc, e, t):
                seq.append(("check_chunk", ci, start, stop))

            def check_fold(self, ci, start, stop, state, new, *, es, ts,
                           mask):
                seq.append(("check_fold", ci, start, stop, len(new)))

        rec = Rec()
        run(rec)
        calls[name] = (seq, rec.ref_eval)
    assert calls["port"][0] == calls["ref"][0]
    fc = {k: v[:40] for k, v in g.fields.items()}
    for got, want in zip(calls["port"][1](fc), calls["ref"][1](fc)):
        _bits(got, np.asarray(want)[:40])


@pytest.mark.parametrize("bound", [0.05, None])
def test_merge_of_two_halves_bit_identical(grids, port_nets, bound):
    _, pg = grids["extended_sub"]
    whole = em.stream_layer_topk(pg, port_nets, device="cpu", chunk_size=50,
                                 bound=bound)
    cut = 77
    a = em.stream_layer_topk(pg.take(np.arange(cut)), port_nets,
                             device="cpu", chunk_size=50, bound=bound)
    b = em.stream_layer_topk(pg.take(np.arange(cut, pg.n)), port_nets,
                             device="cpu", chunk_size=50, bound=bound)
    assert_same(em.merge_layer_topk(a, b), whole)


def test_merge_of_reference_results_equals_reference_merge(grids,
                                                           ref_nets):
    g, _ = grids["extended_sub"]
    halves = [ref_em.stream_layer_topk(g.take(rows), ref_nets,
                                       backend="numpy", chunk_size=64,
                                       bound=0.05)
              for rows in (np.arange(90), np.arange(90, g.n))]
    assert_same(em.merge_layer_topk(*halves),
                ref_em.merge_layer_topk(*halves))


def test_merge_refuses_mismatched_streams(grids, port_nets):
    _, pg = grids["paper150"]
    a = em.stream_layer_topk(pg, port_nets, device="cpu", bound=0.05)
    with pytest.raises(ValueError, match="network sets"):
        em.merge_layer_topk(a, em.stream_layer_topk(
            pg, dict(list(port_nets.items())[:2]), device="cpu",
            bound=0.05))
    with pytest.raises(ValueError, match="reduction parameters"):
        em.merge_layer_topk(a, dataclasses.replace(a, metric="energy"))
    with pytest.raises(ValueError, match="top-k sizes"):
        em.merge_layer_topk(a, em.stream_layer_topk(
            pg, port_nets, device="cpu", bound=0.05, topk=4))
    with pytest.raises(ValueError, match="no boundary sets"):
        dataclasses.replace(a, boundary_energy=None).boundary_metric(NETS[0])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [0.05, None])
def test_card_layer_cuda_matches_torch(grids, port_nets, cuda_device,
                                       bound):
    _, pg = grids["extended_sub"]
    before = ops.launch_counts()["count_layers"]
    kern = em.stream_layer_topk(pg, port_nets, device=cuda_device,
                                chunk_size=50, bound=bound)
    assert ops.launch_counts()["count_layers"] == before + 4
    assert em.last_backend() == "cuda"
    plain = em.stream_layer_topk(pg, port_nets, device=cuda_device,
                                 backend="torch", chunk_size=50, bound=bound)
    cpu = em.stream_layer_topk(pg, port_nets, device="cpu", chunk_size=50,
                               bound=bound)
    for other in (plain, cpu):
        assert_agrees(kern, other)


@pytest.mark.cuda
def test_card_layer_chunk_sizes_resume_and_dense_fold(grids, port_nets,
                                                      cuda_device):
    _, pg = grids["extended_sub"]

    def run(chunk, **kw):
        return em.stream_layer_topk(pg, port_nets, device=cuda_device,
                                    chunk_size=chunk, bound=0.05, **kw)

    full, states = _states(lambda **kw: run(50, **kw))
    for c in (7, pg.n):
        assert_same(run(c), full)
    for s in states:
        assert_same(run(50, resume_from=s), full)
    e, t = em.evaluate_networks(pg, port_nets, device=cuda_device,
                                per_layer=True)
    assert_same(full, dense_fold(e, t, port_nets, "edp", 0.05, 8,
                                 device=cuda_device))


@pytest.mark.cuda
def test_card_layer_first_minimum_on_ties(grids, port_nets, cuda_device):
    _, pg = grids["paper150"]
    idx = np.concatenate([np.arange(pg.n), np.arange(pg.n)])
    dpg, n = pg.take(idx), pg.n
    cpu = em.stream_layer_topk(dpg, port_nets, device="cpu", topk=6,
                               chunk_size=7, bound=0.05)
    for chunk in (3, 7, dpg.n):
        card = em.stream_layer_topk(dpg, port_nets, device=cuda_device,
                                    topk=6, chunk_size=chunk, bound=0.05)
        assert (card.argmin < n).all() and (card.layer_argmin < n).all()
        assert_agrees(card, cpu)
