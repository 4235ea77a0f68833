"""The port's streamed sweep (``stream_networks``), its resumable fold
state and seams, ``dse.stream_grid`` and ``hetero.design_chip_streaming``,
held against the JAX package's numpy stream on the same inputs.

Agreement: minima at rtol 1e-12, atol 0 (the engine's outputs agree at
that tolerance); ``argmin``, ``topk_idx`` and ``boundary_idx`` equal (the
smallest relative gap between two distinct EDPs of a network on these
grids is ~3e-6, and duplicated rows tie exactly in both packages).  The
port against itself — other chunk sizes, a kill and resume at every chunk
boundary, a fold of its own dense ``evaluate_networks`` — bit for bit.
Tests marked ``cuda`` run the same checks on the card
(``python -m pytest -q -m cuda tests/test_torch_stream*.py``) and skip
elsewhere.
"""

import dataclasses
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import energymodel as ref_em
from repro.core import hetero as ref_hetero
from repro.core import topology as ref_topo
from repro_torch.core import convert, dse, energymodel as em, hetero
from repro_torch.kernels.count_terms import ops

NETS = ("AlexNet", "VGG16", "MobileNet", "ResNet50", "DenseNet121",
        "Xception")
RTOL = 1e-12
ROOT = Path(__file__).resolve().parent.parent
GRIDS = {
    "paper150": lambda: ref_acc.ConfigGrid.product(),
    "extended_sub": lambda: ref_acc.extended_grid().take(
        np.arange(0, 5400, 30)),
}
VALUES = ("min_energy", "min_latency", "min_metric", "topk_metric")
INDICES = ("argmin", "topk_idx")
FIELDS = [f.name for f in dataclasses.fields(ref_em.StreamResult)]


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


def _dup(grid):
    """The grid with every row duplicated (row n + i repeats row i)."""
    idx = np.concatenate([np.arange(grid.n), np.arange(grid.n)])
    return grid.take(idx)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def assert_same(a, b):
    """Two streamed results equal bit for bit, field by field."""
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
    """The port's result against the reference's: values at rtol 1e-12,
    atol 0; indices equal."""
    assert port.networks == ref.networks
    assert (port.n_cfg, port.metric, port.bound) == \
        (ref.n_cfg, ref.metric, ref.bound)
    for f in VALUES:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=RTOL, atol=0, err_msg=f)
    for f in INDICES:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    for nm in ref.networks:
        np.testing.assert_array_equal(port.boundary_idx[nm],
                                      ref.boundary_idx[nm], err_msg=nm)
        for f in ("boundary_energy", "boundary_latency"):
            np.testing.assert_allclose(getattr(port, f)[nm],
                                       getattr(ref, f)[nm], rtol=RTOL,
                                       atol=0, err_msg=f"{f}[{nm}]")


def dense_fold(e, t, names, metric, bound, topk):
    """The streamed reductions computed in one piece, in numpy, from
    dense [n, n_net] outputs: what every chunked fold must reproduce."""
    v = ref_em._metric_of(metric, e, t)
    n = v.shape[0]
    idx = np.broadcast_to(np.arange(n)[:, None], v.shape)
    order = np.lexsort((idx, v), axis=0)[:topk]
    min_m = v.min(axis=0)
    b_idx, b_e, b_t = {}, {}, {}
    for j, nm in enumerate(names):
        sel = np.flatnonzero(v[:, j] <= min_m[j] * (1.0 + bound))
        sel = sel[np.argsort(v[sel, j], kind="stable")]
        b_idx[nm], b_e[nm], b_t[nm] = sel, e[sel, j], t[sel, j]
    return ref_em.StreamResult(
        networks=tuple(names), n_cfg=n, metric=metric, bound=bound,
        min_energy=e.min(axis=0), min_latency=t.min(axis=0),
        min_metric=min_m, argmin=v.argmin(axis=0),
        topk_idx=np.take_along_axis(idx, order, axis=0),
        topk_metric=np.take_along_axis(v, order, axis=0),
        boundary_idx=b_idx, boundary_energy=b_e, boundary_latency=b_t)


def _states(run):
    """Run a stream with ``on_chunk`` recording → (result, states)."""
    states = []
    return run(on_chunk=states.append), states


# ---------------------------------------------------------------------------
# The CPU: the port against the reference and against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("kind, bound", [("networks", 0.05),
                                         ("layer_topk", None)])
def test_input_hash_equals_reference(grids, ref_nets, port_nets, grid_name,
                                     kind, bound):
    g, pg = grids[grid_name]
    kw = dict(kind=kind, metric="edp", bound=bound, topk=16, chunk=50)
    assert em.stream_input_hash(pg, port_nets, **kw) == \
        ref_em.stream_input_hash(g, ref_nets, **kw)
    assert em.stream_input_hash(pg.fields, port_nets, **kw) == \
        em.stream_input_hash(pg, port_nets, **kw)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("metric", ["edp", "energy", "latency"])
def test_stream_matches_reference(grids, ref_nets, port_nets, grid_name,
                                  metric):
    g, pg = grids[grid_name]
    ref = ref_em.stream_networks(g, ref_nets, backend="numpy",
                                 chunk_size=50, metric=metric)
    port = em.stream_networks(pg, port_nets, device="cpu", chunk_size=50,
                              metric=metric)
    assert (port.device, port.backend) == ("cpu", "torch")
    assert em.last_backend() == "torch"
    assert_agrees(port, ref)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_chunk_sizes_and_dense_fold_bit_identical(grids, port_nets,
                                                  grid_name):
    _, pg = grids[grid_name]
    runs = [em.stream_networks(pg, port_nets, device="cpu", chunk_size=c,
                               bound=0.05, topk=16) for c in (7, 50, pg.n)]
    for r in runs[1:]:
        assert_same(r, runs[0])
    e, t = em.evaluate_networks(pg, port_nets, device="cpu")
    assert_same(runs[0], dense_fold(e, t, tuple(port_nets), "edp", 0.05, 16))
    wrapped = dse.stream_grid(port_nets, pg, device="cpu", chunk_size=50)
    assert_same(wrapped, runs[1])


@pytest.mark.parametrize("metric", ["edp", "latency"])
def test_ties_from_duplicated_rows(grids, ref_nets, port_nets, metric):
    """Every value has an exact twin: the top-k, argmin and boundary sets
    keep the reference's indices at every chunk size, the LOWER twin
    first."""
    g, pg = grids["paper150"]
    dg, dpg, n = _dup(g), _dup(pg), g.n
    ref = ref_em.stream_networks(dg, ref_nets, backend="numpy", topk=5,
                                 chunk_size=11, metric=metric)
    runs = [em.stream_networks(dpg, port_nets, device="cpu", topk=5,
                               chunk_size=c, metric=metric)
            for c in (5, 11, dpg.n)]
    for r in runs:
        assert_agrees(r, ref)
        assert_same(r, runs[0])
    top = runs[0].topk_idx
    assert (top[0] < n).all() and (runs[0].argmin < n).all()
    tied = runs[0].topk_metric[:-1] == runs[0].topk_metric[1:]
    assert tied.any() and (top[:-1][tied] < top[1:][tied]).all()


def test_resume_at_every_kill_point(grids, port_nets):
    _, pg = grids["paper150"]

    def run(**kw):
        return em.stream_networks(pg, port_nets, device="cpu",
                                  chunk_size=40, **kw)

    full, states = _states(run)
    assert [s.next_chunk for s in states] == [1, 2, 3, 4]
    assert [s.complete for s in states] == [False, False, False, True]
    for s in states:
        assert_same(run(resume_from=s), full)
        assert_same(run(resume_from=s.export_state()), full)


def test_npz_round_trip(grids, port_nets, tmp_path):
    _, pg = grids["extended_sub"]

    def run(**kw):
        return em.stream_networks(pg, port_nets, device="cpu",
                                  chunk_size=50, **kw)

    full, states = _states(run)
    path = tmp_path / "fold.npz"
    states[1].save(path)
    assert not (tmp_path / "fold.npz.tmp").exists()
    loaded = em.StreamFoldState.load(path)
    want = states[1].export_state()
    got = loaded.export_state()
    assert list(got) == list(want)
    for k in want:
        if k == "meta":
            assert got[k] == want[k]
        else:
            _bits(got[k], want[k], k)
    assert_same(run(resume_from=loaded), full)


def test_resume_refuses_other_inputs_and_kinds(grids, port_nets):
    _, pg = grids["paper150"]
    _, states = _states(lambda **kw: em.stream_networks(
        pg, port_nets, device="cpu", chunk_size=40, **kw))
    with pytest.raises(em.StreamStateError, match="different inputs"):
        em.stream_networks(pg, port_nets, device="cpu", chunk_size=40,
                           bound=0.06, resume_from=states[0])
    with pytest.raises(em.StreamStateError, match="different inputs"):
        em.stream_networks(pg, port_nets, device="cpu", chunk_size=50,
                           resume_from=states[0])
    with pytest.raises(em.StreamStateError, match="'networks' fold state"):
        em.stream_layer_topk(pg, port_nets, device="cpu", chunk_size=40,
                             resume_from=states[0])
    payload = states[0].export_state()
    del payload["state_2"]
    with pytest.raises(em.StreamStateError, match="truncated or corrupt"):
        em.stream_networks(pg, port_nets, device="cpu", chunk_size=40,
                           resume_from=payload)


def test_state_crosses_packages(grids, ref_nets, port_nets):
    """A state the port exports mid-stream finishes in the reference's
    numpy stream, and the reverse; both exports carry the same payload."""
    g, pg = grids["extended_sub"]
    ref_full, ref_states = _states(lambda **kw: ref_em.stream_networks(
        g, ref_nets, backend="numpy", chunk_size=50, **kw))
    port_full, port_states = _states(lambda **kw: em.stream_networks(
        pg, port_nets, device="cpu", chunk_size=50, **kw))
    assert len(port_states) == len(ref_states) == 4
    p_exp, r_exp = port_states[1].export_state(), ref_states[1].export_state()
    assert list(p_exp) == list(r_exp)
    assert p_exp["meta"] == r_exp["meta"]
    for k in r_exp:
        if k != "meta":
            assert p_exp[k].dtype == r_exp[k].dtype, k
            if p_exp[k].dtype == np.int64:
                np.testing.assert_array_equal(p_exp[k], r_exp[k], err_msg=k)
            else:
                np.testing.assert_allclose(p_exp[k], r_exp[k], rtol=RTOL,
                                           atol=0, err_msg=k)

    finished_by_ref = ref_em.stream_networks(
        g, ref_nets, backend="numpy", chunk_size=50, resume_from=p_exp)
    assert_agrees(finished_by_ref, ref_full)
    finished_by_port = em.stream_networks(
        pg, port_nets, device="cpu", chunk_size=50, resume_from=r_exp)
    assert_agrees(finished_by_port, ref_full)
    assert_agrees(port_full, ref_full)


def test_chunk_hook_nan_gives_reference_provenance(grids, ref_nets,
                                                   port_nets, monkeypatch):
    """A hook that writes a NaN into chunk 2 raises the reference's
    ``ChunkCorruption`` (chunk, rows, networks) before the fold commits:
    ``on_chunk`` ran for chunks 0 and 1 only."""
    g, pg = grids["paper150"]

    def poison(ci, e, t):
        if ci == 2:
            e = e.copy() if isinstance(e, np.ndarray) else e.clone()
            t = t.copy() if isinstance(t, np.ndarray) else t.clone()
            e[3, 1] = np.nan
            t[5, 4] = np.inf
        return e, t

    got = {}
    for name, mod, run in (
            ("ref", ref_em, lambda **kw: ref_em.stream_networks(
                g, ref_nets, backend="numpy", chunk_size=40, **kw)),
            ("port", em, lambda **kw: em.stream_networks(
                pg, port_nets, device="cpu", chunk_size=40, **kw))):
        monkeypatch.setattr(mod, "_CHUNK_HOOK", poison)
        seen = []
        with pytest.raises(mod.ChunkCorruption) as info:
            run(on_chunk=seen.append)
        err = info.value
        got[name] = (err.chunk, err.start, err.stop, err.networks, len(seen))
    assert got["port"] == got["ref"] == (2, 80, 120, (NETS[1], NETS[4]), 2)
    seen = []
    em.stream_networks(pg, port_nets, device="cpu", chunk_size=40,
                       nan_guard=False, on_chunk=seen.append)
    assert len(seen) == 4


class Recorder:
    """A verifier stub that records the stream's calls into it."""

    def __init__(self):
        self.calls = []
        self.bound = None

    def bind(self, **kw):
        self.bound = kw
        self.calls.append(("bind",))

    def check_resume(self, state, cand):
        self.calls.append(("check_resume", len(state), sorted(cand)))

    def check_chunk(self, ci, start, stop, fc, e, t):
        self.calls.append(("check_chunk", ci, start, stop, tuple(e.shape)))

    def check_fold(self, ci, start, stop, state, new_state, *, es, ts, mask):
        self.calls.append(("check_fold", ci, start, stop, len(state),
                           len(new_state)))


def test_verifier_sees_reference_call_sequence(grids, ref_nets, port_nets):
    """``verify=``'s duck-typed calls come in the reference's order, each
    before the fold commits; its shadow evaluator (the plain torch path on
    the CPU) agrees with the reference's at rtol 1e-12.  The reference
    pads its last chunk, so only full chunks compare shapes."""
    g, pg = grids["extended_sub"]
    ref_full, ref_states = _states(lambda **kw: ref_em.stream_networks(
        g, ref_nets, backend="numpy", chunk_size=50, **kw))
    recs = {}
    for name, run in (
            ("ref", lambda **kw: ref_em.stream_networks(
                g, ref_nets, backend="numpy", chunk_size=50, **kw)),
            ("port", lambda **kw: em.stream_networks(
                pg, port_nets, device="cpu", chunk_size=50, **kw))):
        rec = Recorder()
        run(verify=rec, resume_from=ref_states[0].export_state())
        recs[name] = rec
    r, p = recs["ref"], recs["port"]
    assert [c[:4] for c in p.calls] == [c[:4] for c in r.calls]
    assert [c for c in p.calls if c[0] != "check_chunk"] == \
        [c for c in r.calls if c[0] != "check_chunk"]
    assert p.calls[2][4] == r.calls[2][4] == (50, len(NETS))
    assert p.calls[-2][4] == (30, len(NETS))           # unpadded last chunk
    assert p.bound.keys() == r.bound.keys()
    assert {k: v for k, v in p.bound.items() if k not in ("backend",
                                                          "ref_eval")} == \
        {k: v for k, v in r.bound.items() if k not in ("backend",
                                                       "ref_eval")}
    assert p.bound["backend"] == "torch"
    fc = {k: v[:50] for k, v in g.fields.items()}
    for got, want in zip(p.bound["ref_eval"](fc), r.bound["ref_eval"](fc)):
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, np.asarray(want)[:50], rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("grid_name, max_cores", [
    ("paper150", 1), ("paper150", 2), ("paper150", 4),
    ("extended_sub", 3)])
def test_design_chip_streaming_equals_reference(grids, ref_nets, port_nets,
                                                grid_name, max_cores):
    g, pg = grids[grid_name]
    ref_sr = ref_em.stream_networks(g, ref_nets, backend="numpy",
                                    chunk_size=64, bound=0.05)
    port_sr = dse.stream_grid(port_nets, pg, device="cpu", chunk_size=64,
                              bound=0.05)
    rc = ref_hetero.design_chip_streaming(ref_sr, g, ref_nets,
                                          max_cores=max_cores,
                                          use_jax=False)
    pc = hetero.design_chip_streaming(port_sr, pg, port_nets,
                                      max_cores=max_cores)
    assert pc.core_types == rc.core_types
    assert pc.assignment == rc.assignment
    assert pc.candidate_sets == rc.candidate_sets
    assert [pc.core_label(i, pg) for i in range(len(pc.core_types))] == \
        [rc.core_label(i, g) for i in range(len(rc.core_types))]
    if grid_name == "paper150":
        shape = (len(ref_acc.ARRAY_SIZES), len(ref_acc.GB_SIZES_KB),
                 len(ref_acc.GB_SIZES_KB))
        dense = hetero.design_chip(
            dse.sweep_networks(port_nets, device="cpu"), bound=0.05,
            max_cores=max_cores)
        assert pc.core_cells(shape) == dense.core_types
        assert pc.assignment == dense.assignment
        if max_cores == 1:             # the uncovered branch evaluates
            assert len(pc.assignment) == len(NETS)
            assert any(pc.core_types[0] not in pc.candidate_sets[nm]
                       for nm in NETS)


def test_no_card_and_no_fallback(grids, port_nets):
    _, pg = grids["paper150"]
    with pytest.raises(ValueError, match="backend='cuda'"):
        em.stream_networks(pg, port_nets, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        em.stream_layer_topk(pg, port_nets, device="cpu", backend="cuda")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        em.stream_networks(pg, port_nets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dse.stream_layer_grid(port_nets, pg)


def test_example_runs_on_cpu(capsys, monkeypatch):
    """examples/dse_stream_torch.py end to end on the CPU, every 245th
    mega point."""
    monkeypatch.setattr(sys, "argv", ["dse_stream_torch.py", "--device",
                                      "cpu", "--every", "245"])
    runpy.run_path(str(ROOT / "examples" / "dse_stream_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "engine backend: torch on cpu" in out
    assert "streaming design_chip reproduces the cover: True" in out
    assert "mega grid: 200 points x 18 CNNs streamed per layer" in out


# ---------------------------------------------------------------------------
# The card: the kernels' stream against the plain one, on the same card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["edp", "energy"])
def test_card_cuda_matches_torch(grids, port_nets, cuda_device, metric):
    _, pg = grids["extended_sub"]
    before = ops.launch_counts()["count_terms"]
    kern = em.stream_networks(pg, port_nets, device=cuda_device,
                              chunk_size=50, metric=metric)
    assert ops.launch_counts()["count_terms"] == before + 4
    assert (kern.backend, em.last_backend()) == ("cuda", "cuda")
    plain = em.stream_networks(pg, port_nets, device=cuda_device,
                               backend="torch", chunk_size=50,
                               metric=metric)
    cpu = em.stream_networks(pg, port_nets, device="cpu", chunk_size=50,
                             metric=metric)
    assert_agrees(kern, plain)
    assert_agrees(kern, cpu)


@pytest.mark.cuda
def test_card_chunk_sizes_and_resume(grids, port_nets, cuda_device):
    _, pg = grids["extended_sub"]

    def run(chunk, **kw):
        return em.stream_networks(pg, port_nets, device=cuda_device,
                                  chunk_size=chunk, **kw)

    full, states = _states(lambda **kw: run(50, **kw))
    for c in (7, pg.n):
        assert_same(run(c), full)
    for s in states:
        assert_same(run(50, resume_from=s), full)
        assert_same(run(50, resume_from=s.export_state()), full)
    e, t = em.evaluate_networks(pg, port_nets, device=cuda_device)
    assert_same(full, dense_fold(e, t, tuple(port_nets), "edp", 0.05, 16))


@pytest.mark.cuda
def test_card_first_minimum_on_ties(grids, port_nets, cuda_device):
    _, pg = grids["paper150"]
    dpg, n = _dup(pg), pg.n
    cpu = em.stream_networks(dpg, port_nets, device="cpu", topk=5,
                             chunk_size=11)
    for chunk in (5, 11, dpg.n):
        card = em.stream_networks(dpg, port_nets, device=cuda_device,
                                  topk=5, chunk_size=chunk)
        assert (card.argmin < n).all() and (card.topk_idx[0] < n).all()
        assert_agrees(card, cpu)
