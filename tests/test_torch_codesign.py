"""The port's per-layer chip + schedule co-design (``hetero.co_design``,
``co_design_streaming``, ``codesign_problems*``, ``score_codesign``),
held against the JAX package's numpy engine (``backend="numpy",
use_jax=False``) on the paper's 150-point grid × four CNNs.

Agreement: the pool, every candidate chip, the winning chip and every
schedule's ``layer_type`` and ``layer_core`` equal; every score, energy,
latency, load and per-layer tensor at rtol 1e-12 (the per-layer tensors
agree to the last bits, but a dense and a streamed EDP minimum may
differ by an ulp: the dense path takes ``(e·t).min``, the stream its
running minimum).  Shapes equal.  Tests marked ``cuda`` run on the card
and skip elsewhere.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import hetero as ref_het
from repro.core import topology as ref_topo
from repro_torch.core import convert, energymodel as em, hetero, partition

NETS = ("AlexNet", "VGG16", "MobileNet", "GoogleNet")
KW = dict(m_cores=4, max_types=3, pool_size=5)
RTOL = 1e-12
REF = dict(backend="numpy", use_jax=False)
SCHEDULE_EQUAL = ("types", "layer_type", "layer_core", "n_layers")
SCHEDULE_CLOSE = ("loads", "bottleneck", "speedup")


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
    """(reference grid, port grid) of the paper's 150 points."""
    g = ref_acc.ConfigGrid.product()
    return g, convert.grid_from_fields(g.fields)


@pytest.fixture(scope="module")
def small_grids():
    """(reference, port) of the reference's small metric-variant grid."""
    g = ref_acc.ConfigGrid.product(
        arrays=((16, 16), (32, 32), (64, 64)), gb_psum_kb=(13, 54, 216),
        gb_ifmap_kb=(27, 108))
    return g, convert.grid_from_fields(g.fields)


@pytest.fixture(scope="module")
def dense(grids, ref_nets, port_nets):
    """(reference, port) dense co-design on the CPU."""
    return (ref_het.co_design(grids[0], ref_nets, **KW, **REF),
            hetero.co_design(grids[1], port_nets, **KW, device="cpu"))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)


def assert_codesign_equal(got, want):
    """Structure equal, floats at rtol 1e-12."""
    for f in ("core_types", "core_counts", "pool", "chip_types",
              "chip_counts", "metric", "m_cores"):
        assert getattr(got, f) == getattr(want, f), f
    assert list(got.schedules) == list(want.schedules)
    assert got.chip_scores.shape == want.chip_scores.shape
    _close(got.chip_scores, want.chip_scores, "chip_scores")
    _close(got.score, want.score, "score")
    _close(got.homogeneous_score, want.homogeneous_score, "homogeneous")
    for nm, s in got.schedules.items():
        w = want.schedules[nm]
        for f in SCHEDULE_EQUAL:
            assert getattr(s, f) == getattr(w, f), (nm, f)
        for f in SCHEDULE_CLOSE:
            _close(getattr(s, f), getattr(w, f), f"{nm} {f}")
        _close(got.energy[nm], want.energy[nm], f"{nm} energy")
        _close(got.latency[nm], want.latency[nm], f"{nm} latency")


def test_codesign_problems_equal_reference(grids, ref_nets, port_nets):
    want = ref_het.codesign_problems(grids[0], ref_nets, **KW, **REF)
    got = hetero.codesign_problems(grids[1], port_nets, **KW, device="cpu")
    assert (got.names, got.pool, got.chips) == \
        (want.names, want.pool, want.chips)
    assert len(got.chips) == 65 and got.n_problems == 260
    for f in ("lat_dense", "counts", "n_layers_b", "e_layer", "t_layer",
              "lens"):
        assert getattr(got, f).shape == getattr(want, f).shape, f
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.n_layers_b, want.n_layers_b)
    np.testing.assert_array_equal(got.lens, want.lens)
    for f in ("lat_dense", "e_layer", "t_layer", "min_energy",
              "min_latency", "min_edp"):
        _close(getattr(got, f), getattr(want, f), f)
    for i in (0, got.n_problems - 1):
        np.testing.assert_array_equal(
            got.lats[i], got.lat_dense[i, :, :got.n_layers_b[i]])


@pytest.mark.parametrize("variant", ["dense", "stream_chunk7",
                                     "stream_chunk50"])
def test_co_design_equals_reference(variant, dense, grids, ref_nets,
                                    port_nets):
    if variant == "dense":
        want, got = dense
    else:
        chunk = int(variant.removeprefix("stream_chunk"))
        want = ref_het.co_design_streaming(grids[0], ref_nets, **KW, **REF,
                                           chunk_size=chunk)
        got = hetero.co_design_streaming(grids[1], port_nets, **KW,
                                         device="cpu", chunk_size=chunk)
    assert got.n_chips == 65
    assert_codesign_equal(got, want)


def test_streamed_equals_dense_in_port(dense, grids, port_nets):
    got = hetero.co_design_streaming(grids[1], port_nets, **KW,
                                     device="cpu", chunk_size=50)
    assert_codesign_equal(got, dense[1])


def test_schedules_equal_oracle(dense, grids, port_nets):
    """Every winning schedule is the scalar oracle's on the port's own
    per-layer tensors of the winning types (bottleneck and layer types
    bit for bit), and its energy ties back to them."""
    cd = dense[1]
    lens = em.network_layer_counts(port_nets)
    e_l, t_l = em.evaluate_networks(grids[1].take(cd.core_types), port_nets,
                                    device="cpu", per_layer=True)
    assert cd.score <= cd.homogeneous_score
    assert sum(cd.core_counts) == cd.m_cores == 4
    for j, nm in enumerate(port_nets):
        oracle = partition.schedule_hetero_oracle(t_l[:, j, :lens[j]],
                                                  cd.core_counts)
        s = cd.schedules[nm]
        assert s.bottleneck == oracle["bottleneck"] == cd.latency[nm]
        assert s.layer_type == tuple(int(t) for t in oracle["layer_type"])
        want_e = e_l[oracle["layer_type"], j, np.arange(lens[j])].sum()
        _close(cd.energy[nm], want_e, nm)


@pytest.mark.parametrize("metric", ["edp", "energy", "latency"])
def test_metric_variants_equal_reference(metric, small_grids, ref_nets,
                                         port_nets):
    nets = ("AlexNet", "MobileNet")
    kw = dict(m_cores=2, max_types=2, pool_size=3, metric=metric)
    want = ref_het.co_design(small_grids[0], {n: ref_nets[n] for n in nets},
                             **kw, **REF)
    got = hetero.co_design(small_grids[1], {n: port_nets[n] for n in nets},
                           **kw, device="cpu")
    assert got.metric == metric and sum(got.core_counts) == 2
    assert_codesign_equal(got, want)


def test_duplicated_rows_warn_in_both(small_grids, ref_nets, port_nets):
    """A grid whose rows are duplicated 5× saturates the streamed top-k
    with copies: both packages warn, and a deep top-k restores the dense
    pool."""
    nets = ("AlexNet", "MobileNet")
    idx = np.concatenate([np.arange(small_grids[0].n)] * 5)
    ref_g = ref_acc.ConfigGrid(
        {k: v[idx] for k, v in small_grids[0].fields.items()})
    port_g = convert.grid_from_fields(ref_g.fields)
    kw = dict(max_types=2, pool_size=4, bound=1e-9, chunk_size=13)
    pools = []
    for mod, g, nn, extra in (
            (ref_het, ref_g, ref_nets, REF),
            (hetero, port_g, port_nets, dict(device="cpu"))):
        sub = {n: nn[n] for n in nets}
        with pytest.warns(RuntimeWarning, match="saturate"):
            mod.codesign_problems_streaming(g, sub, 3, **kw, **extra)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            deep = mod.codesign_problems_streaming(g, sub, 3, **kw, **extra,
                                                   topk=20)
        pools.append(deep.pool)
    dense_pool = hetero.codesign_problems(
        port_g, {n: port_nets[n] for n in nets}, 3, max_types=2,
        pool_size=4, bound=1e-9, device="cpu").pool
    assert pools[0] == pools[1] == dense_pool


@pytest.fixture(scope="module")
def small_stream(small_grids, port_nets):
    return em.stream_layer_topk(small_grids[1], port_nets, device="cpu",
                                topk=4, bound=0.05, chunk_size=16)


STREAM_ERRORS = {
    "wrong grid": lambda g, s: (convert.grid_from_fields(
        {k: np.concatenate([v, v]) for k, v in g.fields.items()}),
        dict(pool_size=4, stream=s)),
    "boundary": lambda g, s: (g, dict(stream=dataclasses.replace(
        s, bound=None, boundary_idx=None, boundary_energy=None,
        boundary_latency=None))),
    "bound, metric": lambda g, s: (g, dict(pool_size=4, bound=0.10,
                                           stream=s)),
    "top-k too small": lambda g, s: (g, dict(pool_size=6, stream=s)),
}


@pytest.mark.parametrize("match", list(STREAM_ERRORS))
def test_streaming_value_errors(match, small_grids, port_nets,
                                small_stream):
    grid, kw = STREAM_ERRORS[match](small_grids[1], small_stream)
    with pytest.raises(ValueError, match=match):
        hetero.codesign_problems_streaming(grid, port_nets, 3, **kw)


@pytest.mark.parametrize("deadline", [1.2, 2.0, 1e-3])
def test_score_codesign_deadline_equals_reference(deadline, small_grids,
                                                  ref_nets, port_nets,
                                                  monkeypatch):
    """``score_codesign(deadline=)`` (the energy-aware slack schedules)
    equals the reference's; a deadline no chip meets raises the same
    ``ValueError`` in both.  The reference's call resolves its slack
    solver's backend itself, so its jax probe is switched off here."""
    from repro.core import partition as ref_part
    monkeypatch.setattr(ref_part, "jax_available", lambda: False)
    kw = dict(max_types=2, pool_size=3)
    want_p = ref_het.codesign_problems(small_grids[0], ref_nets, 2, **kw,
                                       **REF)
    got_p = hetero.codesign_problems(small_grids[1], port_nets, 2, **kw,
                                     device="cpu")
    want_r = ref_part.batch_schedule_hetero(
        want_p.lat_dense, want_p.counts, n_layers=want_p.n_layers_b,
        use_jax=False)
    got_r = partition.batch_schedule_hetero(got_p.lat_dense, got_p.counts,
                                            n_layers=got_p.n_layers_b)
    if deadline < 1.0:
        msgs = []
        for mod, p, r in ((ref_het, want_p, want_r),
                          (hetero, got_p, got_r)):
            with pytest.raises(ValueError, match="loosen the deadline") as e:
                mod.score_codesign(p, r, m_cores=2, deadline=deadline)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    want = ref_het.score_codesign(want_p, want_r, m_cores=2,
                                  deadline=deadline)
    got = hetero.score_codesign(got_p, got_r, m_cores=2, deadline=deadline)
    assert_codesign_equal(got, want)
    for nm, s in got.schedules.items():
        j = got_p.names.index(nm)
        assert s.bottleneck <= deadline * got_p.min_latency[j]
    plain = hetero.score_codesign(got_p, got_r, m_cores=2)
    assert got.energy != plain.energy


def test_no_fallback_without_a_card(small_grids, port_nets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hetero.co_design(small_grids[1], port_nets, m_cores=2)
    with pytest.raises(ValueError, match="backend='cuda'"):
        hetero.co_design(small_grids[1], port_nets, m_cores=2,
                         device="cpu", backend="cuda")


@pytest.mark.cuda
def test_card_cuda_equals_torch(grids, port_nets, cuda_device):
    """On the card: the kernels' co-design equals the plain backend's,
    dense and streamed, and the streamed one the dense one."""
    got = hetero.co_design(grids[1], port_nets, **KW, device=cuda_device,
                           backend="cuda")
    want = hetero.co_design(grids[1], port_nets, **KW, device=cuda_device,
                            backend="torch")
    assert_codesign_equal(got, want)
    streamed = hetero.co_design_streaming(grids[1], port_nets, **KW,
                                          device=cuda_device,
                                          backend="cuda", chunk_size=50)
    assert_codesign_equal(streamed, got)
