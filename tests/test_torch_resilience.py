"""The port's latency-bound Pareto co-design (``hetero.pareto_codesign``)
and fault-scenario co-design (``hetero.resilience_codesign``), held
against the JAX package's numpy path (``backend="numpy", use_jax=False``)
on the paper's 150-point grid × four CNNs.

Agreement: every discrete field (chips, pool, scenario names, validity,
feasibility, fronts, winners, move counts) equal; every float at rtol
1e-12, atol 0 (a streamed and a dense minimum may differ by an ulp);
the frontier methods return the same points.  Tests marked ``cuda`` run
on the card and skip elsewhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import hetero as ref_het
from repro.core import partition as ref_part
from repro.core import topology as ref_topo
from repro_torch.core import convert, energymodel as em, hetero, partition
from repro_torch.ft import hw_faults

NETS = ("AlexNet", "VGG16", "MobileNet", "GoogleNet")
KW = dict(m_cores=4, max_types=3, pool_size=5)
RTOL = 1e-12
REF = dict(backend="numpy", use_jax=False)


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
def probs(grids, ref_nets, port_nets):
    """(reference, port) co-design problem sets: 65 chips × 4 networks."""
    return (ref_het.codesign_problems(grids[0], ref_nets, **KW, **REF),
            hetero.codesign_problems(grids[1], port_nets, **KW,
                                     device="cpu"))


def assert_fields_equal(got, want):
    """Dataclass results: bool / int arrays and plain fields equal, float
    arrays at rtol 1e-12, atol 0, shapes and dtypes equal."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _points_close(got, want):
    assert [c for c, _, _ in got] == [c for c, _, _ in want]
    np.testing.assert_allclose([p[1:] for p in got], [p[1:] for p in want],
                               rtol=RTOL, atol=0)


PARETO = {
    "plain": dict(n_deadlines=8),
    "slack": dict(n_deadlines=8, slack=True),
    "deadlines": dict(deadlines=np.array([1.0, 1.5, 2.5, 4.0, 40.0]),
                      slack=True),
}


@pytest.mark.parametrize("variant", list(PARETO) + ["points"])
def test_pareto_codesign_equals_reference(variant, probs, grids):
    if variant == "points":
        first = hetero.pareto_codesign(probs[1])
        kw = dict(points=(first.energy, first.latency),
                  deadlines=first.deadlines[::2], slack=True)
        ref_kw = dict(kw, use_jax=False)
    else:
        kw, ref_kw = PARETO[variant], dict(PARETO[variant], use_jax=False)
    want = ref_het.pareto_codesign(probs[0], **ref_kw)
    got = hetero.pareto_codesign(probs[1], **kw)
    assert_fields_equal(got, want)
    assert got.n_chips == 65
    for nm in NETS:
        _points_close(got.frontier(nm), want.frontier(nm))
        _points_close(got.slack_frontier(nm), want.slack_frontier(nm))
        _points_close(got.slack_frontier(nm, 0), want.slack_frontier(nm, 0))
    for ci in {0, int(got.best_chip[-1]), got.n_chips - 1}:
        assert got.chip_summary(ci, grids[1]) == \
            want.chip_summary(ci, grids[0])
    if kw.get("slack"):
        assert (got.slack_moves > 0).any()
        assert (got.slack_scores <= got.scores * (1.0 + 1e-9)).all()


def test_pareto_reuses_the_solve(probs):
    res = partition.batch_schedule_hetero(probs[1].lat_dense, probs[1].counts,
                                          n_layers=probs[1].n_layers_b)
    assert_fields_equal(hetero.pareto_codesign(probs[1], res, slack=True),
                        hetero.pareto_codesign(probs[1], slack=True))
    with pytest.raises(ValueError, match=r"points must be \[65, 4\]"):
        hetero.pareto_codesign(probs[1], points=(np.ones((3, 4)),) * 2)


RESILIENCE = {
    "default": dict(),
    "two degradations": dict(degradations=((2, 2), (4, 4))),
    "deadline": dict(degradations=((2, 2), (4, 4)), deadline=2.0),
}


@pytest.mark.parametrize("variant", list(RESILIENCE))
def test_resilience_codesign_equals_reference(variant, probs, grids,
                                              ref_nets, port_nets):
    kw = RESILIENCE[variant]
    want = ref_het.resilience_codesign(grids[0], ref_nets, **KW, **REF,
                                       **kw, probs=probs[0])
    got = hetero.resilience_codesign(grids[1], port_nets, **KW,
                                     device="cpu", **kw, probs=probs[1])
    assert_fields_equal(got, want)
    n_deg = len(kw.get("degradations", ((4, 4),)))
    assert len(got.scenario_names) == 1 + 3 * (1 + n_deg)
    np.testing.assert_allclose(got.worst_overhead, want.worst_overhead,
                               rtol=RTOL, atol=0)
    _points_close(got.frontier(), want.frontier())
    assert got.front[got.best_nominal] and got.front[got.best_robust]
    if variant == "default":       # without probs=, the sweep runs again
        fresh = hetero.resilience_codesign(grids[1], port_nets, **KW,
                                           device="cpu", **kw)
        assert_fields_equal(fresh, got)
    if "deadline" in kw:
        assert (got.slack_moves > 0).any()


def test_stage_marks(probs, grids, port_nets):
    seen = []
    em._stage_hook = seen.append
    try:
        hetero.resilience_codesign(grids[1], port_nets, **KW, device="cpu",
                                   probs=probs[1], deadline=2.0)
        hetero.pareto_codesign(probs[1], slack=True)
    finally:
        em._stage_hook = None
    tail = [s for s in seen if s in ("degraded evaluation", "scenario solve",
                                     "schedule solve", "slack solve",
                                     "pareto scoring", "scoring")]
    assert tail == ["degraded evaluation", "scenario solve", "slack solve",
                    "scoring", "schedule solve", "pareto scoring",
                    "slack solve"]


@pytest.fixture(scope="module")
def small(ref_nets, port_nets):
    """The reference tests' 18-point grid × AlexNet, MobileNet."""
    g = ref_acc.ConfigGrid.product(arrays=((16, 16), (32, 32), (64, 64)),
                                   gb_psum_kb=(13, 54, 216),
                                   gb_ifmap_kb=(27, 108))
    nets = ("AlexNet", "MobileNet")
    return (g, convert.grid_from_fields(g.fields),
            {n: ref_nets[n] for n in nets}, {n: port_nets[n] for n in nets})


def test_resilience_all_types_dead_is_infeasible(small):
    """A 1-type 1-core chip dies entirely under core loss: reported as
    +inf, never raised, as in the reference."""
    kw = dict(max_types=1, pool_size=2, degradations=())
    want = ref_het.resilience_codesign(small[0], small[2], 1, **kw, **REF)
    res = hetero.resilience_codesign(small[1], small[3], 1, **kw,
                                     device="cpu")
    assert_fields_equal(res, want)
    one_core = [c for c in range(res.n_chips)
                if sum(res.chip_counts[c]) == 1]
    assert one_core
    for c in one_core:
        s = 1                              # core_loss@slot0
        assert res.valid[c, s]
        assert not res.feasible[c, :, s].any()
        assert np.isinf(res.scores[c, s])
        assert np.isinf(res.worst_score[c])
    front = res.frontier()
    assert res.best_nominal in [c for c, _, _ in front]
    assert all(np.isinf(w) for _, _, w in front)


def test_duplicated_degraded_row_tie_breaks_to_lower_type():
    """A degradation can make two type rows identical: the per-layer
    argmin picks the lower type index, in the port as in the reference
    and the oracle."""
    lat = np.asarray([[2.0, 3.0, 4.0],
                      [2.0, 3.0, 4.0]])
    counts = np.asarray([2, 2])
    res = partition.batch_schedule_hetero([lat], [counts], strict=False)
    want = ref_part.batch_schedule_hetero([lat], [counts], use_jax=False,
                                          strict=False)
    oracle = partition.schedule_hetero_oracle(lat, counts)
    assert res.bottleneck[0] == want.bottleneck[0] == oracle["bottleneck"]
    assert (res.layer_type[0, :3] == 0).all()
    np.testing.assert_array_equal(res.layer_type, want.layer_type)


def test_degraded_pool_equals_reference(probs, grids, ref_nets, port_nets):
    """The degraded pool rows and their per-layer tensors (the new inputs
    of ``count_layers``) equal the reference's."""
    from repro.core import energymodel as ref_em
    from repro.ft import hw_faults as ref_hw
    for r, c in ((2, 2), (4, 4)):
        deg = hw_faults.degrade_rows(grids[1].take(probs[1].pool), r, c)
        ref_deg = ref_hw.degrade_rows(grids[0].take(probs[0].pool), r, c)
        got = em.evaluate_networks(deg, port_nets, device="cpu",
                                   per_layer=True)
        want = ref_em.evaluate_networks(ref_deg, ref_nets, per_layer=True,
                                        **REF)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_no_fallback_without_a_card(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    kw = dict(max_types=1, pool_size=2, degradations=())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hetero.resilience_codesign(small[1], small[3], 1, **kw)
    with pytest.raises(ValueError, match="backend='cuda'"):
        hetero.resilience_codesign(small[1], small[3], 1, **kw,
                                   device="cpu", backend="cuda")


@pytest.mark.cuda
def test_card_cuda_equals_torch(grids, port_nets, cuda_device):
    """On the card: the kernels' resilience co-design (the degraded pools
    through ``count_layers``) equals the plain backend's, with and
    without a deadline, and the Pareto sweep over it too."""
    kw = dict(**KW, device=cuda_device, degradations=((2, 2), (4, 4)))
    for extra in ({}, dict(deadline=2.0)):
        got = hetero.resilience_codesign(grids[1], port_nets, **kw,
                                         backend="cuda", **extra)
        want = hetero.resilience_codesign(grids[1], port_nets, **kw,
                                          backend="torch", **extra)
        assert_fields_equal(got, want)
    p = {b: hetero.codesign_problems(grids[1], port_nets, **KW,
                                     device=cuda_device, backend=b)
         for b in ("cuda", "torch")}
    assert_fields_equal(hetero.pareto_codesign(p["cuda"], slack=True),
                        hetero.pareto_codesign(p["torch"], slack=True))
