"""The port's chunk fault injection (``repro_torch.ft.faults``) against the
JAX package's (``repro.ft.faults``): seeded plans equal field by field,
the same element corrupted or perturbed on a full chunk (bit for bit on
the CPU), and both packages' per-layer streams raising
``ChunkCorruption``, ``BackendFault`` and ``StreamKill`` at the same
chunk with the same provenance.  The reference runs its numpy engine.
The port does not pad its last chunk, so positions are compared on full
chunks only; the 18-point grid in chunks of 5 has three of them."""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import energymodel as ref_em
from repro.ft import faults as ref_faults
from repro_torch.core import energymodel as em
from repro_torch.ft import faults

from torch_service_pairs import paired_networks, small_grids

CHUNK = 5
PLAN_FIELDS = [f.name for f in dataclasses.fields(faults.FaultPlan)]


@pytest.fixture(scope="module")
def space():
    g, pg = small_grids()
    nets, pnets = paired_networks()
    return g, pg, nets, pnets


@pytest.mark.parametrize("seed, kw", [
    (0, {}), (1, {}), (2, dict(p_perturb=0.25)),
    (3, dict(p_perturb=0.5, perturb_rel=1e-6)),
    (7, dict(p_fail=0.5, p_corrupt=0.4, max_fails=3, p_perturb=0.3))])
def test_random_plans_equal_reference(seed, kw):
    ref = ref_faults.FaultPlan.random(seed, 24, **kw)
    port = faults.FaultPlan.random(seed, 24, **kw)
    assert PLAN_FIELDS == [f.name for f in
                           dataclasses.fields(ref_faults.FaultPlan)]
    for name in PLAN_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


def _chunk(seed):
    """A per-layer-shaped chunk with a zero-padded layer tail."""
    a = np.random.default_rng(seed).uniform(1.0, 2.0, size=(5, 2, 7))
    a[:, 1, 4:] = 0.0
    return a


@pytest.mark.parametrize("kind", ["nan", "inf", "perturb"])
@pytest.mark.parametrize("target", ["e", "t"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_same_element_hit_as_reference(kind, target, seed):
    """The hook on a CPU tensor hits the reference's element with the
    reference's value, writes a float64 clone, and leaves its inputs and
    the other tensor untouched."""
    e, t = _chunk(seed), _chunk(seed + 100)

    def plan_of(mod):           # a plan pops its own dicts: one each
        kw = (dict(perturb_at={2: 1e-3}) if kind == "perturb"
              else dict(corrupt_at={2: kind}))
        return mod.FaultPlan(seed=seed, target=target, **kw)

    ref_e, ref_t = plan_of(ref_faults)(2, e.copy(), t.copy())
    pe, pt = torch.as_tensor(e), torch.as_tensor(t)
    plan = plan_of(faults)
    got_e, got_t = plan(2, pe, pt)
    for got, want in ((got_e, ref_e), (got_t, ref_t)):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
    assert plan.fired == [(2, kind if kind != "perturb" else "perturb")]
    np.testing.assert_array_equal(pe.numpy(), e)        # inputs untouched
    np.testing.assert_array_equal(pt.numpy(), t)
    untouched = got_t if target == "e" else got_e
    assert untouched is (pt if target == "e" else pe)


def test_perturb_skips_zero_elements():
    """Only nonzero finite elements are eligible, as in the reference."""
    e = np.zeros((3, 2, 4))
    e[1, 0, 2] = 5.0
    out, _ = faults.FaultPlan(perturb_at={0: 0.5}, seed=4)(
        0, torch.as_tensor(e), torch.as_tensor(e))
    want = e.copy()
    want[1, 0, 2] = 7.5
    np.testing.assert_array_equal(out.numpy(), want)


def test_fail_counts_down_and_others_fire_once():
    plan = faults.FaultPlan(fail_at={1: 2}, kill_at=3, pkill_at=4)
    e = t = torch.ones(2, 2)
    for _ in range(2):
        with pytest.raises(faults.BackendFault):
            plan(1, e, t)
    assert plan(1, e, t) == (e, t)
    with pytest.raises(faults.StreamKill):
        plan(3, e, t)
    plan(3, e, t)
    with pytest.raises(faults.ProcessKill):
        plan(4, e, t)
    plan(4, e, t)
    assert plan.fired == [(1, "fail"), (1, "fail"), (3, "kill"),
                          (4, "pkill")]
    assert not issubclass(faults.ProcessKill, Exception)
    with pytest.raises(ValueError, match="target"):
        faults.FaultPlan(target="x")


def test_inject_nests_and_restores_the_port_hook():
    outer, inner = faults.FaultPlan(), faults.FaultPlan()
    before = em._CHUNK_HOOK
    with faults.inject_chunk_faults(outer):
        assert em._CHUNK_HOOK is outer
        with faults.inject_chunk_faults(inner):
            assert em._CHUNK_HOOK is inner
        assert em._CHUNK_HOOK is outer
    assert em._CHUNK_HOOK is before
    assert ref_em._CHUNK_HOOK is None         # the reference's seam alone


def _run(pkg, space, plan, seen):
    """Both packages' per-layer streams, with ``plan`` installed unless it
    is ``None``."""
    g, pg, nets, pnets = space
    mod = ref_faults if pkg == "ref" else faults
    with (mod.inject_chunk_faults(plan) if plan is not None
          else contextlib.nullcontext()):
        if pkg == "ref":
            return ref_em.stream_layer_topk(
                g, nets, backend="numpy", topk=4, bound=0.05,
                chunk_size=CHUNK, on_chunk=seen.append)
        return em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                    bound=0.05, chunk_size=CHUNK,
                                    on_chunk=seen.append)


PLANS = {
    "nan_e_chunk1": dict(corrupt_at={1: "nan"}, seed=3),
    "inf_t_chunk2": dict(corrupt_at={2: "inf"}, seed=5, target="t"),
    "nan_t_chunk0": dict(corrupt_at={0: "nan"}, seed=8, target="t"),
    "fail_chunk2": dict(fail_at={2: 1}),
    "kill_chunk1": dict(kill_at=1),
    "pkill_chunk2": dict(pkill_at=2),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_streams_raise_at_the_same_chunk(space, name):
    """Both packages' streams raise the same fault at the same chunk,
    before the fold commits (``on_chunk`` ran for the earlier chunks
    only), with the reference's provenance."""
    got = {}
    for pkg, mod in (("ref", ref_faults), ("port", faults)):
        plan = mod.FaultPlan(**copy.deepcopy(PLANS[name]))
        seen = []
        with pytest.raises(BaseException) as info:
            _run(pkg, space, plan, seen)
        err = info.value
        got[pkg] = (type(err).__name__, len(seen), plan.fired,
                    getattr(err, "chunk", None), getattr(err, "start", None),
                    getattr(err, "stop", None),
                    getattr(err, "networks", None))
    assert got["port"] == got["ref"]
    assert got["port"][0] in ("ChunkCorruption", "BackendFault",
                              "StreamKill", "ProcessKill")


def test_perturbation_passes_the_guard_in_both(space):
    """A finite perturbation is invisible to the NaN/inf guard: both
    streams finish, and each perturbed the same element of chunk 1."""
    g, pg, nets, pnets = space
    hit = {}
    for pkg, mod, em_mod in (("ref", ref_faults, ref_em),
                             ("port", faults, em)):
        plan = mod.FaultPlan(perturb_at={1: 1e-3}, seed=2)

        def hook(ci, e, t, plan=plan, pkg=pkg):
            e2, t2 = plan(ci, e, t)
            if ci == 1:
                a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                   else x) for x in (e, e2))
                pos = np.argwhere(a != b)
                hit[pkg] = (pos.tolist(),
                            [float(b[tuple(p)] / a[tuple(p)] - 1.0)
                             for p in pos])
            return e2, t2

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(em_mod, "_CHUNK_HOOK", hook)
            _run(pkg, space, None, [])
        assert plan.fired == [(1, "perturb")]
    assert hit["port"][0] == hit["ref"][0] and len(hit["port"][0]) == 1
    assert hit["port"][1] == pytest.approx([1e-3], rel=1e-9)
