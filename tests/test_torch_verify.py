"""The port's silent-corruption defense (``repro_torch.ft.verify``) against
the JAX package's (``repro.ft.verify``): on the same corrupted fold states
both verifiers raise the same invariant with the same provenance and
message; the seeded chunk sampling is the same; a perturbed full chunk in
both packages' streams gives the same shadow provenance (grid row,
network, term); the at-rest checks give the same reasons and the scrubber
catches a self-consistent poison.  The port's shadow is its plain torch
path on the CPU, compared bit for bit against chunks computed there and
within ``SHADOW_RTOL`` against any other route."""

import json
import re

import numpy as np
import pytest
import torch

from repro.core import energymodel as ref_em
from repro.ft import faults as ref_faults
from repro.ft import verify as ref_verify
from repro.serving import store as ref_store
from repro_torch.core import energymodel as em
from repro_torch.ft import faults, verify
from repro_torch.serving import store

from torch_service_pairs import RTOL, paired_networks, small_grids

NAMES = ("NetA", "NetB")


@pytest.fixture(scope="module")
def space():
    g, pg = small_grids()
    nets, pnets = paired_networks()
    return g, pg, nets, pnets


def _layer_state():
    """The reference tests' self-consistent layer_topk state (2 nets, 2
    layers, k=2)."""
    top_e = np.array([[[1.0, 1.0], [1.5, 0.5]],
                      [[2.0, 1.0], [2.0, 2.0]]])
    top_t = np.ones((2, 2, 2))
    es, ts = top_e.sum(-1), top_t.sum(-1)
    top_v = es * ts
    top_i = np.array([[0, 5], [3, 7]])
    return [top_v, top_i, top_e, top_t, es.min(0), ts.min(0), top_v.min(0),
            top_v[0].copy(), top_i[0].copy(),
            np.array([[0.9, 0.9], [1.4, 0.4]]), np.array([[0, 0], [5, 5]])]


def _networks_state():
    top_v = np.array([[4.0, 4.0], [6.0, 8.0]])
    top_i = np.array([[0, 5], [3, 7]])
    return [np.array([2.0, 2.0]), np.array([2.0, 2.0]), top_v[0].copy(),
            top_i[0].copy(), top_v, top_i]


def _raise_slot(slot):
    def f(new):
        new[slot] = new[slot] + 1.0
    return f


def _swap_top(new):
    new[0] = new[0][::-1].copy()


def _tie_lex(new):
    new[0][:, 0] = 4.0
    new[1][:, 0] = [3, 0]
    new[2][:, 0] = [[1.0, 1.0], [1.5, 0.5]]


def _dup(new):
    new[1][1, 1] = 5
    new[0][1, 1] = 4.0
    new[2][1, 1] = [1.5, 0.5]


def _min_ne_top(new):
    new[7] = new[7] - 0.5


def _layer_sum(new):
    new[2][1, 0, 0] *= 1.01


CASES = {
    # name: (kind, mutation of the new state, boundary hits, resume?)
    "min_energy": ("layer_topk", _raise_slot(4), None, False),
    "min_latency": ("layer_topk", _raise_slot(5), None, False),
    "min_edp": ("layer_topk", _raise_slot(6), None, False),
    "min_metric": ("layer_topk", _raise_slot(7), None, False),
    "layer_min_metric": ("layer_topk", _raise_slot(9), None, False),
    "networks_min_metric": ("networks", _raise_slot(2), None, False),
    "topk_sorted": ("layer_topk", _swap_top, None, False),
    "topk_tiebreak": ("layer_topk", _tie_lex, None, False),
    "topk_unique": ("layer_topk", _dup, None, False),
    "min_equals_top": ("layer_topk", _min_ne_top, None, False),
    "layer_sum": ("layer_topk", _layer_sum, None, False),
    "boundary_outside": ("layer_topk", None, "outside", False),
    "boundary_below": ("layer_topk", None, "below", False),
    "resume_nan": ("layer_topk", lambda s: s[5].__setitem__(0, np.nan),
                   None, True),
    "resume_cand_below": ("layer_topk", None, "cand", True),
}


def _hits(how):
    """(es, ts, mask) of one chunk of 3 rows: a hit outside
    [min, min*(1+bound)] or below the minimum."""
    es = np.array([[2.0, 2.0], [2.5, 2.0], [2.0, 3.0]])
    ts = np.full((3, 2), 2.0)
    if how == "below":
        es[1, 0] = 1.0
    mask = np.zeros((3, 2), dtype=bool)
    mask[1, 0] = True
    return es, ts, mask


def _check(mod, case, as_tensor):
    """Run one case through ``mod``'s verifier → the error's fields."""
    kind, mutate, hits, resume = CASES[case]
    make = _networks_state if kind == "networks" else _layer_state
    prev, new = make(), make()
    if mutate is not None:
        mutate(new)
    conv = ((lambda a: torch.as_tensor(np.asarray(a))) if as_tensor
            else (lambda a: a))
    v = mod.StreamVerifier(verify_fraction=0.0)
    v.bind(kind=kind, names=NAMES, metric="edp", topk=2, bound=0.1,
           backend="torch" if as_tensor else "numpy")
    try:
        if resume:
            cand = {nm: [] for nm in NAMES}
            if hits == "cand":
                cand["NetB"] = [(np.array([9]), np.array([1.0]),
                                 np.array([1.0]))]
            v.check_resume([conv(a) for a in new], cand)
        else:
            kw = {}
            if hits is not None:
                kw = {k: conv(a) for k, a in zip(("es", "ts", "mask"),
                                                 _hits(hits))}
            v.check_fold(3, 15, 20, [conv(a) for a in prev],
                         [conv(a) for a in new], **kw)
    except mod.FoldInvariantError as err:
        return (err.invariant, err.chunk, err.start, err.stop, err.network,
                err.row, str(err), v.stats)
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_invariant_as_reference(case):
    want = _check(ref_verify, case, as_tensor=False)
    got = _check(verify, case, as_tensor=True)
    assert want is not None
    assert got == want


def test_clean_states_pass_in_both():
    for mod, conv in ((ref_verify, np.asarray), (verify, torch.as_tensor)):
        for kind, make in (("layer_topk", _layer_state),
                           ("networks", _networks_state)):
            v = mod.StreamVerifier(verify_fraction=0.0)
            v.bind(kind=kind, names=NAMES, metric="edp", topk=2,
                   bound=0.1, backend="torch")
            v.check_fold(0, 0, 2, [conv(a) for a in make()],
                         [conv(a) for a in make()])
            v.check_resume([conv(a) for a in make()], {})
            assert v.stats["invariant_violations"] == 0


@pytest.mark.parametrize("seed, fraction", [(0, 1 / 16), (7, 0.25),
                                            (3, 0.5), (1, 1.0), (2, 0.0)])
def test_sampling_equals_reference(seed, fraction):
    ref = ref_verify.StreamVerifier(verify_fraction=fraction, seed=seed)
    port = verify.StreamVerifier(verify_fraction=fraction, seed=seed)
    assert [port.sampled(ci) for ci in range(96)] == \
        [ref.sampled(ci) for ci in range(96)]


def test_shadow_tolerance_follows_the_route():
    """Bit for bit against a chunk computed on the shadow's own path (CPU
    torch); ``SHADOW_RTOL`` for the kernels: a one-ulp difference raises
    only in the first case."""
    e = torch.ones(2, 2, 2, dtype=torch.float64)
    t = torch.ones(2, 2, 2, dtype=torch.float64)
    e_ref = e.numpy() * (1.0 + 1e-15)
    for backend, raises in (("torch", True), ("cuda", False)):
        v = verify.StreamVerifier(verify_fraction=1.0)
        v.bind(kind="layer_topk", names=NAMES, metric="edp", topk=2,
               bound=0.1, backend=backend,
               ref_eval=lambda fc: (e_ref, t.numpy()))
        assert v.rtol_for(e) == (0.0 if raises else verify.SHADOW_RTOL)
        if raises:
            with pytest.raises(verify.ShadowMismatchError):
                v.check_chunk(0, 0, 2, None, e, t)
        else:
            v.check_chunk(0, 0, 2, None, e, t)
        assert v.stats["shadow_mismatches"] == int(raises)
    assert verify.SHADOW_RTOL == ref_verify.SHADOW_RTOL
    assert verify.SUM_RTOL == ref_verify.SUM_RTOL


def _stream(pkg, space, plan, v):
    g, pg, nets, pnets = space
    mod = ref_faults if pkg == "ref" else faults
    with mod.inject_chunk_faults(plan):
        if pkg == "ref":
            return ref_em.stream_layer_topk(
                g, nets, backend="numpy", topk=4, bound=0.05,
                chunk_size=5, verify=v)
        return em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                    bound=0.05, chunk_size=5, verify=v)


@pytest.mark.parametrize("seed, target, ci", [(0, "e", 1), (4, "t", 0),
                                              (9, "e", 2)])
def test_shadow_provenance_equals_reference(space, seed, target, ci):
    """A finite perturbation of a full chunk: both verifiers raise before
    the fold commits, naming the same grid row, network and term."""
    errs = {}
    for pkg, fmod, vmod in (("ref", ref_faults, ref_verify),
                            ("port", faults, verify)):
        v = vmod.StreamVerifier(verify_fraction=1.0)
        plan = fmod.FaultPlan(perturb_at={ci: 1e-3}, seed=seed,
                              target=target)
        with pytest.raises(vmod.ShadowMismatchError) as info:
            _stream(pkg, space, plan, v)
        errs[pkg] = (info.value, v.stats)
    (r, r_stats), (p, p_stats) = errs["ref"], errs["port"]
    assert (p.chunk, p.start, p.stop) == (r.chunk, r.start, r.stop) == \
        (ci, 5 * ci, 5 * ci + 5)
    assert [(m["row"], m["network"], m["term"]) for m in p.mismatches] == \
        [(m["row"], m["network"], m["term"]) for m in r.mismatches]
    assert len(p.mismatches) == 1
    for m, n in zip(p.mismatches, r.mismatches):
        np.testing.assert_allclose([m["got"], m["want"]],
                                   [n["got"], n["want"]], rtol=RTOL, atol=0)
    assert p_stats == r_stats


def test_clean_stream_counts_equal_reference(space):
    """A sampled share of chunks on a clean stream: no violation, and the
    same checks counted as the reference's."""
    stats = {}
    for pkg, fmod, vmod in (("ref", ref_faults, ref_verify),
                            ("port", faults, verify)):
        v = vmod.StreamVerifier(verify_fraction=0.5, seed=3)
        _stream(pkg, space, fmod.FaultPlan(), v)
        stats[pkg] = v.stats
    assert stats["port"] == stats["ref"]
    assert stats["port"]["shadow_checks"] >= 1
    assert stats["port"]["invariant_checks"] == 4


def test_evidence_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_EVIDENCE_DIR", str(tmp_path))
    e = torch.ones(2, 2, 2, dtype=torch.float64)
    v = verify.StreamVerifier(verify_fraction=1.0)
    v.bind(kind="layer_topk", names=NAMES, metric="edp", topk=2,
           bound=0.1, backend="cuda",
           ref_eval=lambda fc: (e.numpy() * 1.001, e.numpy()))
    with pytest.raises(verify.ShadowMismatchError):
        v.check_chunk(1, 5, 7, None, e, e)
    files = list(tmp_path.glob("shadow_mismatch_*.json"))
    assert len(files) == 1
    ev = json.loads(files[0].read_text())
    assert ev["chunk"] == 1 and ev["rtol"] == verify.SHADOW_RTOL
    assert ev["mismatches"][0]["network"] in NAMES


# -- at-rest checks and the scrubber ---------------------------------------

@pytest.fixture(scope="module")
def streams(space):
    """(reference LayerTopK, the port's) of the same sweep."""
    g, pg, nets, pnets = space
    return (ref_em.stream_layer_topk(g, nets, backend="numpy", topk=4,
                                     bound=0.05, chunk_size=6),
            em.stream_layer_topk(pg, pnets, device="cpu", topk=4,
                                 bound=0.05, chunk_size=6))


def _damaged(st, pay, load, how):
    """``st``'s payload with one structural fault → a LayerTopK."""
    arrays, meta = pay(st)
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    if how == "nan":
        a["topk_metric"][1, 0] = np.nan
    elif how == "unsorted":
        a["topk_metric"][[0, 1], 1] = a["topk_metric"][[1, 0], 1]
    elif how == "duplicate":
        a["topk_idx"][1, 0] = a["topk_idx"][0, 0]
        a["topk_metric"][1, 0] = a["topk_metric"][0, 0]
    elif how == "min":
        a["min_metric"][0] *= 0.5
    elif how == "layer_sum":
        a["layer_energy"][2, 1] *= 1.01
    elif how == "boundary":
        a["bnd0_e"][0] *= 0.5
    return load(a, meta)


def _poisoned(st, pay, load, rel=1.001):
    """The reference tests' self-consistent poison: one top-k row's
    per-layer energy scaled and its ranking value recomputed to match."""
    arrays, meta = pay(st)
    for k, j in np.argwhere(np.asarray(st.topk_idx) >= 0):
        if k == 0:
            continue
        a = {kk: np.array(v, copy=True) for kk, v in arrays.items()}
        li = np.nonzero(a["layer_energy"][k, j])[0][0]
        a["layer_energy"][k, j, li] *= rel
        a["topk_metric"][k, j] = a["layer_energy"][k, j].sum() * \
            a["layer_latency"][k, j].sum()
        bad = load(a, meta)
        if verify.check_layer_topk_result(bad) is None:
            return bad
    raise AssertionError("no poisonable self-consistent cell found")


@pytest.mark.parametrize("how", ["clean", "nan", "unsorted", "duplicate",
                                 "min", "layer_sum", "boundary"])
def test_at_rest_reasons_equal_reference(streams, how):
    ref_st, port_st = streams
    want = ref_verify.check_layer_topk_result(_damaged(
        ref_st, ref_store.stream_payload, ref_store.stream_from_payload,
        how))
    got = verify.check_layer_topk_result(_damaged(
        port_st, store.stream_payload, store.stream_from_payload, how))
    assert (got is None) == (how == "clean")
    # the same reason; the float values in it may differ in the last
    # digits (the packages sum layers in different orders)
    floats = re.compile(r"\d+\.\d+(e[+-]?\d+)?")
    assert floats.sub("#", got or "") == floats.sub("#", want or "")


def test_scrub_catches_selfconsistent_poison(space, streams):
    """A poisoned but self-consistent payload passes every structural
    check; re-deriving its rows on the plain path catches it.  The clean
    payload passes the same audit."""
    g, pg, nets, pnets = space
    _, st = streams
    assert verify.scrub_layer_topk(st, pg, pnets, rows=999) is None
    bad = _poisoned(st, store.stream_payload, store.stream_from_payload)
    reason = verify.scrub_layer_topk(bad, pg, pnets, rows=999)
    assert reason is not None and "diverges from the plain-path" in reason
    ref_bad = _poisoned(streams[0], ref_store.stream_payload,
                        ref_store.stream_from_payload)
    assert ref_verify.scrub_layer_topk(ref_bad, g, nets, rows=999)
