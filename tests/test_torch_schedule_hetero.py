"""The port's heterogeneous layer→core schedule
(``partition.batch_schedule_hetero``, ``BatchHeteroResult``,
``schedule_hetero_oracle``), held against the JAX package's numpy body
(``use_jax=False``) on the same seeded numpy problems.

Agreement: every field of the two ``BatchHeteroResult``s equal, dtype and
shape included (``np.array_equal``, so every bottleneck bit for bit);
``schedule(i)`` gives equal ``HeteroSchedule`` fields; the two oracles
agree bit for bit, and the port's batch bottlenecks and layer types are
its own oracle's.  The reference's error cases raise ``ValueError`` in
the port too.  Everything here is host numpy: no device is involved.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import partition as ref
from repro_torch.core import partition as port

FIELDS = [f.name for f in dataclasses.fields(ref.BatchHeteroResult)]


def _random_problems(seed, n, *, max_types=3, max_layers=29, max_count=5,
                     lat=(0.01, 10.0)):
    """Ragged (lat [T, L], counts [T]) problems; at least one core each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(1, max_types + 1))
        length = int(rng.integers(1, max_layers + 1))
        counts = rng.integers(0, max_count + 1, size=t)
        if counts.sum() == 0:
            counts[int(rng.integers(t))] = 1
        out.append((rng.uniform(*lat, size=(t, length)), counts))
    return out


def _padded_counts(problems, width):
    counts = np.zeros((len(problems), width), dtype=np.int64)
    for i, (_, cn) in enumerate(problems):
        counts[i, :cn.shape[0]] = cn
    return counts


def _ragged():
    """Ragged list input with zero-count padding types (width 4 > T)."""
    probs = _random_problems(7, 60)
    return [p[0] for p in probs], _padded_counts(probs, 4), {}


def _ties():
    """Latencies drawn from three values: argmin ties on most layers."""
    rng = np.random.default_rng(11)
    lat = rng.choice([1.0, 2.0, 3.0], size=(40, 3, 17))
    counts = rng.integers(0, 4, size=(40, 3))
    counts[counts.sum(axis=1) == 0, 1] = 2
    return lat, counts, {}


def _row_classes():
    """One dense block that holds every row class: kk == 1, kk == n_t
    (more cores than the type's layers), kk == 2, and 2 < kk < n_t."""
    rng = np.random.default_rng(3)
    lat = rng.uniform(0.5, 4.0, size=(6, 2, 12))
    counts = np.array([[1, 0], [0, 2], [3, 0], [5, 1], [40, 0], [2, 3]])
    return lat, counts, dict(n_layers=np.array([12, 9, 12, 5, 12, 11]))


def _twelve_cores():
    """Counts above ``_K_MAX``: ``starts`` widens past 8."""
    lat = np.abs(np.sin(np.arange(80.0))).reshape(2, 40) + 0.1
    return [lat, lat[:1, :33]], np.array([[12, 3], [12, 0]]), {}


def _scenarios(counts_ndim, lens_ndim):
    def make():
        rng = np.random.default_rng(5)
        lat = rng.uniform(0.1, 9.0, size=(4, 3, 3, 14))     # [B, S, T, L]
        counts = rng.integers(0, 4, size=(4, 3, 3))
        counts[counts.sum(axis=-1) == 0, 0] = 1
        if counts_ndim == 2:
            counts = counts[:, 0]
        lens = rng.integers(1, 15, size=(4, 3) if lens_ndim == 2 else 4)
        return lat, counts, dict(n_layers=lens)
    return make


def _infeasible():
    """``strict=False``: an all-zero problem is reported, not raised."""
    rng = np.random.default_rng(9)
    lat = rng.uniform(0.1, 2.0, size=(3, 2, 6))
    counts = np.array([[1, 2], [0, 0], [0, 3]])
    return lat, counts, dict(strict=False, labels=("a", "b", "c"))


def _flat_counts():
    """One ``[T]`` counts row broadcast over a dense batch."""
    rng = np.random.default_rng(13)
    return rng.uniform(1.0, 3.0, size=(9, 3, 10)), np.array([2, 0, 3]), {}


CASES = {
    "ragged_list_zero_count_padding": _ragged,
    "argmin_ties": _ties,
    "row_classes": _row_classes,
    "twelve_cores": _twelve_cores,
    "scenarios_BST_counts": _scenarios(3, 1),
    "scenarios_BT_counts_BS_lengths": _scenarios(2, 2),
    "strict_false_labels": _infeasible,
    "flat_counts": _flat_counts,
    "empty": lambda: ([], [], {}),
}


def _assert_results_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y), f
        else:
            assert x == y, f


def _schedule_fields(s):
    return dataclasses.astuple(s)


@pytest.mark.parametrize("case", list(CASES))
def test_batch_schedule_equals_reference(case):
    lat, counts, kw = CASES[case]()
    want = ref.batch_schedule_hetero(lat, counts, use_jax=False, **kw)
    got = port.batch_schedule_hetero(lat, counts, **kw)
    _assert_results_equal(got, want)
    np.testing.assert_array_equal(got.speedup, want.speedup)
    for i in range(len(got)):
        if got.feasible[i]:
            assert _schedule_fields(got.schedule(i)) == \
                _schedule_fields(want.schedule(i)), i
    if case == "twelve_cores":
        assert got.starts.shape[-1] == 12 > port._K_MAX
    if case == "row_classes":
        n_t = (got.layer_type[:, None, :] == np.arange(2)[None, :, None]
               ).sum(-1)
        kinds = {int(k) for k in got.seg_counts[got.counts > 0]}
        assert {1, 2} <= kinds and max(kinds) > 2
        assert (got.seg_counts == n_t)[got.counts > 0].any()


@pytest.mark.parametrize("case", [c for c in CASES if c != "empty"])
def test_batch_schedule_equals_oracle(case):
    """The port's batch bottlenecks and layer types are its own scalar
    oracle's, bit for bit, problem by problem; the totals at 1e-12."""
    lat, counts, kw = CASES[case]()
    res = port.batch_schedule_hetero(lat, counts, **kw)
    if isinstance(lat, np.ndarray) and lat.ndim == 4:
        lat = lat.reshape(-1, *lat.shape[2:])
    for i in range(len(res)):
        if not res.feasible[i]:
            continue
        n = int(res.n_layers[i])
        want = port.schedule_hetero_oracle(np.asarray(lat[i])[:, :n],
                                           res.counts[i])
        assert res.bottleneck[i] == want["bottleneck"], i
        np.testing.assert_array_equal(res.layer_type[i, :n],
                                      want["layer_type"])
        # the batch sums the layers type by type, the oracle in layer
        # order: the totals round differently (in the reference too)
        assert res.total[i] == pytest.approx(want["total"], rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_equals_reference(seed):
    for lat, counts in _random_problems(seed, 40, max_layers=9,
                                        max_count=4):
        want = ref.schedule_hetero_oracle(lat, counts)
        got = port.schedule_hetero_oracle(lat, counts)
        assert got["bottleneck"] == want["bottleneck"]
        assert got["total"] == want["total"]
        assert got["speedup"] == want["speedup"]
        np.testing.assert_array_equal(got["layer_type"], want["layer_type"])


def test_infeasible_problem_is_named():
    lat, counts, kw = _infeasible()
    res = port.batch_schedule_hetero(lat, counts, **kw)
    assert res.feasible.tolist() == [True, False, True]
    assert res.bottleneck[1] == np.inf
    with pytest.raises(ValueError, match="b: infeasible"):
        res.schedule(1)
    anon = port.batch_schedule_hetero(lat, counts, strict=False)
    with pytest.raises(ValueError, match="problem 1: infeasible"):
        anon.schedule(1)


ERRORS = {
    "no_layers": (lambda m, **k: m.batch_schedule_hetero(
        [np.zeros((1, 0))], [[1]], **k)),
    "all_zero_counts": (lambda m, **k: m.batch_schedule_hetero(
        [np.ones((2, 3))], [[0, 0]], **k)),
    "oracle_no_core": (lambda m, **k: m.schedule_hetero_oracle(
        np.ones((1, 3)), [0])),
    "phantom_type": (lambda m, **k: m.batch_schedule_hetero(
        [np.array([[1.0, 2.0, 3.0]])], [[1, 1]], **k)),
    "oracle_phantom_type": (lambda m, **k: m.schedule_hetero_oracle(
        np.array([[1.0, 2.0, 3.0]]), [1, 1])),
    "ragged_phantom_type": (lambda m, **k: m.batch_schedule_hetero(
        [np.array([[1.0, 2.0, 3.0]]), np.ones((2, 4))],
        np.array([[1, 2], [1, 1]]), **k)),
    "counts_rows": (lambda m, **k: m.batch_schedule_hetero(
        np.ones((2, 1, 3)), np.ones((3, 1), np.int64), **k)),
    "labels_length": (lambda m, **k: m.batch_schedule_hetero(
        np.ones((2, 1, 3)), [1], labels=("x",), **k)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_raise_in_both(case):
    call = ERRORS[case]
    kw = {} if case.startswith("oracle") else {"use_jax": False}
    with pytest.raises(ValueError):
        call(ref, **kw)
    with pytest.raises(ValueError):
        call(port)


def test_zero_count_padding_is_legal():
    lat = np.array([[1.0, 2.0, 3.0]])
    assert port.batch_schedule_hetero([lat], [[2, 0]]).bottleneck[0] == 3.0
    assert port.schedule_hetero_oracle(lat, [2, 0])["bottleneck"] == 3.0
