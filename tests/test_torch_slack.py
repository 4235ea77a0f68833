"""The port's deadline-slack solver (``partition.batch_slack_schedule``,
``slack_schedule_oracle``, ``BatchSlackResult``) and Pareto scoring
(``partition.batch_pareto_scores``), held against the JAX package's numpy
bodies (``use_jax=False``) and the scalar oracles of ``tests/oracles.py``.

Agreement: every ``BatchSlackResult`` field (and its ``base``) equal to
the reference's with ``np.testing.assert_array_equal``; every (problem,
deadline) cell bit-equal to both packages' ``slack_schedule_oracle``;
every Pareto output equal to the reference's and to the python-loop and
brute-force oracles; the errors raise in both packages with the same
message.  The batches hold problems of 1 to 10 layers, so the solver's
depth-bucketed branch (more than 8 distinct depths) runs.
"""

import dataclasses

import numpy as np
import pytest

from oracles import brute_frontier, loop_pareto_scores, seeded_slack_instances
from repro.core import partition as ref_part
from repro_torch.core import partition

INSTANCES = seeded_slack_instances(2024, 60)
DL_COLS = 6


def _deadline_grid(t_star):
    """The deadline neighbourhood of the latency-optimal bottleneck T*:
    infeasible, exact, one-ulp slack, loose, infinite."""
    return (0.5 * t_star, t_star, t_star * (1.0 + 1e-12),
            1.5 * t_star, 3.0 * t_star, np.inf)


def _ragged():
    """The instances as per-problem matrices, counts zero-padded to
    [B, 3] (a zero count on an absent type slot is legal)."""
    lats = [lat for lat, _, _ in INSTANCES]
    ens = [en for _, en, _ in INSTANCES]
    counts = np.zeros((len(INSTANCES), 3), np.int64)
    for i, (_, _, c) in enumerate(INSTANCES):
        counts[i, :c.shape[0]] = c
    return lats, ens, counts


def _dense():
    """The instances as one dense [B, 3, 10] block: the columns past each
    problem's depth hold garbage (the solver scrubs them), the rows of
    an absent type +inf (their count is 0)."""
    lats, ens, counts = _ragged()
    lat = np.full((len(lats), 3, 10), 7.0)
    en = np.full((len(lats), 3, 10), 7.0)
    for i, (l, e) in enumerate(zip(lats, ens)):
        lat[i, :l.shape[0], :l.shape[1]] = l
        en[i, :e.shape[0], :e.shape[1]] = e
        lat[i, l.shape[0]:] = np.inf
        en[i, e.shape[0]:] = np.inf
    return lat, en, counts, np.array([l.shape[1] for l in lats])


def _dl_rows():
    return np.array([
        _deadline_grid(partition.schedule_hetero_oracle(lat, c)["bottleneck"])
        for lat, _, c in INSTANCES])


def assert_hetero_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"base.{f.name}")
            assert a.shape == b.shape, f.name
        else:
            assert a == b, f.name


def assert_slack_equal(got, want):
    """Every field of two ``BatchSlackResult`` equal, ``base`` too."""
    assert_hetero_equal(got.base, want.base)
    for f in dataclasses.fields(want):
        if f.name == "base":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_batches_take_the_depth_buckets():
    depths = {lat.shape[1] for lat, _, _ in INSTANCES}
    assert len(depths) > 8 and max(depths) == 10


@pytest.mark.parametrize("case", ["ragged [B, D]", "dense [B, D]",
                                  "dense scalar", "ragged [D]"])
def test_batch_slack_equals_reference(case):
    layout, dl_kind = case.split(" ", 1)
    if layout == "ragged":
        lat, en, counts = _ragged()
        kw = {}
    else:
        lat, en, counts, n_layers = _dense()
        kw = dict(n_layers=n_layers)
    dls = {"[B, D]": _dl_rows(), "scalar": 2.5,
           "[D]": np.array([1.0, 2.5, 4.0, np.inf])}[dl_kind]
    got = partition.batch_slack_schedule(lat, en, counts, dls, **kw)
    want = ref_part.batch_slack_schedule(lat, en, counts, dls, **kw,
                                         use_jax=False)
    assert_slack_equal(got, want)
    assert (got.n_moves > 0).any() and (~got.feasible).any()


def test_every_cell_equals_both_oracles():
    """Each (problem, deadline) cell of the ragged batch equals the port's
    and the reference's ``slack_schedule_oracle`` bit for bit, and a
    feasible cell materialises a schedule that meets its deadline."""
    lats, ens, cnts = _ragged()
    dls = _dl_rows()
    res = partition.batch_slack_schedule(lats, ens, cnts, dls)
    for i, (lat, en, c) in enumerate(INSTANCES):
        n_l = lat.shape[1]
        for d in range(DL_COLS):
            mine = partition.slack_schedule_oracle(lat, en, c, dls[i, d])
            ref = ref_part.slack_schedule_oracle(lat, en, c, dls[i, d])
            for o in (mine, ref):
                assert res.bottleneck[i, d] == o["bottleneck"], (i, d)
                assert res.energy[i, d] == o["energy"], (i, d)
                assert res.n_moves[i, d] == o["n_moves"], (i, d)
                assert bool(res.feasible[i, d]) == o["feasible"], (i, d)
                np.testing.assert_array_equal(res.layer_type[i, d, :n_l],
                                              o["layer_type"])
            if res.feasible[i, d]:
                s = res.schedule(i, d)
                assert s.bottleneck <= dls[i, d] and s.n_layers == n_l
            else:
                with pytest.raises(ValueError, match="infeasible"):
                    res.schedule(i, d)


@pytest.mark.parametrize("counts_rank", [3, 2])
def test_scenario_axis_equals_reference(counts_rank):
    """A [B, S, T, L] block (20 problems × 3 scenarios) with [B, S, T] or
    [B, T] counts and [B, S] or [B] depths equals the reference's, and
    equals the flattened batch."""
    lat, en, counts, n_layers = _dense()
    lat4, en4 = lat.reshape(20, 3, 3, 10), en.reshape(20, 3, 3, 10)
    if counts_rank == 3:
        c4, nl4 = counts.reshape(20, 3, 3), n_layers.reshape(20, 3)
        flat_c, flat_nl = counts, n_layers
    else:
        c4, nl4 = counts[::3], n_layers[::3]
        flat_c, flat_nl = np.repeat(c4, 3, axis=0), np.repeat(nl4, 3)
        # the scenarios of a problem share its depth and counts
        lat4 = np.repeat(lat[::3, None], 3, axis=1)
        lat4[:, 1:, 0] *= 1.5
        en4 = np.repeat(en[::3, None], 3, axis=1)
    dls = np.array([1.0, 2.0, 5.0])
    got = partition.batch_slack_schedule(lat4, en4, c4, dls, n_layers=nl4)
    want = ref_part.batch_slack_schedule(lat4, en4, c4, dls, n_layers=nl4,
                                         use_jax=False)
    assert_slack_equal(got, want)
    flat = partition.batch_slack_schedule(
        lat4.reshape(60, 3, 10), en4.reshape(60, 3, 10), flat_c, dls,
        n_layers=flat_nl)
    assert_slack_equal(got, flat)


def test_base_reuse_equals_reference():
    lats, ens, cnts = _ragged()
    dls = _dl_rows()
    base = partition.batch_schedule_hetero(lats, cnts)
    ref_base = ref_part.batch_schedule_hetero(lats, cnts, use_jax=False)
    got = partition.batch_slack_schedule(lats, ens, cnts, dls, base=base)
    want = ref_part.batch_slack_schedule(lats, ens, cnts, dls,
                                         use_jax=False, base=ref_base)
    assert got.base is base
    assert_slack_equal(got, want)
    assert_slack_equal(got, partition.batch_slack_schedule(lats, ens, cnts,
                                                           dls))


def test_strict_false_with_labels_equals_reference():
    """Problems whose counts are all zero are reported infeasible in every
    deadline column (the labels name them), the rest solve as usual."""
    lat, en, counts, n_layers = _dense()
    counts = counts.copy()
    counts[[3, 17, 41]] = 0
    labels = [f"p{i}" for i in range(len(counts))]
    dls = _dl_rows()
    kw = dict(n_layers=n_layers, strict=False, labels=labels)
    got = partition.batch_slack_schedule(lat, en, counts, dls, **kw)
    want = ref_part.batch_slack_schedule(lat, en, counts, dls, **kw,
                                         use_jax=False)
    assert_slack_equal(got, want)
    assert not got.feasible[[3, 17, 41]].any()
    for res in (got, want):
        with pytest.raises(ValueError, match="p17: infeasible"):
            res.schedule(17, 5)


def test_empty_batch_equals_reference():
    got = partition.batch_slack_schedule([], [], np.zeros((0, 2)),
                                         [1.0, 2.0])
    want = ref_part.batch_slack_schedule([], [], np.zeros((0, 2)),
                                         [1.0, 2.0], use_jax=False)
    assert len(got) == 0 and got.n_deadlines == 2
    for f in dataclasses.fields(want):
        if f.name != "base":
            assert getattr(got, f.name).shape == getattr(want, f.name).shape


ERR_CASES = ("4-D energies", "dense energies", "ragged energy count",
             "ragged energy shape", "deadlines shape", "counts rows",
             "phantom types", "base length", "strict")


def _err_case(case):
    lat, en, counts, _ = _dense()
    lats, ens, cnts = _ragged()
    one = [np.ones((2, 3))]
    return {
        "4-D energies": ((lat.reshape(20, 3, 3, 10), en[:30], counts, 1.0),
                         {}),
        "dense energies": ((lat, en[:, :2], counts, 1.0), {}),
        "ragged energy count": ((lats, ens[:-1], cnts, 1.0), {}),
        "ragged energy shape": ((one, [np.ones((2, 2))], [[1, 1]], 1.0), {}),
        "deadlines shape": ((lats, ens, cnts, np.ones((3, 2))), {}),
        "counts rows": ((lat, en, counts[:5], 1.0), {}),
        "phantom types": ((one, one, [[1, 1, 1]], 1.0), {}),
        "base length": ((one, one, [[1, 1]], 1.0),
                        dict(base=partition.batch_schedule_hetero(
                            lats, cnts))),
        "strict": ((one, one, [[0, 0]], 1.0), {}),
    }[case]


@pytest.mark.parametrize("case", ERR_CASES)
def test_errors_match_reference(case):
    args, kw = _err_case(case)
    with pytest.raises(ValueError) as mine:
        partition.batch_slack_schedule(*args, **kw)
    if "base" in kw:
        kw = dict(base=ref_part.batch_schedule_hetero(*_ragged()[::2],
                                                      use_jax=False))
    with pytest.raises(ValueError) as ref:
        ref_part.batch_slack_schedule(*args, **kw, use_jax=False)
    assert str(mine.value) == str(ref.value)


def test_oracle_error_matches_reference():
    args = (np.ones((2, 3)), np.ones((2, 2)), [1, 1], 1.0)
    with pytest.raises(ValueError) as mine:
        partition.slack_schedule_oracle(*args)
    with pytest.raises(ValueError) as ref:
        ref_part.slack_schedule_oracle(*args)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# batch_pareto_scores
# ---------------------------------------------------------------------------

def _pareto_instance(seed):
    """A tie-heavy (value, latency, deadlines [N, D]) block."""
    rng = np.random.default_rng(seed)
    vals = (0.5, 1.0, 1.5, 2.0, 3.0)
    c, n, d = int(rng.integers(2, 13)), int(rng.integers(1, 5)), \
        int(rng.integers(1, 6))
    return (rng.choice(vals, size=(c, n)), rng.choice(vals, size=(c, n)),
            rng.choice(vals, size=(n, d)))


@pytest.mark.parametrize("seed", range(4))
def test_pareto_scores_equal_reference_and_oracles(seed):
    value, latency, deadlines = _pareto_instance(seed)
    norm = latency / latency.min(axis=0)
    for kw in ({}, dict(norm_latency=norm)):
        got = partition.batch_pareto_scores(value, latency, deadlines, **kw)
        want = ref_part.batch_pareto_scores(value, latency, deadlines, **kw,
                                            use_jax=False)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    _, _, best, best_net, net_front, chip_front = \
        partition.batch_pareto_scores(value, latency, deadlines)
    l_best, l_best_net = loop_pareto_scores(value, latency, deadlines)
    np.testing.assert_array_equal(best, l_best)
    np.testing.assert_array_equal(best_net, l_best_net)
    for j in range(value.shape[1]):
        np.testing.assert_array_equal(
            net_front[:, j], brute_frontier(value[:, j], latency[:, j]))
    np.testing.assert_array_equal(
        chip_front, brute_frontier(value.mean(axis=1), latency.mean(axis=1)))


def test_pareto_deadline_vector_broadcasts_like_reference():
    value = np.array([[1.0], [2.0]])
    lat = np.array([[5.0], [6.0]])
    got = partition.batch_pareto_scores(value, lat, np.array([1.0, 5.5]))
    want = ref_part.batch_pareto_scores(value, lat, np.array([1.0, 5.5]),
                                        use_jax=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].tolist() == [-1, 0]
