"""The port's own copy of the hardware-fault scenarios
(``repro_torch.ft.hw_faults``), held against ``repro.ft.hw_faults`` on the
reference's cases (``tests/test_resilience.py``'s hw_faults section):
every public function returns the same scenarios, grids, row maps and
counts, and raises the same errors.  Scenarios cross between the packages
as JSON (``scenario_to_json`` / ``scenario_from_json``), the wire format
both packages share.
"""

import numpy as np
import pytest

from repro.core import accelerator as ref_acc
from repro.ft import hw_faults as ref_hw
from repro_torch.core import convert
from repro_torch.ft import hw_faults as hw


@pytest.fixture(scope="module")
def grids():
    """(reference, port) of the reference tests' 18-point grid."""
    g = ref_acc.ConfigGrid.product(arrays=((16, 16), (32, 32), (64, 64)),
                                   gb_psum_kb=(13, 54, 216),
                                   gb_ifmap_kb=(27, 108))
    return g, convert.grid_from_fields(g.fields)


def _cross(scenario, to_mod):
    """A scenario of one package rebuilt in the other through JSON."""
    src = ref_hw if to_mod is hw else hw
    return to_mod.scenario_from_json(src.scenario_to_json(scenario))


def _json(scenarios, mod):
    return [mod.scenario_to_json(s) for s in scenarios]


def _assert_grids_equal(a, b):
    assert list(a.fields) == list(b.fields)
    for k in b.fields:
        np.testing.assert_array_equal(a.fields[k], b.fields[k], err_msg=k)


def _both_raise(call):
    """``call(mod)`` raises ValueError with one message in both packages."""
    msgs = []
    for mod in (hw, ref_hw):
        with pytest.raises(ValueError) as err:
            call(mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


BAD_EVENTS = {
    "core loss n=0": lambda m: m.CoreFailure(0, n=0),
    "disables nothing": lambda m: m.DegradedArray(0),
    "negative loss": lambda m: m.DegradedArray(0, rows_lost=-1, cols_lost=2),
    "unknown kind": lambda m: m.scenario_from_json(
        {"name": "x", "events": [{"kind": "Meteor", "type_idx": 0}]}),
}


@pytest.mark.parametrize("case", list(BAD_EVENTS))
def test_event_validation_matches_reference(case):
    _both_raise(BAD_EVENTS[case])


def test_events_and_keys_cross_as_json():
    scs = [hw.FaultScenario("a", (hw.CoreFailure(0),)),
           hw.FaultScenario("b", (hw.CoreFailure(1, n=2),
                                  hw.DegradedArray(0, rows_lost=1))),
           hw.FaultScenario("c", (hw.DegradedArray(2, cols_lost=3),))]
    for sc in scs:
        ref = _cross(sc, ref_hw)
        assert ref.key() == sc.key()
        assert ref_hw.scenario_to_json(ref) == hw.scenario_to_json(sc)
        back = _cross(ref, hw)
        assert back == sc and back.key() == sc.key()
    # the key ignores the name, as the reference's does
    assert scs[0].key() == hw.FaultScenario("z", (hw.CoreFailure(0),)).key()
    assert len({s.key() for s in scs}) == 3


def test_apply_counts_matches_reference():
    sc = hw.FaultScenario("s", (hw.CoreFailure(0, n=5), hw.CoreFailure(1)))
    got = hw.apply_counts([2, 3], sc)
    want = ref_hw.apply_counts([2, 3], _cross(sc, ref_hw))
    assert got.tolist() == want.tolist() == [0, 2]
    assert got.dtype == want.dtype
    bad = hw.FaultScenario("b", (hw.CoreFailure(7),))
    _both_raise(lambda m: m.apply_counts(
        [2, 3], bad if m is hw else _cross(bad, ref_hw)))


@pytest.mark.parametrize("loss", [(10_000, 3), (2, 2), (0, 4)])
def test_degrade_rows_matches_reference(grids, loss):
    got = hw.degrade_rows(grids[1], *loss)
    want = ref_hw.degrade_rows(grids[0], *loss)
    _assert_grids_equal(got, want)
    assert (got.fields["rows"] >= 1).all() and (got.fields["cols"] >= 1).all()


def _scenarios():
    return [hw.FaultScenario("loss0", (hw.CoreFailure(0),)),
            hw.FaultScenario("deg1", (hw.DegradedArray(1, rows_lost=2),)),
            hw.FaultScenario("deg1b", (hw.DegradedArray(1, rows_lost=2),)),
            hw.FaultScenario("both", (hw.CoreFailure(1),
                                      hw.DegradedArray(0, 1, 3)))]


@pytest.mark.parametrize("include_nominal", [True, False])
def test_expand_scenarios_matches_reference(grids, include_nominal):
    scs = _scenarios()
    got = hw.expand_scenarios(grids[1], [0, 5], [2, 1], scs,
                              include_nominal=include_nominal)
    want = ref_hw.expand_scenarios(grids[0], [0, 5], [2, 1],
                                   [_cross(s, ref_hw) for s in scs],
                                   include_nominal=include_nominal)
    assert got.names == want.names
    assert got.nominal_first == want.nominal_first == include_nominal
    assert (got.n_scenarios, got.n_types) == (want.n_scenarios, want.n_types)
    _assert_grids_equal(got.grid, want.grid)
    assert got.grid.n == 4          # 2 nominal rows + 2 distinct degraded
    for f in ("type_rows", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype


def test_expand_scenarios_errors_match_reference(grids):
    _both_raise(lambda m: m.expand_scenarios(
        grids[1] if m is hw else grids[0], [0, 1], [2], []))
    sc = hw.FaultScenario("d", (hw.DegradedArray(5, rows_lost=1),))
    _both_raise(lambda m: m.expand_scenarios(
        grids[1] if m is hw else grids[0], [0, 1], [2, 2],
        [sc if m is hw else _cross(sc, ref_hw)]))


def test_scenario_problems_matches_reference(grids):
    scs = _scenarios()
    got_b = hw.expand_scenarios(grids[1], [0, 5, 9], [2, 1, 1], scs)
    want_b = ref_hw.expand_scenarios(grids[0], [0, 5, 9], [2, 1, 1],
                                     [_cross(s, ref_hw) for s in scs])
    rng = np.random.default_rng(3)
    e_l = rng.uniform(1.0, 9.0, size=(got_b.grid.n, 2, 7))
    t_l = rng.uniform(1.0, 9.0, size=(got_b.grid.n, 2, 7))
    lens = np.array([7, 5])
    got = hw.scenario_problems(got_b, e_l, t_l, lens)
    want = ref_hw.scenario_problems(want_b, e_l, t_l, lens)
    assert got[0].shape == (5 * 2, 3, 7)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_generators_match_reference(grids):
    for counts in ([2, 0, 1], [1, 1], [0, 3, 0, 4]):
        assert _json(hw.all_single_core_failures(counts), hw) == \
            _json(ref_hw.all_single_core_failures(counts), ref_hw)
    for seed, n, frac in ((7, 6, 0.5), (8, 4, 0.5), (3, 5, 0.0),
                          (11, 3, 1.0)):
        got = hw.random_degradations(seed, grids[1], [0, 5], n_scenarios=n,
                                     max_frac=frac)
        want = ref_hw.random_degradations(seed, grids[0], [0, 5],
                                          n_scenarios=n, max_frac=frac)
        assert _json(got, hw) == _json(want, ref_hw)
        assert [s.key() for s in got] == [s.key() for s in want]
