"""Declarative hardware-fault scenarios for the modeled chip.

The port's own copy of ``repro.ft.hw_faults`` (numpy and the port's
``ConfigGrid`` only).  Array-based accelerators lose whole cores and
individual PE rows/columns (SCALE-Sim models exactly the ``rows × cols``
geometry ``GRID_COLUMNS`` carries), and re-mapping a network's layers
across the survivors is a scheduling problem, not a restart — so a fault
scenario is declared as data and handed to the same batched solver that
placed the layers in the first place:

* :class:`CoreFailure` — a core type loses ``n`` whole cores (its count
  decrements, clamped at 0; a chip whose every count hits 0 is reported
  *infeasible*, not an error — ``batch_schedule_hetero(strict=False)``);
* :class:`DegradedArray` — ``k`` disabled PE rows/columns ⇒ the SAME
  config row with a shrunk ``rows``/``cols`` column (clamped at 1; a
  fully-dead array is a :class:`CoreFailure`, declare it as one).

:func:`expand_scenarios` turns a chip (flat grid rows + per-type core
counts) and a scenario list into a :class:`ScenarioBatch`: one union
:class:`~repro_torch.core.accelerator.ConfigGrid` of nominal + degraded
type rows (deduped), a ``[n_scenario, n_types]`` row map into it, and the
``[n_scenario, n_types]`` surviving counts — i.e. a ``[n_scenario]``
batch of perturbed (counts, grid-rows) instances that ONE
``per_layer=True`` engine call and ONE batched schedule solve consume
(:func:`scenario_problems` builds the solver tensors in the scenario-
major / network-minor layout the co-design stack uses everywhere).

Seeded generators — :func:`all_single_core_failures` (the exhaustive
"what if core type t loses a core" sweep) and
:func:`random_degradations` (reproducible random PE-row/column loss) —
keep fault sweeps deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np

from ..core.accelerator import ConfigGrid

FaultEvent = Union["CoreFailure", "DegradedArray"]


@dataclasses.dataclass(frozen=True)
class CoreFailure:
    """Whole-core loss: core type ``type_idx`` loses ``n`` cores."""

    type_idx: int
    n: int = 1

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"CoreFailure.n must be >= 1, got {self.n}")


@dataclasses.dataclass(frozen=True)
class DegradedArray:
    """``rows_lost`` PE rows / ``cols_lost`` PE columns of core type
    ``type_idx`` are disabled — the type's config row shrinks (never
    below a 1×1 array: a fully-dead array is a :class:`CoreFailure`)."""

    type_idx: int
    rows_lost: int = 0
    cols_lost: int = 0

    def __post_init__(self):
        if self.rows_lost < 0 or self.cols_lost < 0:
            raise ValueError("DegradedArray losses must be >= 0")
        if self.rows_lost == 0 and self.cols_lost == 0:
            raise ValueError("DegradedArray must disable >= 1 row or col")


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """A named set of simultaneous hardware faults on one chip."""

    name: str
    events: Tuple[FaultEvent, ...]

    def key(self) -> tuple:
        """Hashable identity (the service's re-schedule cache key)."""
        return tuple(
            (type(e).__name__,) + dataclasses.astuple(e)
            for e in self.events)


def scenario_to_json(scenario: FaultScenario) -> dict:
    """Plain-JSON form of a scenario (the request journal's wire format)."""
    return {
        "name": scenario.name,
        "events": [
            dict(kind=type(e).__name__, **dataclasses.asdict(e))
            for e in scenario.events
        ],
    }


def scenario_from_json(obj: dict) -> FaultScenario:
    """Inverse of :func:`scenario_to_json`; round-trips :meth:`key`."""
    events: List[FaultEvent] = []
    for ev in obj["events"]:
        ev = dict(ev)
        kind = ev.pop("kind")
        if kind == "CoreFailure":
            events.append(CoreFailure(**ev))
        elif kind == "DegradedArray":
            events.append(DegradedArray(**ev))
        else:
            raise ValueError(f"unknown fault-event kind {kind!r}")
    return FaultScenario(name=obj["name"], events=tuple(events))


def apply_counts(counts: Sequence[int], scenario: FaultScenario
                 ) -> np.ndarray:
    """Surviving per-type core counts under ``scenario`` (clamped at 0)."""
    out = np.asarray(counts, dtype=np.int64).copy()
    for ev in scenario.events:
        if not 0 <= ev.type_idx < out.shape[0]:
            raise ValueError(
                f"scenario {scenario.name!r}: type_idx {ev.type_idx} out "
                f"of range for a {out.shape[0]}-type chip")
        if isinstance(ev, CoreFailure):
            out[ev.type_idx] = max(int(out[ev.type_idx]) - ev.n, 0)
    return out


def degrade_rows(grid: ConfigGrid, rows_lost: int, cols_lost: int
                 ) -> ConfigGrid:
    """Every row of ``grid`` with ``rows_lost``/``cols_lost`` PEs
    disabled: the ``rows``/``cols`` columns shrink, clamped at 1."""
    f = grid.fields
    return grid.with_columns(
        rows=np.maximum(f["rows"] - rows_lost, 1.0),
        cols=np.maximum(f["cols"] - cols_lost, 1.0))


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """A chip expanded into a ``[n_scenario]`` batch of perturbed
    (counts, grid-rows) instances over ONE union grid."""

    names: Tuple[str, ...]         # scenario names (nominal first if kept)
    grid: ConfigGrid               # nominal type rows + degraded variants
    type_rows: np.ndarray          # [S, T] row into grid per (scen, type)
    counts: np.ndarray             # [S, T] surviving cores
    nominal_first: bool            # row 0 is the fault-free chip

    @property
    def n_scenarios(self) -> int:
        return len(self.names)

    @property
    def n_types(self) -> int:
        return int(self.type_rows.shape[1])


def expand_scenarios(grid: ConfigGrid, chip_types: Sequence[int],
                     chip_counts: Sequence[int],
                     scenarios: Sequence[FaultScenario],
                     *, include_nominal: bool = True) -> ScenarioBatch:
    """Chip × scenario list → the batched (counts, grid-rows) instances.

    ``chip_types`` are flat rows of ``grid`` (the co-design result
    format), ``chip_counts`` the matching core counts.  Degraded rows are
    deduped on their full config-row columns, so two scenarios degrading
    the same type the same way share one union row (and one engine
    evaluation)."""
    chip_types = [int(c) for c in chip_types]
    n_t = len(chip_types)
    if len(chip_counts) != n_t:
        raise ValueError(f"{n_t} chip types but {len(chip_counts)} counts")
    nominal = grid.take(chip_types)
    union = [nominal]
    row_keys = {tuple(float(nominal.fields[k][t])
                      for k in sorted(nominal.fields)): t
                for t in range(n_t)}
    next_row = n_t

    names: List[str] = []
    rows_l: List[np.ndarray] = []
    counts_l: List[np.ndarray] = []
    if include_nominal:
        names.append("nominal")
        rows_l.append(np.arange(n_t, dtype=np.intp))
        counts_l.append(np.asarray(chip_counts, dtype=np.int64))
    for sc in scenarios:
        rows = np.arange(n_t, dtype=np.intp)
        for ev in sc.events:
            if isinstance(ev, DegradedArray):
                if not 0 <= ev.type_idx < n_t:
                    raise ValueError(
                        f"scenario {sc.name!r}: type_idx {ev.type_idx} "
                        f"out of range for a {n_t}-type chip")
                deg = degrade_rows(nominal.take([ev.type_idx]),
                                   ev.rows_lost, ev.cols_lost)
                key = tuple(float(deg.fields[k][0])
                            for k in sorted(deg.fields))
                if key not in row_keys:
                    row_keys[key] = next_row
                    union.append(deg)
                    next_row += 1
                rows = rows.copy()
                rows[ev.type_idx] = row_keys[key]
        names.append(sc.name)
        rows_l.append(rows)
        counts_l.append(apply_counts(chip_counts, sc))
    return ScenarioBatch(
        names=tuple(names), grid=ConfigGrid.concat(union),
        type_rows=np.stack(rows_l) if rows_l else
        np.zeros((0, n_t), np.intp),
        counts=np.stack(counts_l) if counts_l else
        np.zeros((0, n_t), np.int64),
        nominal_first=include_nominal)


def scenario_problems(batch: ScenarioBatch, e_layer: np.ndarray,
                      t_layer: np.ndarray, lens: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Solver tensors for one expanded chip, scenario-major network-minor
    (the co-design stack's chip-major layout with scenarios as chips).

    ``e_layer``/``t_layer`` are the union grid's ``per_layer=True``
    outputs ``[batch.grid.n, n_net, L]``; ``lens`` the true per-network
    layer counts.  Returns ``(lat [S·n_net, T, L], counts [S·n_net, T],
    n_layers [S·n_net], energy [S·n_net, T, L])`` — ready for ONE
    ``batch_schedule_hetero(strict=False)`` call (problem ``s·n_net + j``
    is scenario ``s`` × network ``j``)."""
    S, T = batch.type_rows.shape
    n_net, L = t_layer.shape[1], t_layer.shape[2]
    lat = t_layer[batch.type_rows]           # [S, T, n_net, L]
    en = e_layer[batch.type_rows]
    lat = lat.transpose(0, 2, 1, 3).reshape(S * n_net, T, L)
    en = en.transpose(0, 2, 1, 3).reshape(S * n_net, T, L)
    counts = np.repeat(batch.counts, n_net, axis=0)
    n_layers = np.tile(np.asarray(lens, dtype=np.int64), S)
    return lat, counts, n_layers, en


def all_single_core_failures(counts: Sequence[int],
                             ) -> List[FaultScenario]:
    """One scenario per populated core type: that type loses one core —
    the exhaustive first-order whole-core fault sweep."""
    return [FaultScenario(name=f"core_loss_t{t}",
                          events=(CoreFailure(type_idx=t),))
            for t, c in enumerate(counts) if int(c) > 0]


def random_degradations(seed: int, grid: ConfigGrid,
                        chip_types: Sequence[int], *,
                        n_scenarios: int = 4,
                        max_frac: float = 0.5) -> List[FaultScenario]:
    """``n_scenarios`` reproducible degraded-array scenarios: each picks
    one chip type and disables a seeded-random number of PE rows and/or
    columns, at most ``max_frac`` of the type's array in each dimension
    (and always ≥ 1 PE line total, never the whole array)."""
    rng = np.random.default_rng(seed)
    chip_types = [int(c) for c in chip_types]
    out: List[FaultScenario] = []
    for i in range(int(n_scenarios)):
        t = int(rng.integers(len(chip_types)))
        rows = int(grid.fields["rows"][chip_types[t]])
        cols = int(grid.fields["cols"][chip_types[t]])
        max_r = max(int(rows * max_frac), 0)
        max_c = max(int(cols * max_frac), 0)
        r = int(rng.integers(0, max_r + 1))
        c = int(rng.integers(0, max_c + 1))
        if r == 0 and c == 0:
            r = 1 if max_r else 0
            c = 0 if max_r else 1
        out.append(FaultScenario(
            name=f"degrade_s{seed}_{i}_t{t}_r{r}c{c}",
            events=(DegradedArray(type_idx=t, rows_lost=r, cols_lost=c),)))
    return out
