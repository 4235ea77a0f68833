"""Heterogeneous multi-core chip scheme (§IV.A).

The PyTorch port of the §IV.A part of ``repro.core.hetero``:

1.  For every network, evaluate the target metric (EDP by default) over the
    whole search space and keep every configuration within a boundary (5%)
    of that network's minimum → candidate sets (Table 5).
2.  Select a small number of *common* configurations such that the maximum
    number of networks runs near-optimally → the chip's core types (greedy
    set cover over the candidate sets).
3.  Every network is assigned to the core type that covers it (or, if none
    covers it within the boundary, the type with the least penalty).

``cross_penalty`` reproduces Table 6.  This is host-side numpy logic over
the ``[n_array, n_psum, n_ifmap]`` metric cubes that
:func:`repro_torch.core.dse.sweep_networks` computes on the card; it is
the reference's code, consuming the port's sweeps.
:func:`design_chip_streaming` runs the same cover over a streamed sweep's
boundary sets (:func:`repro_torch.core.dse.stream_grid`), so a mega grid
needs no full cubes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from . import energymodel
from .accelerator import ConfigGrid
from .dse import SweepResult, boundary_configs
from .topology import Layer

Cell = Tuple[int, int, int]     # (array_idx, psum_idx, ifmap_idx)


@dataclasses.dataclass
class HeteroChip:
    core_types: List[Cell]                    # chosen configurations
    assignment: Dict[str, int]                # network -> core-type index
    candidate_sets: Dict[str, List[Cell]]     # Table 5 per network
    sweeps: Dict[str, SweepResult]

    def core_label(self, idx: int) -> str:
        any_sweep = next(iter(self.sweeps.values()))
        return any_sweep.cell_label(self.core_types[idx])


def _greedy_cover(cand: np.ndarray, rel: np.ndarray, max_cores: int):
    """Greedy set cover over [n_net, n_pts] candidate masks.

    Each round picks the point covering the most uncovered networks (ties
    → lower total relative metric across covered networks, then lower
    point index).  Returns (selected point columns, {net row → core
    index}, uncovered mask)."""
    uncovered = np.ones(cand.shape[0], dtype=bool)
    cols: List[int] = []
    assign: Dict[int, int] = {}
    while uncovered.any() and len(cols) < max_cores:
        counts = cand[uncovered].sum(axis=0)
        best_count = counts.max() if counts.size else 0
        if best_count == 0:
            break
        rel_sum = np.where(cand[uncovered], rel[uncovered], 0.0).sum(axis=0)
        tied = np.flatnonzero(counts == best_count)
        col = int(tied[np.argmin(rel_sum[tied])])

        idx = len(cols)
        cols.append(col)
        covered_now = cand[:, col] & uncovered
        for i in np.flatnonzero(covered_now):
            assign[int(i)] = idx
        uncovered &= ~covered_now
    return cols, assign, uncovered


def design_chip(sweeps: Dict[str, SweepResult], bound: float = 0.05,
                metric: str = "edp", max_cores: int = 4) -> HeteroChip:
    """Greedy common-configuration cover → heterogeneous core types.

    The per-network metric cubes are flattened into a [n_net, n_points]
    matrix once, and each greedy round is a handful of masked reductions.
    """
    names = list(sweeps)
    candidates = {name: boundary_configs(sweeps[name], bound, metric)
                  for name in names}

    mats = np.stack([sweeps[n].metric(metric).ravel() for n in names])
    shape = next(iter(sweeps.values())).metric(metric).shape
    mins = mats.min(axis=1, keepdims=True)
    cand = mats <= mins * (1.0 + bound)           # [n_net, n_pts] bool
    rel = mats / mins                             # metric / per-net minimum

    core_flat, assign, uncovered = _greedy_cover(cand, rel, max_cores)
    assignment = {names[i]: idx for i, idx in assign.items()}

    core_types: List[Cell] = [
        tuple(int(x) for x in np.unravel_index(c, shape)) for c in core_flat]

    # Networks not covered within the boundary: assign to the least-penalty
    # existing core type.
    if uncovered.any() and core_flat:
        vals = mats[:, core_flat]                 # [n_net, n_cores]
        best = np.argmin(vals, axis=1)
        for i in np.flatnonzero(uncovered):
            assignment[names[i]] = int(best[i])

    return HeteroChip(core_types=core_types, assignment=assignment,
                      candidate_sets=candidates, sweeps=sweeps)


@dataclasses.dataclass
class StreamChip:
    """Heterogeneous chip designed from a streamed sweep: core types are
    FLAT grid indices (mega grids are not 3-D cubes)."""

    core_types: List[int]
    assignment: Dict[str, int]                # network -> core-type index
    candidate_sets: Dict[str, List[int]]      # flat indices, best first
    stream: "energymodel.StreamResult"

    def core_label(self, idx: int, grid: ConfigGrid) -> str:
        return grid.config_at(self.core_types[idx]).label()

    def core_cells(self, shape: Tuple[int, ...]) -> List[Cell]:
        """Unravel the flat core indices onto a sweep cube shape."""
        return [tuple(int(x) for x in np.unravel_index(c, shape))
                for c in self.core_types]


def design_chip_streaming(stream: "energymodel.StreamResult",
                          grid: ConfigGrid,
                          networks: Mapping[str, Sequence[Layer]],
                          max_cores: int = 4) -> StreamChip:
    """Greedy cover over a StreamResult's boundary sets — no full cubes.

    Reproduces :func:`design_chip`'s choices: any point that can cover a
    network lies in that network's boundary set, so the greedy needs only
    the union of the streamed candidate sets.  Networks left uncovered
    are assigned by evaluating just the chosen core cells (a
    ≤max_cores-point grid) on the stream's device and backend.
    """
    names = list(stream.networks)
    union = np.unique(np.concatenate(
        [stream.boundary_idx[nm] for nm in names]))
    cand = np.zeros((len(names), union.size), dtype=bool)
    rel = np.zeros((len(names), union.size))
    for i, nm in enumerate(names):
        pos = np.searchsorted(union, stream.boundary_idx[nm])
        cand[i, pos] = True
        rel[i, pos] = stream.boundary_metric(nm) / stream.min_metric[i]

    cols, assign, uncovered = _greedy_cover(cand, rel, max_cores)
    core_flat = [int(union[c]) for c in cols]
    assignment = {names[i]: idx for i, idx in assign.items()}

    if uncovered.any() and core_flat:
        e, t = energymodel.evaluate_networks(
            grid.take(core_flat), {nm: networks[nm] for nm in names},
            device=stream.device, backend=stream.backend)
        vals = energymodel._metric_of(stream.metric, e, t).T
        best = np.argmin(vals, axis=1)
        for i in np.flatnonzero(uncovered):
            assignment[names[i]] = int(best[i])

    candidate_sets = {nm: [int(c) for c in stream.boundary_idx[nm]]
                      for nm in names}
    return StreamChip(core_types=core_flat, assignment=assignment,
                      candidate_sets=candidate_sets, stream=stream)


def cross_penalty(chip: HeteroChip, network: str, other_core: int
                  ) -> Dict[str, float]:
    """Table 6: Δ_E, Δ_D, Δ_EDP (%) of running ``network`` on a
    non-corresponding core type instead of its own."""
    sw = chip.sweeps[network]
    own = chip.core_types[chip.assignment[network]]
    oth = chip.core_types[other_core]
    d_e = (sw.energy[oth] - sw.energy[own]) / sw.energy[own] * 100.0
    d_d = (sw.latency[oth] - sw.latency[own]) / sw.latency[own] * 100.0
    d_edp = (sw.edp[oth] - sw.edp[own]) / sw.edp[own] * 100.0
    return dict(dE=float(d_e), dD=float(d_d), dEDP=float(d_edp))


def savings_summary(chip: HeteroChip) -> Dict[str, Dict[str, float]]:
    """Per-network savings of the heterogeneous assignment vs. the worst
    single-core-type choice (the paper's headline: up to 36% energy / 67%
    EDP saved by running on the near-optimal core)."""
    names = list(chip.assignment)
    shape = next(iter(chip.sweeps.values())).energy.shape
    core_flat = np.ravel_multi_index(
        np.asarray(chip.core_types, dtype=np.intp).T, shape)
    energy = np.stack([chip.sweeps[n].energy.ravel()[core_flat]
                       for n in names])            # [n_net, n_cores]
    edp = np.stack([chip.sweeps[n].edp.ravel()[core_flat] for n in names])
    own = np.asarray([chip.assignment[n] for n in names], dtype=np.intp)
    rows = np.arange(len(names))
    worst_e, worst_edp = energy.max(axis=1), edp.max(axis=1)
    e_saved = (worst_e - energy[rows, own]) / worst_e * 100.0
    edp_saved = (worst_edp - edp[rows, own]) / worst_edp * 100.0
    return {n: dict(energy_saved=float(e_saved[i]),
                    edp_saved=float(edp_saved[i]))
            for i, n in enumerate(names)}
