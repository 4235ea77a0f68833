"""Heterogeneous multi-core chip scheme (§IV.A) and its per-layer
co-design with the layer schedule (§IV.A × §IV.B).

The PyTorch port of ``repro.core.hetero``:

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

:func:`co_design` goes one level deeper: instead of assigning each
network WHOLE to one core type, it searches candidate multi-core chips (a
type multiset drawn from a pool of near-optimal configurations) and
schedules every network's LAYERS over the chip's cores.  The pool comes
from one sweep (:func:`codesign_problems`) or one chunked
:func:`repro_torch.core.energymodel.stream_layer_topk` pass
(:func:`codesign_problems_streaming`), both through
:func:`_candidate_pool`; one ``per_layer=True`` engine call on the card
evaluates the pool, and one host call of
:func:`repro_torch.core.partition.batch_schedule_hetero` solves every
(chip × network) schedule.  :func:`score_codesign` with ``deadline=``
and :func:`pareto_codesign` put a latency bound on that block (the
energy-aware slack schedule of
:func:`repro_torch.core.partition.batch_slack_schedule`, the Pareto
scores of :func:`repro_torch.core.partition.batch_pareto_scores`), and
:func:`resilience_codesign` scores every chip under core losses and
degraded PE arrays (:mod:`repro_torch.ft.hw_faults`), the degraded pools
evaluated per layer on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from . import energymodel, partition
from ..ft import hw_faults
from .accelerator import GRID_COLUMNS, ConfigGrid
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


def _row_key(grid: ConfigGrid, i: int) -> Tuple[float, ...]:
    """Hashable config-row key of one grid point: two grid points with
    identical columns are the SAME core type, whatever their flat index."""
    return tuple(float(grid.fields[k][i]) for k in GRID_COLUMNS)


def _candidate_pool(cand: np.ndarray, rel: np.ndarray, pool_size: int,
                    ids: np.ndarray, key_fn) -> List[int]:
    """The pool builder of the co-design path, dense and streamed alike.

    ``cand``/``rel`` are [n_net, n_pts] over candidate point columns
    (``ids[c]`` is column ``c``'s flat grid index, ascending); the pool is
    the :func:`_greedy_cover` prefix of the boundary sets topped up with
    the best near-optimal points in (rel.min over networks, flat index)
    lex order.  Unknown ``rel`` entries are +inf (a streamed column
    outside a network's boundary/top-k sets): the cover never reads them
    and +inf can only push a column DOWN the top-up ranking, so dense and
    streamed pools cannot drift.  Points whose config row duplicates one
    already pooled (``key_fn(column)``) are skipped."""
    pool: List[int] = []
    seen: set = set()

    def add(c: int) -> None:
        key = key_fn(int(c))
        if key not in seen:
            seen.add(key)
            pool.append(int(ids[c]))

    cols, _, _ = _greedy_cover(cand, rel, pool_size)
    for c in cols:
        add(c)
    if len(pool) < pool_size:
        for c in np.lexsort((ids, rel.min(axis=0))):
            add(int(c))
            if len(pool) == pool_size:
                break
    return pool


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


# ---------------------------------------------------------------------------
# Batched per-layer co-design (§IV.A × §IV.B fused): which multi-core chip,
# and which layer→core schedule on it, for every network at once.  The
# sweep or stream and the pool's per-layer call run on the engine's device;
# the pool, the problem expansion, the solve and the scoring are host
# numpy, each closed by a stage mark (``energymodel._stage``).
# ---------------------------------------------------------------------------


def _compositions(n: int, k: int):
    """Positive integer k-tuples summing to n (core counts per type)."""
    if k == 1:
        yield (n,)
        return
    for first in range(1, n - k + 2):
        for rest in _compositions(n - first, k - 1):
            yield (first,) + rest


def _enumerate_chips(pool_size: int, max_types: int, m_cores: int
                     ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """All candidate chips: (pool positions, per-type core counts)."""
    chips = []
    for k in range(1, min(max_types, m_cores, pool_size) + 1):
        for combo in itertools.combinations(range(pool_size), k):
            for comp in _compositions(m_cores, k):
                chips.append((combo, comp))
    return chips


def _expand_pool_tensor(tensor: np.ndarray, chips, n_net: int,
                        t_max: int) -> np.ndarray:
    """[pool, n_net, L] per-layer pool tensor → the chip-major problem
    block [n_chips · n_net, t_max, L]: each chip's type rows gathered and
    laid out network-major within the chip (unused type slots stay 0).
    Both the solver latencies and the energy attribution go through THIS
    layout, so they cannot desynchronise."""
    n_layer = tensor.shape[2]
    n_chips = len(chips)
    tmap = np.zeros((n_chips, t_max), dtype=np.intp)
    tuse = np.zeros((n_chips, t_max), dtype=bool)
    for ci, (ty, _) in enumerate(chips):
        tmap[ci, :len(ty)] = ty
        tuse[ci, :len(ty)] = True
    out = np.where(tuse[:, :, None, None], tensor[tmap], 0.0)
    return out.transpose(0, 2, 1, 3).reshape(n_chips * n_net, t_max,
                                             n_layer)


@dataclasses.dataclass
class CoDesign:
    """Result of the batched chip + layer-schedule co-design search."""

    core_types: List[int]                 # winning chip: flat grid indices
    core_counts: List[int]                # cores per type (Σ == m_cores)
    schedules: Dict[str, "partition.HeteroSchedule"]   # per network
    energy: Dict[str, float]              # Σ per-layer energy as scheduled
    latency: Dict[str, float]             # pipeline bottleneck (ns)
    score: float                          # winning chip's mean norm. metric
    homogeneous_score: float              # best single-type chip's score
    metric: str
    m_cores: int
    pool: List[int]                       # candidate type pool (flat idx)
    chip_types: List[Tuple[int, ...]]     # every candidate: pool positions
    chip_counts: List[Tuple[int, ...]]
    chip_scores: np.ndarray               # [n_chips]

    @property
    def n_chips(self) -> int:
        return len(self.chip_types)

    def edp(self, name: str) -> float:
        return self.energy[name] * self.latency[name]

    def core_label(self, idx: int, grid: ConfigGrid) -> str:
        return grid.config_at(self.core_types[idx]).label()

    def summary(self, grid: ConfigGrid) -> str:
        parts = [f"{c}x {self.core_label(i, grid)}"
                 for i, c in enumerate(self.core_counts)]
        return " + ".join(parts)


@dataclasses.dataclass
class CoDesignProblems:
    """The materialised (chip × network) schedule problem set: steps 1–3
    of :func:`co_design` without the solve."""

    names: List[str]
    pool: List[int]                        # candidate types (flat idx)
    chips: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]  # (types, counts)
    lat_dense: np.ndarray                  # [B, t_max, n_layer] solver input
    n_layers_b: np.ndarray                 # [B] true lengths per problem
    counts: np.ndarray                     # [B, t_max]
    e_layer: np.ndarray                    # [pool, n_net, n_layer]
    t_layer: np.ndarray
    # per-network sweep minima, the chip-scoring references: reduced from
    # the dense sweep, or carried out of the stream's running reductions
    min_energy: np.ndarray                 # [n_net]
    min_latency: np.ndarray                # [n_net]
    min_edp: np.ndarray                    # [n_net]
    lens: np.ndarray                       # [n_net] true layer counts

    @property
    def n_problems(self) -> int:
        return int(self.lat_dense.shape[0])

    @property
    def lats(self) -> List[np.ndarray]:
        """Per-problem [n_types, n_layers] views (the scalar oracle's
        input format)."""
        return [self.lat_dense[i, :, :self.n_layers_b[i]]
                for i in range(self.n_problems)]


def _problems_from_pool(grid: ConfigGrid,
                        networks: Mapping[str, Sequence[Layer]],
                        pool: List[int], m_cores: int, max_types: int,
                        refs: Tuple[np.ndarray, np.ndarray, np.ndarray],
                        device, backend: str | None) -> CoDesignProblems:
    """Pool → problem set (steps 2–3 of :func:`co_design`): ONE
    ``per_layer=True`` engine call on the pool, on ``device`` and
    ``backend``, then the dense (chip candidate × network) solver
    tensors.  Shared by the dense and streaming constructors; only the
    pool discovery and the reference minima (``refs``) differ."""
    names = list(networks)
    n_net = len(names)
    e_l, t_l = energymodel.evaluate_networks(
        grid.take(pool), networks, device=device, backend=backend,
        per_layer=True)                                   # [P, n_net, L]
    lens = energymodel.network_layer_counts(networks)

    chips = _enumerate_chips(len(pool), max_types, m_cores)
    t_max = max(len(ty) for ty, _ in chips)
    lat_b = _expand_pool_tensor(t_l, chips, n_net, t_max)
    counts_b = np.zeros((len(chips) * n_net, t_max), dtype=np.int64)
    for ci, (ty, cn) in enumerate(chips):
        counts_b[ci * n_net:(ci + 1) * n_net, :len(cn)] = cn
    probs = CoDesignProblems(names=names, pool=pool, chips=chips,
                             lat_dense=lat_b,
                             n_layers_b=np.tile(lens, len(chips)),
                             counts=counts_b, e_layer=e_l, t_layer=t_l,
                             min_energy=np.asarray(refs[0], dtype=float),
                             min_latency=np.asarray(refs[1], dtype=float),
                             min_edp=np.asarray(refs[2], dtype=float),
                             lens=lens)
    energymodel._stage("problem expansion")
    return probs


def codesign_problems(grid: ConfigGrid,
                      networks: Mapping[str, Sequence[Layer]],
                      m_cores: int = 4,
                      *,
                      max_types: int = 3,
                      pool_size: int = 6,
                      bound: float = 0.05,
                      metric: str = "edp",
                      device=None,
                      backend: str | None = None) -> CoDesignProblems:
    """Build the co-design problem set: dense sweep → boundary-set pool →
    per-layer pool tensors → every (chip candidate × network) problem.
    ``device`` (default: the card; raises without one) and ``backend``
    act as in :func:`repro_torch.core.energymodel.evaluate_networks`."""
    e, t = energymodel.evaluate_networks(grid, networks, device=device,
                                         backend=backend)

    val = energymodel._metric_of(metric, e, t)            # [n, n_net]
    mins = val.min(axis=0)
    cand = (val <= mins[None, :] * (1.0 + bound)).T       # [n_net, n]
    rel = (val / mins[None, :]).T
    pool = _candidate_pool(cand, rel, min(pool_size, grid.n),
                           np.arange(grid.n),
                           lambda c: _row_key(grid, c))
    refs = (e.min(axis=0), t.min(axis=0), (e * t).min(axis=0))
    energymodel._stage("candidate pool")
    return _problems_from_pool(grid, networks, pool, m_cores, max_types,
                               refs, device, backend)


def codesign_problems_streaming(grid: ConfigGrid,
                                networks: Mapping[str, Sequence[Layer]],
                                m_cores: int = 4,
                                *,
                                max_types: int = 3,
                                pool_size: int = 6,
                                bound: float = 0.05,
                                metric: str = "edp",
                                device=None,
                                backend: str | None = None,
                                chunk_size: int = 2048,
                                topk: int | None = None,
                                stream: "energymodel.LayerTopK | None" = None,
                                resume_from=None,
                                on_chunk=None,
                                nan_guard: bool = True,
                                ) -> CoDesignProblems:
    """Streamed twin of :func:`codesign_problems`: the candidate pool and
    the scoring references come from ONE chunked
    :func:`repro_torch.core.energymodel.stream_layer_topk` pass (boundary
    sets + top-k + running minima), so the full ``[n_cfg, n_net]``
    matrices never exist and a 49,000-point mega grid feeds the pool at
    bounded memory.

    Reproduces the dense pool: the greedy cover only reads boundary-set
    points (all streamed), and the top-up ranking by ``rel.min`` over
    networks is covered by the per-network top-k.  A grid whose rows are
    DUPLICATED many times over can saturate a network's top-k with
    copies of one row, hiding distinct rows the dense top-up would reach;
    the function warns whenever a network's top-k holds fewer distinct
    config rows than the pool needs (pass a larger ``topk=`` then).
    Pass ``stream=`` to reuse an existing sweep (it must cover the same
    grid with the same bound/metric and ``topk ≥ pool_size``);
    ``resume_from`` / ``on_chunk`` / ``nan_guard`` forward to the stream
    (ignored when ``stream=`` is supplied)."""
    names = list(networks)
    n_net = len(names)
    if stream is None:
        stream = energymodel.stream_layer_topk(
            grid, networks, device=device, backend=backend,
            topk=max(int(pool_size if topk is None else topk), 1),
            bound=bound, metric=metric, chunk_size=chunk_size,
            resume_from=resume_from, on_chunk=on_chunk,
            nan_guard=nan_guard)
    if stream.n_cfg != grid.n:
        raise ValueError(
            f"stream was built over a {stream.n_cfg}-point grid but the "
            f"pool was requested on a {grid.n}-point one — its flat "
            "indices would be looked up against the wrong grid")
    if stream.bound is None:
        raise ValueError("stream must carry boundary sets — run "
                         "stream_layer_topk with bound=")
    if stream.bound != bound or stream.metric != metric:
        raise ValueError(
            "stream was built with (bound, metric)="
            f"({stream.bound}, {stream.metric!r}) but the pool was "
            f"requested with ({bound}, {metric!r}) — pass matching "
            "arguments, or rebuild the stream (the dense-equivalence "
            "contract holds only when they agree)")
    if stream.topk_idx.shape[0] < min(pool_size, grid.n):
        raise ValueError("stream top-k too small for the pool: need "
                         f"topk >= {min(pool_size, grid.n)}, got "
                         f"{stream.topk_idx.shape[0]}")

    # candidate columns: union of every boundary set and every top-k hit
    tk = stream.topk_idx[stream.topk_idx >= 0]
    pts = np.unique(np.concatenate(
        [stream.boundary_idx[nm] for nm in names] + [tk.ravel()]))
    cand = np.zeros((n_net, pts.size), dtype=bool)
    rel = np.full((n_net, pts.size), np.inf)
    for j, nm in enumerate(names):
        pos = np.searchsorted(pts, stream.boundary_idx[nm])
        cand[j, pos] = True
        rel[j, pos] = stream.boundary_metric(nm) / stream.min_metric[j]
        tkj = stream.topk_idx[:, j]
        valid = tkj >= 0
        pos = np.searchsorted(pts, tkj[valid])
        rel[j, pos] = np.minimum(
            rel[j, pos], stream.topk_metric[valid, j] / stream.min_metric[j])

    # the dense-equivalence argument needs each network's top-k to expose
    # its top-`pool_size` DISTINCT config rows; warn where it does not
    limit = min(pool_size, grid.n)
    for j in range(n_net):
        tkj = stream.topk_idx[:, j]
        keys = {_row_key(grid, int(i)) for i in tkj[tkj >= 0]}
        if len(keys) < limit:
            warnings.warn(
                f"network {names[j]!r}: top-{stream.topk_idx.shape[0]} "
                f"holds only {len(keys)} distinct config rows (< "
                f"{limit}): duplicated grid rows can saturate the "
                "streamed top-k with copies, so the pool may diverge "
                "from the dense codesign_problems pool — rebuild with "
                "a larger topk= to restore dense-pool equivalence",
                RuntimeWarning, stacklevel=2)
            break
    pool = _candidate_pool(cand, rel, limit, pts,
                           lambda c: _row_key(grid, int(pts[c])))
    refs = (stream.min_energy, stream.min_latency, stream.min_edp)
    energymodel._stage("candidate pool")
    return _problems_from_pool(grid, networks, pool, m_cores, max_types,
                               refs, device, backend)


def _solve(probs: CoDesignProblems) -> "partition.BatchHeteroResult":
    res = partition.batch_schedule_hetero(probs.lat_dense, probs.counts,
                                          n_layers=probs.n_layers_b)
    energymodel._stage("schedule solve")
    return res


def co_design(grid: ConfigGrid,
              networks: Mapping[str, Sequence[Layer]],
              m_cores: int = 4,
              *,
              max_types: int = 3,
              pool_size: int = 6,
              bound: float = 0.05,
              metric: str = "edp",
              device=None,
              backend: str | None = None) -> CoDesign:
    """Batched heterogeneous chip + per-layer schedule co-design (§IV).

    1. One dense sweep on ``device`` ranks every grid point per network;
       the candidate core-type POOL is the greedy-cover prefix of the
       ≤``bound`` boundary sets (the cover ``design_chip`` runs), topped
       up with the best near-optimal cells.
    2. ONE ``per_layer=True`` engine call evaluates the pool → the
       ``[pool, n_net, n_layer]`` per-layer energy/latency tensors.
    3. Every chip candidate — type subsets of the pool (≤ ``max_types``)
       × core-count compositions of ``m_cores`` — is scheduled for every
       network by ONE host call of ``partition.batch_schedule_hetero``
       over all (chip × network) problems.
    4. Chips are scored by the per-network scheduled metric (energy as
       assigned / pipeline bottleneck / their product for ``"edp"``),
       normalised by that network's sweep minimum and averaged; the
       arg-min chip wins and only ITS schedules are materialised.

    ``homogeneous_score`` is the best single-type candidate's score (the
    §IV.B baseline: ``m_cores`` identical cores)."""
    probs = codesign_problems(grid, networks, m_cores,
                              max_types=max_types, pool_size=pool_size,
                              bound=bound, metric=metric, device=device,
                              backend=backend)
    return score_codesign(probs, _solve(probs), metric=metric,
                          m_cores=m_cores)


def co_design_streaming(grid: ConfigGrid,
                        networks: Mapping[str, Sequence[Layer]],
                        m_cores: int = 4,
                        *,
                        max_types: int = 3,
                        pool_size: int = 6,
                        bound: float = 0.05,
                        metric: str = "edp",
                        device=None,
                        backend: str | None = None,
                        chunk_size: int = 2048,
                        topk: int | None = None,
                        stream: "energymodel.LayerTopK | None" = None,
                        ) -> CoDesign:
    """:func:`co_design` fed by the streaming engine: the candidate pool
    comes from ONE chunked ``energymodel.stream_layer_topk`` pass over
    ``grid`` instead of a dense sweep, so
    mega-scale spaces (``mega_grid()``, 49,000 points) co-design at
    bounded memory.  Steps 2–4 are the dense path's; where both fit, the
    streamed pool (and so the winning chip and every schedule) is the
    dense :func:`co_design`'s."""
    probs = codesign_problems_streaming(
        grid, networks, m_cores, max_types=max_types, pool_size=pool_size,
        bound=bound, metric=metric, device=device, backend=backend,
        chunk_size=chunk_size, topk=topk, stream=stream)
    return score_codesign(probs, _solve(probs), metric=metric,
                          m_cores=m_cores)


def _scheduled_energy(probs: CoDesignProblems,
                      res: "partition.BatchHeteroResult") -> np.ndarray:
    """[B] total energy of every problem as scheduled: the chip-major
    expansion the solver latencies used, then one gather over the
    assigned types."""
    n_net = len(probs.names)
    t_max = probs.counts.shape[1]
    n_layer = probs.e_layer.shape[2]
    en_b = _expand_pool_tensor(probs.e_layer, probs.chips, n_net, t_max)
    tt = res.layer_type[:, :n_layer]
    return np.take_along_axis(
        en_b, tt[:, None, :], axis=1)[:, 0, :].sum(-1)    # [B]


def score_codesign(probs: CoDesignProblems,
                   res: "partition.BatchHeteroResult",
                   *, metric: str = "edp", m_cores: int = 4,
                   deadline: float | None = None) -> CoDesign:
    """Step 4 of :func:`co_design`: fold a solved problem set into chip
    scores and materialise the winning chip's schedules.

    ``deadline`` (RELATIVE, in units of each network's sweep-minimum
    latency, like :class:`ParetoCoDesign`) switches every schedule to
    the energy-aware slack pass: layers migrate to lower-energy types as
    long as the pipeline still meets ``deadline · min_latency[net]``,
    chips that cannot meet it on every network score +inf, and the
    winner's materialised schedules are the slack ones.  Raises if NO
    chip meets the deadline on every network."""
    names, chips, pool = probs.names, probs.chips, probs.pool
    n_net, n_chips = len(names), len(chips)

    sl = None
    if deadline is None:
        bott = res.bottleneck.reshape(n_chips, n_net)
        energy = _scheduled_energy(probs, res).reshape(n_chips, n_net)
        feas_all = np.ones(n_chips, dtype=bool)
    else:
        t_max = probs.counts.shape[1]
        en_dense = _expand_pool_tensor(probs.e_layer, chips, n_net, t_max)
        dl_rows = np.tile(probs.min_latency * float(deadline),
                          n_chips)[:, None]               # [B, 1]
        sl = partition.batch_slack_schedule(
            probs.lat_dense, en_dense, probs.counts, dl_rows,
            n_layers=probs.n_layers_b, base=res)
        energymodel._stage("slack solve")
        bott = sl.bottleneck[:, 0].reshape(n_chips, n_net)
        energy = sl.energy[:, 0].reshape(n_chips, n_net)
        feas_all = sl.feasible[:, 0].reshape(n_chips, n_net).all(axis=1)
        if not feas_all.any():
            raise ValueError(
                f"no candidate chip meets deadline {deadline} x "
                "min_latency on every network — loosen the deadline")
    if metric == "energy":
        cell, ref = energy, probs.min_energy
    elif metric == "latency":
        cell, ref = bott, probs.min_latency
    else:
        cell, ref = energy * bott, probs.min_edp
    chip_scores = np.where(feas_all,
                           (cell / ref[None, :]).mean(axis=1), np.inf)
    best = int(np.argmin(chip_scores))
    homog = min(chip_scores[ci] for ci, (ty, _) in enumerate(chips)
                if len(ty) == 1)

    ty, cn = chips[best]
    schedules = {nm: (res.schedule(best * n_net + j) if sl is None
                      else sl.schedule(best * n_net + j, 0))
                 for j, nm in enumerate(names)}
    out = CoDesign(
        core_types=[pool[p] for p in ty],
        core_counts=list(cn),
        schedules=schedules,
        energy={nm: float(energy[best, j]) for j, nm in enumerate(names)},
        latency={nm: float(bott[best, j]) for j, nm in enumerate(names)},
        score=float(chip_scores[best]),
        homogeneous_score=float(homog),
        metric=metric, m_cores=m_cores, pool=pool,
        chip_types=[c[0] for c in chips],
        chip_counts=[c[1] for c in chips],
        chip_scores=chip_scores)
    energymodel._stage("scoring")
    return out


# ---------------------------------------------------------------------------
# Latency-bound Pareto co-design: the same solved (chip × network) problem
# block, scored against a whole DEADLINE AXIS at once.  A chip that wins on
# EDP may be useless under a deadline, and the cheapest deadline-feasible
# chip changes as the bound tightens.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParetoCoDesign:
    """Result of the batched latency-bound sweep (:func:`pareto_codesign`).

    ``deadlines`` are RELATIVE: deadline ``d`` for network ``j`` means a
    pipeline bottleneck of at most ``d · min_latency[j]`` (the network's
    best single-core latency from the sweep) — absolute bounds would be
    meaningless across networks whose latencies differ by orders of
    magnitude.  ``energy`` is normalised by each network's sweep-minimum
    energy, so chip scores are comparable across networks too."""

    names: List[str]
    deadlines: np.ndarray          # [D] in units of min_latency per net
    energy: np.ndarray             # [n_chips, n_net] scheduled energy (raw)
    latency: np.ndarray            # [n_chips, n_net] pipeline bottleneck
    norm_energy: np.ndarray        # [n_chips, n_net] / per-net min energy
    norm_latency: np.ndarray       # [n_chips, n_net] / per-net min latency
    scores: np.ndarray             # [n_chips, D] mean norm energy, +inf
    best_chip: np.ndarray          # [D] argmin chip (-1: none feasible)
    best_chip_net: np.ndarray      # [n_net, D] per-network best chip
    net_frontier: np.ndarray       # [n_chips, n_net] bool non-dominated
    chip_frontier: np.ndarray      # [n_chips] bool, network-mean plane
    pool: List[int]
    chip_types: List[Tuple[int, ...]]
    chip_counts: List[Tuple[int, ...]]
    # Energy-aware slack fields (pareto_codesign(slack=True); else None).
    # Each (chip, net, deadline) cell is the energy-greedy re-assignment
    # of partition.batch_slack_schedule — energy never above the
    # latency-only point, bottleneck never above the deadline.
    slack_energy: np.ndarray | None = None   # [n_chips, n_net, D] raw
    slack_latency: np.ndarray | None = None  # [n_chips, n_net, D]
    norm_slack_energy: np.ndarray | None = None  # / per-net min energy
    slack_scores: np.ndarray | None = None   # [n_chips, D] mean, +inf
    best_chip_slack: np.ndarray | None = None    # [D] argmin (-1: none)
    slack_moves: np.ndarray | None = None    # [n_chips, n_net, D]

    @property
    def n_chips(self) -> int:
        return len(self.chip_types)

    def slack_frontier(self, name: str,
                       deadline_index: int | None = None,
                       ) -> List[Tuple[int, float, float]]:
        """One network's non-dominated ``(chip, latency, energy)`` points
        over the UNION of the latency-only points and the slack points —
        the widened front.  Falls back to :meth:`frontier` when the sweep
        ran without ``slack=True``.

        With ``deadline_index`` the slack union is restricted to that one
        deadline column, making the answer a function of (problem, that
        deadline) only, whatever other deadlines shared the sweep.
        ``None`` keeps the all-deadlines union."""
        if self.slack_energy is None:
            return self.frontier(name)
        j = self.names.index(name)
        n_c = self.n_chips
        if deadline_index is None:
            cols = np.arange(self.slack_energy.shape[2])
        else:
            cols = np.array([int(deadline_index)])
        n_d = cols.size
        lat = np.concatenate([self.latency[:, j],
                              self.slack_latency[:, j, cols].ravel()])
        en = np.concatenate([self.energy[:, j],
                             self.slack_energy[:, j, cols].ravel()])
        chip = np.concatenate([np.arange(n_c),
                               np.repeat(np.arange(n_c), n_d)])
        ok = np.isfinite(lat) & np.isfinite(en)
        lat, en, chip = lat[ok], en[ok], chip[ok]
        dom = ((lat[None, :] <= lat[:, None]) & (en[None, :] <= en[:, None])
               & ((lat[None, :] < lat[:, None]) | (en[None, :] < en[:, None])))
        keep = np.flatnonzero(~dom.any(axis=1))
        pts = sorted({(float(lat[i]), float(en[i]), int(chip[i]))
                      for i in keep})
        return [(c, l, e) for l, e, c in pts]

    def frontier(self, name: str) -> List[Tuple[int, float, float]]:
        """One network's non-dominated ``(chip index, latency, energy)``
        points, fastest first."""
        j = self.names.index(name)
        idx = np.flatnonzero(self.net_frontier[:, j])
        order = np.lexsort((self.energy[idx, j], self.latency[idx, j]))
        return [(int(c), float(self.latency[c, j]), float(self.energy[c, j]))
                for c in idx[order]]

    def chip_summary(self, ci: int, grid: ConfigGrid) -> str:
        ty, cn = self.chip_types[ci], self.chip_counts[ci]
        return " + ".join(
            f"{c}x {grid.config_at(self.pool[p]).label()}"
            for p, c in zip(ty, cn))


def pareto_codesign(probs: CoDesignProblems,
                    res: "partition.BatchHeteroResult | None" = None,
                    *,
                    deadlines=None,
                    n_deadlines: int = 8,
                    points: Tuple[np.ndarray, np.ndarray] | None = None,
                    slack: bool = False) -> ParetoCoDesign:
    """Latency-bound Pareto sweep over a co-design problem set.

    One :func:`repro_torch.core.partition.batch_schedule_hetero` solve
    (reused via ``res=`` if the caller already has it) gives every
    (chip candidate × network) pair its scheduled (energy, bottleneck)
    point; ONE :func:`repro_torch.core.partition.batch_pareto_scores`
    call then scores every chip against EVERY deadline — infeasible
    schedules masked to +inf — and extracts the per-deadline winners
    plus both non-dominated (energy, latency) fronts.  No python loop
    over deadlines anywhere.  ``deadlines`` defaults to ``n_deadlines``
    points spanning the observed normalised-bottleneck range (so the
    tightest grid point is exactly reachable and the loosest admits
    every chip); the problem set may come from :func:`codesign_problems`
    or :func:`codesign_problems_streaming` — the sweep is agnostic.

    Re-sweeping the SAME problem set against a new deadline grid is the
    hot re-run path: pass ``points=(energy, latency)`` from a previous
    :class:`ParetoCoDesign` (both [n_chips, n_net], raw) and the solve
    and energy attribution are skipped entirely — only the deadline
    scoring runs (``slack=True`` still needs the solve, so it re-solves
    when ``res`` is absent).

    ``slack=True`` additionally runs the energy-aware deadline-slack
    pass (:func:`repro_torch.core.partition.batch_slack_schedule`) over
    the SAME (chip × network × deadline) axes in one more call and fills
    the ``slack_*`` fields: per-deadline energy-optimal points that
    weakly dominate the latency-only front (asserted — a slack point can
    never cost more energy than its base point, nor exceed its
    deadline)."""
    names = probs.names
    n_net, n_chips = len(names), len(probs.chips)
    if points is not None:
        energy = np.asarray(points[0], dtype=np.float64)
        lat = np.asarray(points[1], dtype=np.float64)
        if energy.shape != (n_chips, n_net):
            raise ValueError(f"points must be [{n_chips}, {n_net}], got "
                             f"{energy.shape}")
        if slack and res is None:
            res = _solve(probs)
    else:
        if res is None:
            res = _solve(probs)
        energy = _scheduled_energy(probs, res).reshape(n_chips, n_net)
        lat = res.bottleneck.reshape(n_chips, n_net)
    norm_e = energy / probs.min_energy[None, :]
    norm_l = lat / probs.min_latency[None, :]
    if deadlines is None:
        # tightest: the best chip's worst-network bottleneck (the first
        # deadline some chip meets for EVERY network); loosest: every
        # chip feasible everywhere.  Feasibility is re-checked in
        # ABSOLUTE space (min_latency · d), and the normalise→rescale
        # round trip can round 1 ulp below the defining latency — widen
        # both endpoints by a relative epsilon so the invariant survives
        deadlines = np.linspace(norm_l.max(axis=1).min(), norm_l.max(),
                                int(n_deadlines)) * (1.0 + 1e-12)
    deadlines = np.asarray(deadlines, dtype=np.float64)
    dl_abs = probs.min_latency[:, None] * deadlines[None, :]   # [N, D]

    _, scores, best, best_net, net_front, chip_front = \
        partition.batch_pareto_scores(norm_e, lat, dl_abs,
                                      norm_latency=norm_l)
    energymodel._stage("pareto scoring")

    slack_kw: Dict[str, np.ndarray] = {}
    if slack:
        t_max = probs.counts.shape[1]
        en_dense = _expand_pool_tensor(probs.e_layer, probs.chips, n_net,
                                       t_max)
        dl_prob = np.tile(dl_abs, (n_chips, 1))           # [B, D] rows
        sl = partition.batch_slack_schedule(
            probs.lat_dense, en_dense, probs.counts, dl_prob,
            n_layers=probs.n_layers_b, base=res)
        n_d = dl_prob.shape[1]
        s_en = sl.energy.reshape(n_chips, n_net, n_d)
        s_lat = sl.bottleneck.reshape(n_chips, n_net, n_d)
        s_feas = sl.feasible.reshape(n_chips, n_net, n_d)
        # guardrail (the frontier must WIDEN, never regress): each slack
        # point spends no more energy than its latency-only base point
        # (rtol: the sequential slack energy sum vs the pairwise base
        # attribution differ by ulps) and meets its deadline bit-exactly
        assert (s_en <= energy[:, :, None] * (1.0 + 1e-9)).all(), \
            "slack pass increased energy — dominance guardrail violated"
        assert np.where(s_feas, s_lat, 0.0).max() < np.inf and \
            (np.where(s_feas, s_lat, -np.inf)
             <= dl_abs[None, :, :]).all(), \
            "slack schedule exceeds its deadline — guardrail violated"
        norm_se = s_en / probs.min_energy[None, :, None]
        feas_all = s_feas.all(axis=1)                     # [n_chips, D]
        with np.errstate(invalid="ignore"):
            s_scores = np.where(feas_all, norm_se.mean(axis=1), np.inf)
        assert (s_scores <= scores * (1.0 + 1e-9)).all(), \
            "slack scores regressed vs latency-only scores"
        any_feas = np.isfinite(s_scores).any(axis=0)
        s_best = np.where(any_feas, np.argmin(s_scores, axis=0), -1)
        slack_kw = dict(
            slack_energy=s_en, slack_latency=s_lat,
            norm_slack_energy=norm_se, slack_scores=s_scores,
            best_chip_slack=s_best,
            slack_moves=sl.n_moves.reshape(n_chips, n_net, n_d))
        energymodel._stage("slack solve")

    return ParetoCoDesign(
        names=list(names), deadlines=deadlines,
        energy=energy, latency=lat,
        norm_energy=norm_e, norm_latency=norm_l,
        scores=scores, best_chip=best, best_chip_net=best_net,
        net_frontier=net_front, chip_frontier=chip_front,
        pool=probs.pool,
        chip_types=[c[0] for c in probs.chips],
        chip_counts=[c[1] for c in probs.chips],
        **slack_kw)


# ---------------------------------------------------------------------------
# Resilience-aware co-design: the same candidate-chip enumeration, scored by
# nominal metric AND by what happens when the hardware breaks.  Every chip ×
# network × fault-scenario re-schedule is solved by ONE
# batch_schedule_hetero(strict=False) call over a 4-D [B, S, T, L] block —
# scenario 0 is the fault-free chip, the rest are slot-parameterised faults
# (core loss / degraded PE arrays per type slot).  The degraded pools are
# evaluated per layer by the engine on its device; the solve is host numpy.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResilienceCoDesign:
    """Result of :func:`resilience_codesign`.

    Scores follow :func:`score_codesign`'s convention (per-network
    scheduled metric normalised by the sweep minimum, averaged over
    networks); ``+inf`` marks a scenario that killed every core of a
    chip (infeasible — reported, never raised).  The ``front`` is the
    weak-dominance front on the (nominal, worst-case) plane: it always
    contains the nominal-only winner, and typically also chips that give
    up a little nominal score for a much better worst case."""

    names: List[str]
    pool: List[int]
    chip_types: List[Tuple[int, ...]]
    chip_counts: List[Tuple[int, ...]]
    scenario_names: List[str]          # [S], "nominal" first
    degradations: List[Tuple[int, int]]
    valid: np.ndarray                  # [n_chips, S] scenario applies
    feasible: np.ndarray               # [n_chips, n_net, S]
    bottleneck: np.ndarray             # [n_chips, n_net, S] (+inf dead)
    energy: np.ndarray                 # [n_chips, n_net, S] (+inf dead)
    scores: np.ndarray                 # [n_chips, S] mean norm metric
    nominal_score: np.ndarray          # [n_chips] == scores[:, 0]
    worst_score: np.ndarray            # [n_chips] max over valid faults
    expected_score: np.ndarray         # [n_chips] mean over valid faults
    front: np.ndarray                  # [n_chips] bool (nominal, worst)
    best_nominal: int                  # argmin nominal_score
    best_robust: int                   # lexicographic (worst, nominal) min
    metric: str
    # deadline mode (resilience_codesign(deadline=...)): every cell above
    # reflects the ENERGY-AWARE slack schedule under that (relative)
    # deadline — feasible means "meets the deadline", energy is +inf
    # where it cannot, and slack_moves counts accepted energy moves
    deadline: float | None = None
    slack_moves: np.ndarray | None = None   # [n_chips, n_net, S]

    @property
    def n_chips(self) -> int:
        return len(self.chip_types)

    @property
    def worst_overhead(self) -> np.ndarray:
        """[n_chips] worst-case score relative to the chip's own nominal."""
        return self.worst_score / self.nominal_score

    def frontier(self) -> List[Tuple[int, float, float]]:
        """Front chips as ``(chip index, nominal, worst)``, best nominal
        first."""
        idx = np.flatnonzero(self.front)
        order = np.lexsort((self.worst_score[idx],
                            self.nominal_score[idx]))
        return [(int(c), float(self.nominal_score[c]),
                 float(self.worst_score[c])) for c in idx[order]]


def resilience_codesign(grid: ConfigGrid,
                        networks: Mapping[str, Sequence[Layer]],
                        m_cores: int = 4,
                        *,
                        max_types: int = 3,
                        pool_size: int = 6,
                        bound: float = 0.05,
                        metric: str = "edp",
                        device=None,
                        backend: str | None = None,
                        degradations: Sequence[Tuple[int, int]] = ((4, 4),),
                        probs: CoDesignProblems | None = None,
                        deadline: float | None = None,
                        ) -> ResilienceCoDesign:
    """Co-design under hardware faults: every candidate chip is scored by
    its nominal metric AND by its worst-case / expected metric when a
    core dies or a PE array degrades.

    The scenario set is slot-parameterised so all chips share one
    scenario axis: scenario 0 is nominal; then one whole-core-loss
    scenario per type slot (that slot's count decrements — a single-core
    single-type chip becomes INFEASIBLE, scored +inf); then, for each
    ``(rows_lost, cols_lost)`` in ``degradations``, one scenario per
    type slot where that slot's pool row is replaced by its degraded
    variant (shrunk ``rows``/``cols``, re-evaluated per layer by one
    ``per_layer=True`` engine call on ``device`` and ``backend`` — the
    layers re-balance onto the slower arrays).  Scenarios that name a
    slot a chip does not use are marked invalid for that chip and
    excluded from its worst/expected reductions.

    ONE ``batch_schedule_hetero(strict=False)`` call solves the whole
    ``[chips · networks, scenarios]`` block on the host; the returned
    :class:`ResilienceCoDesign` carries the (nominal, worst-case)
    weak-dominance front, which by construction contains the
    nominal-only winner (nothing can dominate it on the nominal axis).
    Pass ``probs=`` to reuse an existing problem set; it must come from
    this ``grid``/``networks``.  ``device`` (default: the card; raises
    without one) and ``backend`` act as in
    :func:`repro_torch.core.energymodel.evaluate_networks`.

    ``deadline`` (RELATIVE, x each network's sweep-minimum latency)
    switches every scenario cell to the energy-aware slack schedule of
    :func:`repro_torch.core.partition.batch_slack_schedule` — the energy
    the chip spends under each fault while still meeting the deadline;
    cells that cannot meet it are infeasible (+inf energy/score)."""
    if probs is None:
        probs = codesign_problems(grid, networks, m_cores,
                                  max_types=max_types, pool_size=pool_size,
                                  bound=bound, metric=metric,
                                  device=device, backend=backend)
    names, chips = probs.names, probs.chips
    n_net, n_chips = len(names), len(chips)
    B = n_chips * n_net
    t_max = probs.counts.shape[1]
    n_layer = probs.lat_dense.shape[2]
    degradations = [(int(r), int(c)) for r, c in degradations]
    n_deg = len(degradations)
    S = 1 + t_max * (1 + n_deg)

    lat4 = np.repeat(probs.lat_dense[:, None], S, axis=1)
    e4 = np.repeat(
        _expand_pool_tensor(probs.e_layer, chips, n_net,
                            t_max)[:, None], S, axis=1)
    counts4 = np.repeat(probs.counts[:, None], S, axis=1)

    scen_names = ["nominal"]
    n_used = np.asarray([len(ty) for ty, _ in chips])
    valid = np.zeros((n_chips, S), dtype=bool)
    slot_valid = (np.arange(t_max)[None, :] < n_used[:, None])
    for s in range(t_max):
        scen_names.append(f"core_loss@slot{s}")
        counts4[:, 1 + s, s] = np.maximum(counts4[:, 1 + s, s] - 1, 0)
        valid[:, 1 + s] = slot_valid[:, s]
    for di, (r, c) in enumerate(degradations):
        deg_grid = hw_faults.degrade_rows(grid.take(probs.pool), r, c)
        e_d, t_d = energymodel.evaluate_networks(
            deg_grid, networks, device=device, backend=backend,
            per_layer=True)
        lat_deg = _expand_pool_tensor(t_d, chips, n_net, t_max)
        en_deg = _expand_pool_tensor(e_d, chips, n_net, t_max)
        for s in range(t_max):
            sidx = 1 + t_max * (1 + di) + s
            scen_names.append(f"degrade_r{r}c{c}@slot{s}")
            lat4[:, sidx, s, :] = lat_deg[:, s, :]
            e4[:, sidx, s, :] = en_deg[:, s, :]
            valid[:, sidx] = slot_valid[:, s]
    energymodel._stage("degraded evaluation")

    labels = [f"{names[b % n_net]}@chip{b // n_net}:{scen_names[s]}"
              for b in range(B) for s in range(S)]
    res = partition.batch_schedule_hetero(
        lat4, counts4, n_layers=probs.n_layers_b, strict=False,
        labels=labels)
    energymodel._stage("scenario solve")

    slack_moves = None
    if deadline is None:
        tt = res.layer_type[:, :n_layer]
        energy = np.take_along_axis(
            e4.reshape(B * S, t_max, n_layer),
            tt[:, None, :], axis=1)[:, 0, :].sum(-1)
        feas = res.feasible.reshape(n_chips, n_net, S)
        bott = res.bottleneck.reshape(n_chips, n_net, S)
        energy = np.where(feas, energy.reshape(n_chips, n_net, S), np.inf)
    else:
        # per-row absolute deadline: flat row b·S + s belongs to network
        # (row // S) % n_net
        dl_rows = np.tile(np.repeat(probs.min_latency * float(deadline),
                                    S), n_chips)[:, None]
        sl = partition.batch_slack_schedule(
            lat4, e4, counts4, dl_rows, n_layers=probs.n_layers_b,
            base=res)
        energymodel._stage("slack solve")
        feas = sl.feasible[:, 0].reshape(n_chips, n_net, S)
        bott = sl.bottleneck[:, 0].reshape(n_chips, n_net, S)
        energy = np.where(feas, sl.energy[:, 0].reshape(n_chips, n_net, S),
                          np.inf)
        slack_moves = sl.n_moves[:, 0].reshape(n_chips, n_net, S)

    if metric == "energy":
        cell, ref = energy, probs.min_energy
    elif metric == "latency":
        cell, ref = np.where(feas, bott, np.inf), probs.min_latency
    else:
        cell, ref = energy * np.where(feas, bott, 1.0), probs.min_edp
    scores = (cell / ref[None, :, None]).mean(axis=1)       # [n_chips, S]

    fault = valid.copy()
    fault[:, 0] = False
    worst = np.where(fault, scores, -np.inf).max(axis=1)
    with np.errstate(invalid="ignore"):
        expected = (np.where(fault, scores, 0.0).sum(axis=1)
                    / np.maximum(fault.sum(axis=1), 1))
    nominal = scores[:, 0]

    a1, a2 = nominal[:, None], nominal[None, :]
    b1, b2 = worst[:, None], worst[None, :]
    dom = (a2 <= a1) & (b2 <= b1) & ((a2 < a1) | (b2 < b1))
    front = ~dom.any(axis=1)
    best_nominal = int(np.argmin(nominal))
    best_robust = int(np.lexsort((nominal, worst))[0])
    out = ResilienceCoDesign(
        names=list(names), pool=list(probs.pool),
        chip_types=[c[0] for c in chips],
        chip_counts=[c[1] for c in chips],
        scenario_names=scen_names, degradations=degradations,
        valid=valid, feasible=feas, bottleneck=bott, energy=energy,
        scores=scores, nominal_score=nominal, worst_score=worst,
        expected_score=expected, front=front,
        best_nominal=best_nominal, best_robust=best_robust,
        metric=metric,
        deadline=None if deadline is None else float(deadline),
        slack_moves=slack_moves)
    energymodel._stage("scoring")
    return out


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
