"""Model parallelism over a chip's cores (§IV.B, Algorithm II).

The PyTorch port of ``repro.core.partition`` up to the heterogeneous
schedule (the deadline-slack and Pareto solvers are not ported yet).  A
network's layers are distributed *contiguously* over k identical cores
forming a pipeline through off-chip DRAM (Fig. 11).  The pipeline latency
is the maximum per-core latency; the speedup of eq. (6) is

    speedup = sum(latencies) / max(core latency).

``bb_partition`` is the paper's branch-and-bound, ``dp_partition`` an exact
oracle (linear-partition DP), ``brute_force_partition`` enumerates all
splits, and ``batch_partition`` solves every (network × core-count) split
at once by bisection on the bottleneck with a greedy feasibility check over
prefix sums (the reference's numpy body), bit-exact against
``dp_partition``.  ``batch_schedule_hetero`` generalises it to chips of
several core types: every layer on its fastest available type, each
type's layers split over its cores, every (chip, network) problem in one
call, bit-exact against ``schedule_hetero_oracle``.  All of it is
host-side numpy over the layer latencies the port's engine computes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous layer → core assignment."""

    boundaries: Tuple[int, ...]   # start index of each core's slice
    loads: Tuple[float, ...]      # per-core total latency
    pipeline_latency: float       # max(loads)
    speedup: float                # eq. (6)
    n_layers: int = 0

    @property
    def n_cores(self) -> int:
        return len(self.loads)

    def table_row(self) -> List[Tuple[int, int]]:
        """(l_initial, n_C) tuples, 1-indexed like Tables 7–8."""
        bounds = list(self.boundaries) + [self.n_layers]
        return [(bounds[i] + 1, bounds[i + 1] - bounds[i])
                for i in range(len(self.boundaries))]


def _mk_partition(lat: Sequence[float], bounds: Sequence[int]) -> Partition:
    lat = np.asarray(lat, dtype=np.float64)
    prefix = np.concatenate([[0.0], np.cumsum(lat)])
    starts = np.asarray(bounds, dtype=np.intp)
    ends = np.concatenate([starts[1:], [lat.size]])
    loads = prefix[ends] - prefix[starts]        # O(k), not O(k·n)
    total = float(prefix[-1])
    pipe = float(loads.max())
    return Partition(boundaries=tuple(int(b) for b in starts),
                     loads=tuple(float(x) for x in loads),
                     pipeline_latency=pipe,
                     speedup=total / pipe if pipe > 0 else float("inf"),
                     n_layers=int(lat.size))


def bb_partition(latencies: Sequence[float], n_cores: int) -> Partition:
    """Algorithm II: branch-and-bound layer distribution."""
    lat = [float(x) for x in latencies]
    n = len(lat)
    if n_cores <= 1 or n <= n_cores:
        bounds = list(range(min(n, n_cores)))
        return _mk_partition(lat, bounds)

    total = sum(lat)
    avg = total / n_cores
    suffix = np.concatenate([np.cumsum(lat[::-1])[::-1], [0.0]])

    best = {"pipe": float("inf"), "bounds": None}

    def rec(i: int, cores_left: int, cur_max: float, bounds: List[int]):
        # Assign layers [i:] to the remaining cores; bounds holds the start
        # index of every core opened so far.
        if cur_max >= best["pipe"]:
            return                      # bound condition
        if cores_left == 1:
            seg = float(suffix[i])
            pipe = max(cur_max, seg)
            if pipe < best["pipe"]:
                best["pipe"] = pipe
                best["bounds"] = bounds + [i]
            return
        # accumulate from layer i until the running sum crosses the average
        s = 0.0
        j = i
        while j < n - (cores_left - 1) and s + lat[j] < avg:
            s += lat[j]
            j += 1
        j = min(j, n - (cores_left - 1))
        # branch 1: include the crossing layer (segment sum ≥ avg)
        hi = min(j + 1, n - (cores_left - 1))
        s_hi = float(sum(lat[i:hi]))
        rec(hi, cores_left - 1, max(cur_max, s_hi), bounds + [i])
        # branch 2: exclude it (segment sum < avg)
        if j > i and j != hi:
            s_lo = float(sum(lat[i:j]))
            rec(j, cores_left - 1, max(cur_max, s_lo), bounds + [i])

    rec(0, n_cores, 0.0, [])
    if best["bounds"] is None:
        raise RuntimeError("bb_partition found no split")
    return _mk_partition(lat, best["bounds"])


def dp_partition(latencies: Sequence[float], n_cores: int) -> Partition:
    """Exact minimal-bottleneck contiguous partition (DP oracle)."""
    lat = [float(x) for x in latencies]
    n = len(lat)
    k = min(n_cores, n) if n else 1
    prefix = np.concatenate([[0.0], np.cumsum(lat)])

    # dp[c][i] = minimal pipeline latency splitting lat[:i] into c cores;
    # argmin keeps the first minimum (strict-improvement tie-breaking).
    NEG = float("inf")
    dp = np.full((k + 1, n + 1), NEG)
    cut = np.zeros((k + 1, n + 1), dtype=int)
    dp[0][0] = 0.0
    for c in range(1, k + 1):
        prev = dp[c - 1]
        for i in range(c, n + 1):
            j0 = c - 1
            cand = np.maximum(prev[j0:i], prefix[i] - prefix[j0:i])
            bj = int(np.argmin(cand))
            dp[c][i] = cand[bj]
            cut[c][i] = j0 + bj
    bounds: List[int] = []
    i = n
    for c in range(k, 0, -1):
        j = int(cut[c][i])
        bounds.append(j)
        i = j
    bounds.reverse()
    return _mk_partition(lat, bounds)


def brute_force_partition(latencies: Sequence[float], n_cores: int
                          ) -> Partition:
    """Enumerate every contiguous split (tests only; exponential)."""
    lat = [float(x) for x in latencies]
    n = len(lat)
    k = min(n_cores, n)
    best = None
    for cuts in itertools.combinations(range(1, n), k - 1):
        bounds = [0] + list(cuts)
        p = _mk_partition(lat, bounds)
        if best is None or p.pipeline_latency < best.pipeline_latency:
            best = p
    return best if best is not None else _mk_partition(lat, [0])


#: Bisection steps: the initial bracket is at most ~one bottleneck wide
#: (see the lb/hi seeding in batch_partition), so 56 halvings push the
#: bracket below one ulp of the optimum — the greedy segmentation at the
#: upper end then lands on it exactly.
_BISECT_ITERS = 56


def _row_searchsorted(P: np.ndarray, net: np.ndarray, pos: np.ndarray,
                      thr: np.ndarray) -> np.ndarray:
    """Per-row maximal jump: largest j with P[net, j] − P[net, pos] ≤ thr.

    ``P`` rows are non-decreasing (prefix sums padded with +inf), so the
    predicate is monotone in j and a batched binary search finds the last
    true position.  Comparisons subtract prefixes — the exact arithmetic of
    the DP oracle — rather than pre-adding ``thr`` to the base."""
    base = P[net, pos]
    lo = pos.copy()                       # predicate holds at pos (0 ≤ thr)
    hi = np.full_like(pos, P.shape[1] - 1)
    steps = int(np.ceil(np.log2(P.shape[1]))) + 1
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        ok = P[net, mid] - base <= thr
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid - 1)
    return lo


def _batch_greedy(P: np.ndarray, net: np.ndarray, n_arr: np.ndarray,
                  thr: np.ndarray, kk: np.ndarray, k_max: int,
                  exact: bool):
    """Greedy maximal-jump segmentation at threshold ``thr`` for every row.

    ``exact=False``: feasibility — True where ≤ kk segments cover all
    layers with every segment sum ≤ thr.  ``exact=True``: returns the
    [rows, k_max] start indices of an exactly-kk segmentation (each of the
    remaining segments is guaranteed ≥ 1 layer), valid when thr ≥ T*.
    """
    rows = net.shape[0]
    pos = np.zeros(rows, dtype=np.intp)
    viol = np.zeros(rows, dtype=bool)
    starts = np.full((rows, k_max), 0, dtype=np.intp) if exact else None
    for s in range(k_max):
        active = (s < kk) & (pos < n_arr)
        j = _row_searchsorted(P, net, pos, thr)
        if exact:
            rem = kk - s                      # segments still to open
            j = np.minimum(j, n_arr - np.maximum(rem - 1, 0))
        j = np.maximum(j, pos + 1)            # force progress …
        j = np.minimum(j, n_arr)              # … but stay in bounds
        viol |= active & (P[net, j] - P[net, pos] > thr)
        if exact:
            starts[:, s] = np.where(s < kk, np.minimum(pos, n_arr), n_arr)
        pos = np.where(active, j, pos)
    if exact:
        return starts
    return (pos >= n_arr) & ~viol


def batch_partition(latencies: Sequence[Sequence[float]],
                    n_cores: Sequence[int] | int,
                    ) -> List[Dict[int, Partition]]:
    """Solve every (network, k) minimal-bottleneck split in one call.

    ``latencies`` is a sequence of per-network layer-latency sequences and
    ``n_cores`` an int or sequence of core counts; returns one
    ``{k: Partition}`` dict per network.  Pipeline latencies are exactly
    ``dp_partition``'s (same prefix-difference arithmetic): the
    ``_BISECT_ITERS``-step bisection shrinks the bracket below one ulp of
    the optimum, so the greedy segmentation at the upper bracket lands on
    it exactly.
    """
    lats = [np.asarray(l, dtype=np.float64) for l in latencies]
    ks = ((int(n_cores),) if isinstance(n_cores, (int, np.integer))
          else tuple(int(k) for k in n_cores))
    if not lats or not ks:
        return [dict() for _ in lats]
    n_lens = np.array([l.size for l in lats], dtype=np.int64)
    n_max = int(n_lens.max())
    n_net = len(lats)

    P = np.full((n_net, n_max + 1), np.inf)
    mx = np.zeros(n_net)
    for i, l in enumerate(lats):
        P[i, 0] = 0.0
        P[i, 1:l.size + 1] = np.cumsum(l)
        mx[i] = l.max() if l.size else 0.0

    # one row per (network, requested k), clamped like dp_partition
    net = np.repeat(np.arange(n_net, dtype=np.int64), len(ks))
    k_req = np.tile(np.asarray(ks, dtype=np.int64), n_net)
    kk = np.minimum(np.maximum(k_req, 1), np.maximum(n_lens[net], 1))
    k_max = int(kk.max())
    n_arr = n_lens[net]
    n_rows = net.size

    total = P[net, n_arr]
    # Tight initial bracket: any bottleneck is ≥ max(max layer, total/k),
    # and the greedy bound gives T* ≤ total/k + max layer.  The tiny
    # relative slack absorbs the rounding of the bound itself.
    lb = np.maximum(mx[net], total / np.maximum(kk, 1))
    lo = np.nextafter(lb, -np.inf)
    hi = np.minimum(total, (total / np.maximum(kk, 1) + mx[net])
                    * (1.0 + 1e-12))

    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        feas = _batch_greedy(P, net, n_arr, mid, kk, k_max, exact=False)
        hi = np.where(feas, mid, hi)
        lo = np.where(feas, lo, mid)
    starts = _batch_greedy(P, net, n_arr, hi, kk, k_max, exact=True)

    ends = np.concatenate([starts[:, 1:],
                           np.full((n_rows, 1), 0, np.int64)], axis=1)
    ends[:, -1] = n_arr
    ends = np.minimum(np.maximum(ends, starts), n_arr[:, None])
    loads_all = (P[net[:, None], ends] - P[net[:, None], starts]).tolist()
    starts_l = starts.tolist()
    totals = total.tolist()
    out: List[Dict[int, Partition]] = [dict() for _ in lats]
    for r in range(n_rows):
        i, k, kr = int(net[r]), int(k_req[r]), int(kk[r])
        loads = loads_all[r][:kr]
        pipe = max(loads)
        out[i][k] = Partition(
            boundaries=tuple(starts_l[r][:kr]), loads=tuple(loads),
            pipeline_latency=pipe,
            speedup=totals[r] / pipe if pipe > 0 else float("inf"),
            n_layers=int(n_lens[i]))
    return out


def partition_network(report, n_cores: int, method: str = "bb") -> Partition:
    """Distribute a simulated network (NetworkReport) across cores."""
    lat = report.layer_latencies
    fn = {"bb": bb_partition, "dp": dp_partition,
          "brute": brute_force_partition}[method]
    return fn(lat, n_cores)


# ---------------------------------------------------------------------------
# Heterogeneous layer→core scheduling: batch_partition generalised beyond
# same-type cores.  A problem is a (chip, network) pair — per-layer
# latencies on every core TYPE plus a core count per type.  The schedule:
#
# 1. **per-layer argmin** — each layer runs on the available type that
#    executes it fastest (ties → lower type index);
# 2. **per-core-count balancing** — each type's layer subsequence is split
#    contiguously over that type's cores; the pipeline bottleneck is the
#    max core load across ALL types, so feasibility of a bottleneck T is
#    the AND of the per-type greedy coverings.
#
# Masked prefix sums make stage 2 exact: a type's costs are written onto
# the FULL layer axis (other types' slots are 0.0 — adding zero is exact
# in fp), so segment sums are the same prefix differences dp_partition
# computes on the compacted subsequence, and the final bottleneck is
# bit-identical to max_t dp_partition(subseq_t, counts_t) — the oracle.
# The whole solve is host numpy: its exactness rests on numpy's
# sequential cumsum and first-minimum argmin, which a device scan and a
# device argmin do not promise.
# ---------------------------------------------------------------------------

#: Least width of ``BatchHeteroResult.starts``' segment axis (the
#: reference's jitted unroll); wider where a type has more segments.
_K_MAX = 8


@dataclasses.dataclass(frozen=True)
class HeteroSchedule:
    """One network's layer→core schedule on a heterogeneous chip."""

    types: Tuple[int, ...]        # core → type index (type-major order)
    layer_type: Tuple[int, ...]   # layer → type index (per-layer argmin)
    layer_core: Tuple[int, ...]   # layer → global core id
    loads: Tuple[float, ...]      # per-core latency sums (idle cores 0.0)
    bottleneck: float             # pipeline latency = max(loads)
    speedup: float                # Σ assigned layer latency / bottleneck
    n_layers: int

    @property
    def n_cores(self) -> int:
        return len(self.types)


@dataclasses.dataclass(frozen=True)
class BatchHeteroResult:
    """Array-level output of :func:`batch_schedule_hetero` (B problems);
    :meth:`schedule` materialises a :class:`HeteroSchedule` on demand."""

    counts: np.ndarray            # [B, T] cores per type (as requested)
    n_layers: np.ndarray          # [B]
    layer_type: np.ndarray        # [B, L_pad] per-layer argmin type
    starts: np.ndarray            # [B, T, k_max] full-axis segment starts
    seg_counts: np.ndarray        # [B, T] segments actually opened
    loads: np.ndarray             # [B, T, k_max] per-segment latency sums
    bottleneck: np.ndarray        # [B] (+inf: infeasible, strict=False)
    total: np.ndarray             # [B] Σ assigned layer latency
    feasible: np.ndarray | None = None   # [B] False → no core available
    labels: Tuple[str, ...] | None = None   # per-problem names for errors

    def __len__(self) -> int:
        return int(self.bottleneck.shape[0])

    @property
    def speedup(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.bottleneck > 0,
                            self.total / self.bottleneck, np.inf)

    def schedule(self, i: int) -> HeteroSchedule:
        if self.feasible is not None and not self.feasible[i]:
            lab = (self.labels[i] if self.labels is not None
                   else f"problem {i}")
            raise ValueError(
                f"{lab}: infeasible — every core type has count 0 (the "
                "fault scenario killed the whole chip); bottleneck is "
                "+inf and no schedule exists")
        n_t = self.counts.shape[1]
        L = int(self.n_layers[i])
        tt = self.layer_type[i, :L]
        counts = self.counts[i]
        core_off = np.concatenate([[0], np.cumsum(counts)])
        types = tuple(int(t) for t in np.repeat(np.arange(n_t), counts))
        loads = np.zeros(int(core_off[-1]))
        layer_core = np.zeros(L, dtype=np.intp)
        for t in range(n_t):
            if counts[t] == 0:
                continue
            kk = int(self.seg_counts[i, t])
            st = self.starts[i, t, :kk]
            ends = np.concatenate([st[1:], [L]])
            lt = np.flatnonzero(tt == t)
            if lt.size:
                layer_core[lt] = core_off[t] + np.searchsorted(
                    ends, lt, side="right")
            loads[core_off[t]:core_off[t] + kk] = self.loads[i, t, :kk]
        bott = float(self.bottleneck[i])
        total = float(self.total[i])
        return HeteroSchedule(
            types=types, layer_type=tuple(int(t) for t in tt),
            layer_core=tuple(int(c) for c in layer_core),
            loads=tuple(float(x) for x in loads),
            bottleneck=bott,
            speedup=total / bott if bott > 0 else float("inf"),
            n_layers=L)

    def schedules(self) -> List[HeteroSchedule]:
        return [self.schedule(i) for i in range(len(self))]


def schedule_hetero_oracle(latencies, counts) -> Dict[str, Any]:
    """Scalar reference for ONE (chip, network) problem.

    ``latencies``: [n_types, n_layers] per-layer latency on each core
    type; ``counts``: [n_types] cores per type.  Per-layer argmin over
    the available types, then ``dp_partition`` per type's subsequence —
    the exact semantics ``batch_schedule_hetero`` batches."""
    lat = np.asarray(latencies, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.int64)
    n_types, n_layers = lat.shape
    if counts.shape[0] > n_types:        # zero-padded type slots are fine
        if (counts[n_types:] > 0).any():
            raise ValueError("counts for more types than latency rows")
        counts = counts[:n_types]
    if n_layers == 0:
        raise ValueError("schedule_hetero_oracle needs ≥ 1 layer")
    if not (counts > 0).any():
        raise ValueError("schedule_hetero_oracle needs ≥ 1 core")
    cost = np.where((counts > 0)[:, None], lat, np.inf)
    tt = np.argmin(cost, axis=0)
    bottleneck = 0.0
    for t in range(n_types):
        sub = lat[t, tt == t]
        if counts[t] <= 0 or sub.size == 0:
            continue
        p = dp_partition(sub, int(counts[t]))
        bottleneck = max(bottleneck, p.pipeline_latency)
    total = float(lat[tt, np.arange(n_layers)].sum())
    return dict(bottleneck=bottleneck, layer_type=tt, total=total,
                speedup=total / bottleneck if bottleneck > 0
                else float("inf"))


def _flatten_scenarios(latencies, counts, n_layers):
    """A dense ``[B, S, T, L]`` block → ``[B·S, T, L]`` problems,
    scenario-minor, with ``counts`` (``[B, S, T]``, ``[B, T]`` or ``[T]``)
    and ``n_layers`` (``[B]`` or ``[B, S]``) flattened to match."""
    b0, n_s = latencies.shape[:2]
    latencies = latencies.reshape(b0 * n_s, *latencies.shape[2:])
    cnts_in = np.asarray(counts)
    if cnts_in.ndim == 3:
        counts = cnts_in.reshape(b0 * n_s, cnts_in.shape[2])
    elif cnts_in.ndim == 2:
        counts = np.repeat(cnts_in, n_s, axis=0)
    if n_layers is not None:
        nl = np.asarray(n_layers, dtype=np.int64)
        n_layers = (np.repeat(nl, n_s) if nl.ndim == 1
                    else nl.reshape(b0 * n_s))
    return latencies, counts, n_layers


def _empty_hetero_result() -> BatchHeteroResult:
    return BatchHeteroResult(
        counts=np.zeros((0, 0), np.int64), n_layers=np.zeros(0, np.int64),
        layer_type=np.zeros((0, 0), np.int64),
        starts=np.zeros((0, 0, _K_MAX), np.int64),
        seg_counts=np.zeros((0, 0), np.int64),
        loads=np.zeros((0, 0, _K_MAX)), bottleneck=np.zeros(0),
        total=np.zeros(0), feasible=np.zeros(0, bool))


def _per_layer_starts(starts_r, sel, tt, valid_l, n_types, kk_r):
    """Closed form of the kk == n_t rows ``sel`` (one layer a segment):
    each segment starts at the next of the type's layer positions."""
    type_mask = ((tt[:, None, :] == np.arange(n_types)[None, :, None])
                 & valid_l[:, None, :]).reshape(starts_r.shape[0], -1)
    sub = type_mask[sel]
    occ = np.cumsum(sub, axis=1)
    for s in range(int(kk_r[sel].max())):
        hit = sub & (occ == s + 1)
        pos = np.argmax(hit, axis=1)
        has = hit.any(axis=1)
        starts_r[np.flatnonzero(sel)[has], s] = pos[has]


def _two_segment_cuts(P, net_h, n_h):
    """Closed form of the kk == 2 rows: with A_j = P[j] (non-decreasing)
    and B_j = P[n] − P[j] (non-increasing), T* = min_j max(A_j, B_j) sits
    at the crossing A_j ≤ B_j — a vectorised binary search a row, then
    the better of the two cuts around it (ties → the first)."""
    tot_h = P[net_h, n_h]
    lo_j = np.ones(net_h.size, dtype=np.int64)
    hi_j = np.maximum(n_h - 1, 1)
    steps = int(np.ceil(np.log2(P.shape[1]))) + 1
    for _ in range(steps):
        mid = (lo_j + hi_j + 1) >> 1
        ok = P[net_h, mid] <= tot_h - P[net_h, mid]
        lo_j = np.where(ok, mid, lo_j)
        hi_j = np.where(ok, hi_j, mid - 1)
    j0 = np.clip(lo_j, 1, np.maximum(n_h - 1, 1))
    j1 = np.clip(lo_j + 1, 1, np.maximum(n_h - 1, 1))
    m0 = np.maximum(P[net_h, j0], tot_h - P[net_h, j0])
    m1 = np.maximum(P[net_h, j1], tot_h - P[net_h, j1])
    return np.where(m0 <= m1, j0, j1)


def batch_schedule_hetero(latencies, counts, n_layers=None, *,
                          strict: bool = True,
                          labels=None) -> BatchHeteroResult:
    """Solve every heterogeneous (chip, network) schedule in one call.

    ``latencies``: one ``[n_types, n_layers]`` per-layer latency matrix
    per problem — a sequence of such, or ONE dense ``[B, T, L]`` float64
    array (the engine's ``per_layer=True`` tensors gathered per chip).
    ``counts``: the matching per-type core counts (``[T]`` per problem,
    or ``[B, T]``).  With a dense array, ``n_layers`` gives each
    problem's true layer count (default: the full ``L``) — entries past
    it are ignored.  Types with count 0 (padding slots) never receive
    layers.  Bottlenecks are exactly :func:`schedule_hetero_oracle`'s
    (same prefix-difference arithmetic, ulp-tight bisection).

    **Fault-scenario axis.**  A dense ``[B, S, T, L]`` array adds a
    scenario axis, flattened scenario-minor to ``B·S`` problems;
    ``counts`` may then be ``[B, S, T]``, ``[B, T]`` or ``[T]`` and
    ``n_layers`` ``[B]`` or ``[B, S]``.  Problem ``b``'s scenario ``s``
    is flat row ``b·S + s`` of the result.

    **Infeasibility.**  ``strict=True`` raises when any problem's counts
    are all zero.  ``strict=False`` reports such problems instead:
    ``bottleneck`` is +inf, ``feasible`` is False, and
    :meth:`BatchHeteroResult.schedule` raises naming the problem via
    ``labels`` (one string per flattened problem row).
    """
    if isinstance(latencies, np.ndarray) and latencies.ndim == 4:
        latencies, counts, n_layers = _flatten_scenarios(
            latencies, counts, n_layers)
    dense = isinstance(latencies, np.ndarray) and latencies.ndim == 3
    if dense:
        n_b, in_types, n_max = latencies.shape
        n_lens = (np.full(n_b, n_max, dtype=np.int64) if n_layers is None
                  else np.asarray(n_layers, dtype=np.int64))
    else:
        lats = [np.asarray(l, dtype=np.float64) for l in latencies]
        n_b = len(lats)
        in_types = max((l.shape[0] for l in lats), default=0)
        n_lens = np.array([l.shape[1] for l in lats], dtype=np.int64)
        n_max = int(n_lens.max()) if n_b else 0
    cnts = np.asarray(counts)
    if cnts.ndim == 1:
        cnts = np.broadcast_to(cnts, (n_b, cnts.shape[0]))
    cnts = cnts.astype(np.int64)
    if n_b == 0:
        return _empty_hetero_result()
    if cnts.shape[0] != n_b:
        raise ValueError(f"counts rows {cnts.shape[0]} != problems {n_b}")
    if labels is not None:
        labels = tuple(str(x) for x in labels)
        if len(labels) != n_b:
            raise ValueError(
                f"labels has {len(labels)} entries for {n_b} problems")
    n_types = max(in_types, cnts.shape[1])
    if (n_lens == 0).any():
        raise ValueError("every problem needs ≥ 1 layer")
    # a positive count for a type slot beyond a problem's latency rows
    # would hand every layer to a phantom zero-latency type
    prob_types = (np.asarray([l.shape[0] for l in lats], dtype=np.int64)
                  if not dense else np.full(n_b, in_types, np.int64))
    ghost = np.arange(cnts.shape[1])[None, :] >= prob_types[:, None]
    if (cnts * ghost).any():
        raise ValueError("counts for more types than latency rows")

    lat = np.zeros((n_b, n_types, n_max))
    if dense:
        lat[:, :in_types] = latencies
    else:
        for i, l in enumerate(lats):
            lat[i, :l.shape[0], :l.shape[1]] = l
    counts_p = np.zeros((n_b, n_types), dtype=np.int64)
    counts_p[:, :cnts.shape[1]] = cnts
    avail = counts_p > 0
    feas_b = avail.any(axis=1)
    if not feas_b.all():
        if strict:
            raise ValueError(
                "every problem needs ≥ 1 core (counts all zero); pass "
                "strict=False to report per-problem infeasibility instead")
        # all-types-dead problems solve as single-core rows, then report
        # +inf below; the rest of the batch is unaffected
        avail[np.flatnonzero(~feas_b), 0] = True

    # stage 1: per-layer argmin over the available types + masked
    # per-type prefix sums
    valid_l = np.arange(n_max)[None, :] < n_lens[:, None]     # [B, L]
    cost = np.where(avail[:, :, None], lat, np.inf)
    tt = np.argmin(cost, axis=1)                              # [B, L]
    tt = np.where(valid_l, tt, 0)
    tmask = ((tt[:, None, :] == np.arange(n_types)[None, :, None])
             & valid_l[:, None, :])
    masked = np.where(tmask, lat, 0.0)
    n_t = tmask.sum(axis=-1)                                  # layers/type
    mx = masked.max(axis=-1)                                  # [B, T]
    cum = np.cumsum(masked, axis=-1)                          # [B, T, L]
    pref = np.where(valid_l[:, None, :], cum, np.inf)
    rows = n_b * n_types
    P = np.full((rows, n_max + 1), np.inf)
    P[:, 0] = 0.0
    P[:, 1:] = pref.reshape(rows, n_max)
    kk = np.where(n_t > 0, np.minimum(counts_p, np.maximum(n_t, 1)), 1)
    kk = np.maximum(kk, 1)
    total_t = P[np.arange(rows),
                np.repeat(n_lens, n_types)].reshape(n_b, n_types)

    # Per-(problem, type) solves: the bottleneck is the MAX of the
    # independent per-type optima, so every row runs its own search.
    # Three row classes are closed form:
    #   kk == 1     → one segment: T* = total_t, starts = [0, …]
    #   kk == n_t   → one layer per segment: starts = the type's layers
    #   kk == 2     → the crossing of the two segment sums
    # and the rest (2 < kk < n_t) bisect on the bottleneck.
    net_r = np.arange(rows, dtype=np.int64)
    n_arr_r = np.repeat(n_lens, n_types)
    kk_r = kk.reshape(rows)
    n_t_r = n_t.reshape(rows)
    k_out = max(_K_MAX, int(kk_r.max()))
    starts_r = np.broadcast_to(n_arr_r[:, None], (rows, k_out)).copy()

    single = kk_r == 1
    starts_r[single, 0] = 0

    per_layer_rows = (~single) & (kk_r == n_t_r)
    if per_layer_rows.any():
        _per_layer_starts(starts_r, per_layer_rows, tt, valid_l, n_types,
                          kk_r)

    halves = np.flatnonzero(~single & ~per_layer_rows & (kk_r == 2))
    if halves.size:
        starts_r[halves, 0] = 0
        starts_r[halves, 1] = _two_segment_cuts(P, net_r[halves],
                                                n_arr_r[halves])

    need = np.flatnonzero(~single & ~per_layer_rows & (kk_r > 2))
    if need.size:
        lb = np.maximum(mx, total_t / kk).reshape(-1)[need]
        lo_b = np.nextafter(lb, -np.inf)
        hi_b = ((total_t / kk + mx).reshape(-1)[need]) * (1.0 + 1e-12)
        net_n, n_arr_n, kk_n = net_r[need], n_arr_r[need], kk_r[need]
        k_mx = int(kk_n.max())
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo_b + hi_b)
            feas = _batch_greedy(P, net_n, n_arr_n, mid, kk_n, k_mx,
                                 exact=False)
            hi_b = np.where(feas, mid, hi_b)
            lo_b = np.where(feas, lo_b, mid)
        st = _batch_greedy(P, net_n, n_arr_n, hi_b, kk_n, k_mx, exact=True)
        starts_r[need, :st.shape[1]] = st

    ends_r = np.concatenate(
        [starts_r[:, 1:], np.zeros((rows, 1), starts_r.dtype)], axis=1)
    ends_r[:, -1] = n_arr_r
    ends_r = np.minimum(np.maximum(ends_r, starts_r), n_arr_r[:, None])
    loads_r = P[net_r[:, None], ends_r] - P[net_r[:, None], starts_r]
    loads_r = np.where(np.isfinite(loads_r), loads_r, 0.0)

    loads = loads_r.reshape(n_b, n_types, k_out)
    bottleneck = loads.max(axis=(1, 2))
    if not feas_b.all():
        loads = np.where(feas_b[:, None, None], loads, 0.0)
        bottleneck = np.where(feas_b, bottleneck, np.inf)
    return BatchHeteroResult(
        counts=np.asarray(cnts), n_layers=n_lens, layer_type=tt,
        starts=starts_r.reshape(n_b, n_types, k_out),
        seg_counts=kk, loads=loads, bottleneck=bottleneck,
        total=total_t.sum(axis=1), feasible=feas_b.copy(), labels=labels)
