"""Model parallelism over a chip's cores (§IV.B, Algorithm II).

The PyTorch port of ``repro.core.partition``.  A network's layers are
distributed *contiguously* over k identical cores forming a pipeline
through off-chip DRAM (Fig. 11).  The pipeline latency
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
call, bit-exact against ``schedule_hetero_oracle``.
``batch_slack_schedule`` then spends a deadline's slack on energy: layers
move to lower-energy types while the pipeline still meets the deadline,
every (problem × deadline) cell in one call, bit-exact against
``slack_schedule_oracle``; ``batch_pareto_scores`` scores a solved
(chip × network) block against a whole deadline axis.  All of it is
host-side numpy over the layer tensors the port's engine computes.
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


# ---------------------------------------------------------------------------
# Latency-bound Pareto scoring: a solved (chip × network) block gives every
# (chip, network) pair a scheduled (energy, latency) point; under a latency
# bound the score of a chip is its energy *subject to* the pipeline
# bottleneck meeting the deadline — infeasible schedules mask to +inf, so
# per-deadline argmins and the whole (chips × networks × deadlines) score
# block come out of one numpy pass, with no python loop over deadlines.
# The (energy, latency) dominance masks (the Pareto fronts) ride along.
# ---------------------------------------------------------------------------


def _pareto_body(value, latency, norm_latency, deadlines):
    """``value``/``latency``/``norm_latency``: [C, N] per-(chip, network)
    score (normalised energy by convention), raw pipeline bottleneck, and
    normalised bottleneck; ``deadlines``: [N, D] absolute per-network
    latency bounds.  Returns

    * ``masked``  [C, N, D] — ``value`` where the schedule meets the
      deadline, +inf where it misses,
    * ``scores``  [C, D]   — per-chip mean over networks (one infeasible
      network poisons the chip: +inf propagates through the mean),
    * ``best``    [D]      — argmin chip per deadline (-1: none feasible),
    * ``best_net`` [N, D]  — per-network argmin chip per deadline,
    * ``net_front`` [C, N] — non-dominated (value, latency) chips per
      network (weak dominance: a point falls only to another that is ≤ in
      both coordinates and < in at least one),
    * ``chip_front`` [C]   — non-dominated chips on the network-mean
      (value, norm_latency) plane."""
    feas = latency[:, :, None] <= deadlines[None, :, :]
    masked = np.where(feas, value[:, :, None], np.inf)
    scores = masked.mean(axis=1)                              # [C, D]
    best = np.where(np.isfinite(scores).any(axis=0),
                    np.argmin(scores, axis=0), -1)
    best_net = np.where(np.isfinite(masked).any(axis=0),
                        np.argmin(masked, axis=0), -1)        # [N, D]

    e1, e2 = value[:, None, :], value[None, :, :]
    l1, l2 = latency[:, None, :], latency[None, :, :]
    dom = (e2 <= e1) & (l2 <= l1) & ((e2 < e1) | (l2 < l1))
    net_front = ~dom.any(axis=1)                              # [C, N]

    mv, ml = value.mean(axis=1), norm_latency.mean(axis=1)
    domc = ((mv[None, :] <= mv[:, None]) & (ml[None, :] <= ml[:, None])
            & ((mv[None, :] < mv[:, None]) | (ml[None, :] < ml[:, None])))
    chip_front = ~domc.any(axis=1)                            # [C]
    return masked, scores, best, best_net, net_front, chip_front


def batch_pareto_scores(value, latency, deadlines, norm_latency=None):
    """Score a solved (chip × network) block against ALL deadlines at once.

    ``value``/``latency`` are [C, N] (scheduled score — normalised energy
    by convention — and pipeline bottleneck); ``deadlines`` is [N, D]
    absolute per-network bounds or [D] (broadcast to every network);
    ``norm_latency`` defaults to ``latency`` and only feeds the
    network-mean chip front.  Returns the 6-tuple of
    :func:`_pareto_body` as numpy arrays."""
    value = np.asarray(value, dtype=np.float64)
    latency = np.asarray(latency, dtype=np.float64)
    deadlines = np.asarray(deadlines, dtype=np.float64)
    if deadlines.ndim == 1:
        deadlines = np.broadcast_to(deadlines[None, :],
                                    (value.shape[1], deadlines.shape[0]))
    norm_latency = (latency if norm_latency is None
                    else np.asarray(norm_latency, dtype=np.float64))
    return _pareto_body(value, latency, norm_latency, deadlines)


# ---------------------------------------------------------------------------
# Energy-aware deadline-slack scheduling.
#
# Stage 1 of batch_schedule_hetero is latency-argmin only, so every
# frontier built on it is latency-optimal.  The slack pass starts from
# that schedule and greedily moves layers to LOWER-ENERGY types (largest
# energy saving first) while the pipeline still meets a deadline.
# Feasibility of a candidate assignment at a threshold is decided by a
# sequential greedy-covering SCAN over the layer axis (open a new
# segment when the running sum would exceed the threshold) — the same
# arithmetic in the scalar oracle and the numpy batch kernel, so the two
# stay bit-identical:
#
#     x    = lat[t, l] if tt[l] == t else 0.0     (exact zero-padding)
#     nxt  = run + x                              (computed ONCE, reused)
#     over = nxt > thr
#     viol |= over & (x > thr)
#     segs += over;  run = over ? x : nxt
#
# A type is coverable iff segs <= max(count, 1) and never viol.  After
# the greedy move loop the true bottleneck of the final assignment is
# recovered by bisecting the threshold (56 iterations, lo = 0, hi =
# min(deadline, per-type scan totals max) — both endpoints verified
# feasible, and hi is only ever replaced by a TESTED-feasible midpoint,
# so extraction at hi always succeeds and bottleneck <= deadline holds
# at the bit level).  Energy totals are summed by a SEQUENTIAL per-layer
# loop in both paths (np.sum's pairwise tree would differ between the
# oracle's [n_l] vector and the batch's padded rows).  Host numpy by
# design, like the latency-only solve above.
# ---------------------------------------------------------------------------


def _oracle_slack_scan(lat, tt, thr, n_l):
    """Scalar greedy-covering scan for ONE problem (python loop).

    Returns (run [T] final running sums, segs [T], viol [T], peak [T]
    max completed-segment sum incl. the final running one)."""
    n_types = lat.shape[0]
    run = np.zeros(n_types)
    segs = np.ones(n_types, dtype=np.int64)
    viol = np.zeros(n_types, dtype=bool)
    peak = np.zeros(n_types)
    for l in range(n_l):
        t = int(tt[l])
        x = float(lat[t, l])
        nxt = run[t] + x
        if nxt > thr:
            if x > thr:
                viol[t] = True
            segs[t] += 1
            peak[t] = max(peak[t], run[t])
            run[t] = x
        else:
            run[t] = nxt
    peak = np.maximum(peak, run)
    return run, segs, viol, peak


def slack_schedule_oracle(latencies, energies, counts, deadline
                          ) -> Dict[str, Any]:
    """Scalar reference for ONE energy-aware slack schedule.

    ``latencies``/``energies``: [n_types, n_layers]; ``counts``:
    [n_types] cores per type; ``deadline``: absolute pipeline-latency
    budget.  Starts from :func:`schedule_hetero_oracle`'s latency-argmin
    schedule; when ``deadline`` leaves slack (deadline > T*), greedily
    re-assigns layers to the energy-argmin type (largest per-layer
    saving first, ties -> lower layer index), accepting each move iff
    the greedy-covering scan still fits every type's cores within the
    deadline.  Returns dict(bottleneck, layer_type, energy, n_moves,
    feasible) — the exact semantics :func:`batch_slack_schedule`
    batches (bit-identical arithmetic)."""
    lat = np.asarray(latencies, dtype=np.float64)
    en = np.asarray(energies, dtype=np.float64)
    base = schedule_hetero_oracle(lat, counts)
    n_types, n_l = lat.shape
    if en.shape != lat.shape:
        raise ValueError(
            f"energies shape {en.shape} != latencies shape {lat.shape}")
    cnt = np.asarray(counts, dtype=np.int64)[:n_types]
    deadline = float(deadline)
    tt0 = np.asarray(base["layer_type"], dtype=np.int64)
    t_star = float(base["bottleneck"])

    def _energy(tt):
        eng = 0.0                       # sequential: matches batch path
        for l in range(n_l):
            eng += en[tt[l], l]
        return eng

    def _base_copy():
        return dict(bottleneck=t_star, layer_type=tt0.copy(),
                    energy=_energy(tt0), n_moves=0,
                    feasible=bool(t_star <= deadline))

    if not (deadline > t_star):        # no slack (or infeasible): base
        return _base_copy()

    avail = cnt > 0
    te = np.argmin(np.where(avail[:, None], en, np.inf), axis=0)
    d_e = en[tt0, np.arange(n_l)] - en[te, np.arange(n_l)]
    cand = (te != tt0) & (d_e > 0)
    order = np.lexsort((np.arange(n_l), np.where(cand, -d_e, np.inf)))
    moves = order[:int(cand.sum())]

    kk = np.maximum(cnt, 1)
    tt = tt0.copy()
    n_moves = 0
    for l in moves:
        tt_try = tt.copy()
        tt_try[l] = te[l]
        _, segs, viol, _ = _oracle_slack_scan(lat, tt_try, deadline, n_l)
        if ((segs <= kk) & ~viol).all():
            tt = tt_try
            n_moves += 1
    if n_moves == 0:                   # ulp guard: keep the dp-exact T*
        return _base_copy()

    totals, _, _, _ = _oracle_slack_scan(lat, tt, np.inf, n_l)
    lo, hi = 0.0, min(deadline, float(totals.max()))
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        _, segs, viol, _ = _oracle_slack_scan(lat, tt, mid, n_l)
        if ((segs <= kk) & ~viol).all():
            hi = mid
        else:
            lo = mid
    _, _, _, peak = _oracle_slack_scan(lat, tt, hi, n_l)
    return dict(bottleneck=float(peak.max()), layer_type=tt,
                energy=_energy(tt), n_moves=n_moves, feasible=True)


def _slack_x_rows(lat, tt):
    """Materialise every per-step scan input in ONE op: ``x_all[l]`` is
    exactly the ``x`` the reference scan builds at step ``l`` (the
    latency of layer ``l`` on its assigned type, 0.0 elsewhere).  Shape
    [L, B, D, T] so each step reads a contiguous slice."""
    t_ar = np.arange(lat.shape[1])
    return np.where(np.transpose(tt, (2, 0, 1))[..., None] == t_ar,
                    np.transpose(lat, (2, 0, 1))[:, :, None, :], 0.0)


def _slack_scan_rows(lat, tt, kk, thr, x_all=None, x_max=None):
    """Vectorised greedy-covering scan.

    ``lat`` [B, T, L]; ``tt`` [B, D, L]; ``kk`` [B, T]; ``thr`` [B, D].
    Returns (run [B, D, T] final running sums, feas [B, D]).  Element-
    wise arithmetic identical to :func:`_oracle_slack_scan` (types other
    than tt[l] add an exact 0.0; `over` can only fire for them once viol
    is already set, which never changes the feasibility verdict).
    ``x_all`` lets callers reuse :func:`_slack_x_rows` across scans that
    share the same assignment (the bisection re-scans the SAME ``tt``
    dozens of times with different thresholds)."""
    n_b, n_d, n_pad = tt.shape
    n_types = lat.shape[1]
    if x_all is None:
        x_all = _slack_x_rows(lat, tt)
    if x_max is None:
        x_max = x_all.max(axis=0)
    run = np.zeros((n_b, n_d, n_types))
    segs = np.ones((n_b, n_d, n_types), dtype=np.int64)
    # x > th forces `over` at that step (run >= 0), so viol — "a single
    # layer exceeds the threshold" — needs no scan state: it is just
    # max_l(x_l) > th, and the max is threshold-independent (callers
    # bisecting over thresholds pass it in once)
    viol = x_max > thr[:, :, None]
    th = np.broadcast_to(thr[:, :, None], run.shape)
    over = np.empty(run.shape, dtype=bool)
    for l in range(n_pad):
        x = x_all[l]
        np.add(run, x, out=run)
        np.greater(run, th, out=over)
        segs += over
        np.copyto(run, x, where=over)
    feas = ((segs <= kk[:, None, :]) & ~viol).all(axis=-1)
    return run, feas


def _np_slack_kernel(lat, tt0, kk, mv_layer, mv_to, mv_valid, gate, dl,
                     n_lens, k_out):
    """The slack solver: greedy move loop + bisection + extraction.

    Shapes: lat [B, T, L]; tt0 [B, L]; kk [B, T]; mv_layer/mv_to/
    mv_valid [B, M]; gate/dl [B, D]; n_lens [B]; k_out static.  Returns
    (tt [B, D, L], n_moves [B, D], starts [B, D, T, k_out], loads
    [B, D, T, k_out], seg_counts [B, D, T], bottleneck [B, D]).

    Rows are independent, so the batch is split into depth buckets
    (power-of-two layer counts) and each bucket scans only its own
    depth — padding columns past a problem's true layer count are exact
    scan no-ops, so an 11-layer problem need not ride along through a
    126-step loop sized by the deepest problem in the batch.  The move
    loop also shrinks per bucket (shallow problems have few candidate
    moves)."""
    n_b, n_types, n_pad = lat.shape
    n_d = dl.shape[1]
    depth = np.maximum(n_lens, 1)
    if np.unique(depth).size <= 8:     # few distinct depths: exact cut
        buckets = depth
    else:
        buckets = 1 << np.ceil(np.log2(depth)).astype(np.int64)
        buckets = np.minimum(np.maximum(buckets, 8), n_pad)
    if n_b and buckets.min() < n_pad:
        tt = np.broadcast_to(tt0[:, None, :], (n_b, n_d, n_pad)).copy()
        n_moves = np.zeros((n_b, n_d), dtype=np.int64)
        starts = np.broadcast_to(
            n_lens[:, None, None, None],
            (n_b, n_d, n_types, k_out)).copy()
        starts[:, :, :, 0] = 0
        loads = np.zeros((n_b, n_d, n_types, k_out))
        segc = np.ones((n_b, n_d, n_types), dtype=np.int64)
        bott = np.full((n_b, n_d), np.inf)
        for bk in np.unique(buckets):
            idx = np.flatnonzero(buckets == bk)
            mv_v = mv_valid[idx]
            m_hi = int(mv_v.sum(axis=1).max(initial=0))
            out = _np_slack_rows(
                np.ascontiguousarray(lat[idx, :, :bk]), tt0[idx, :bk],
                kk[idx], mv_layer[idx, :m_hi], mv_to[idx, :m_hi],
                mv_v[:, :m_hi], gate[idx], dl[idx], n_lens[idx], k_out)
            tt[idx, :, :bk] = out[0]
            n_moves[idx] = out[1]
            starts[idx] = out[2]
            loads[idx] = out[3]
            segc[idx] = out[4]
            bott[idx] = out[5]
        return tt, n_moves, starts, loads, segc, bott
    return _np_slack_rows(lat, tt0, kk, mv_layer, mv_to, mv_valid, gate,
                          dl, n_lens, k_out)


def _np_slack_rows(lat, tt0, kk, mv_layer, mv_to, mv_valid, gate, dl,
                   n_lens, k_out):
    """One depth bucket of :func:`_np_slack_kernel` (same contract; the
    layer axis is the bucket depth, ``n_lens`` may be shorter)."""
    n_b, n_types, n_pad = lat.shape
    n_d = dl.shape[1]
    n_m = mv_layer.shape[1]
    tt = np.broadcast_to(tt0[:, None, :], (n_b, n_d, n_pad)).copy()
    n_moves = np.zeros((n_b, n_d), dtype=np.int64)
    x_cur = None
    if n_m:
        # The tentative scan per candidate runs on the DESTINATION lane
        # only.  On gated cells (dl > base bottleneck) the current
        # accepted assignment is always scan-feasible at the deadline
        # with no layer exceeding it: the base split's bottleneck
        # certifies it (greedy segment count is monotone in the
        # threshold), and every accepted move preserves it by
        # construction.  Greedy segment count is also monotone in the
        # element values, so zeroing the moved layer can never break
        # its OLD lane — both monotonicities hold exactly in float
        # arithmetic (sequential nonnegative adds are order-preserving),
        # so the full-assignment verdict the oracle computes reduces to
        # [new-lane scan feasible] AND [lat_new <= dl].  Candidates are
        # one per layer (its energy-argmin type), so a candidate layer
        # still sits on its base type when tried.  The new-lane
        # sequence is where-built per candidate in layer-major layout
        # from the cell-major tt/lat, while x_cur [L, B, D, T] is
        # maintained by tiny accept-scatters purely for the bisect
        # stage below.  Every value written is a lat[] element or an
        # exact 0.0, so downstream scan arithmetic is bit-identical to
        # rebuilding x from the assignment.
        x_cur = _slack_x_rows(lat, tt)
        d_ar = np.arange(n_d)
        # the move axis is padded to the WORST problem's candidate
        # count — rows without move j (or without slack at all) are
        # excluded, keeping tt/n_moves unchanged
        live = gate.any(axis=1)
        for j in range(n_m):
            sel = np.flatnonzero(live & mv_valid[:, j])
            s = sel.size
            if s == 0:
                continue
            r_ix = sel[:, None]
            lyr = mv_layer[sel, j]
            l_ix = lyr[:, None]
            s_ar = np.arange(s)
            nt = mv_to[sel, j]                                # [s]
            nt_b = nt[:, None]                                # [s, 1]
            ot1 = tt0[sel, lyr]                               # [s]
            ot = ot1[:, None]
            lat_new = lat[sel, nt, lyr][:, None]              # [s, 1]
            x_old = lat[sel, ot1, lyr][:, None]               # [s, 1]
            dl_s = dl[sel]                                    # [s, D]
            cond = tt[sel] == nt[:, None, None]               # [s, D, L]
            xs = np.where(cond.transpose(2, 0, 1),
                          lat[sel, nt].T[:, :, None], 0.0)    # [L, s, D]
            xs[lyr, s_ar, :] = lat_new
            kk_nt = kk[sel, nt]                               # [s]
            run = np.zeros((s, n_d))
            segs = np.ones((s, n_d), dtype=np.int64)
            over = np.empty(run.shape, dtype=bool)
            for l in range(n_pad):
                x = xs[l]
                np.add(run, x, out=run)
                np.greater(run, dl_s, out=over)
                segs += over
                np.copyto(run, x, where=over)
            acc = ((segs <= kk_nt[:, None]) & (lat_new <= dl_s)
                   & gate[sel])                               # [s, D]
            x_cur[l_ix, r_ix, d_ar, ot] = np.where(acc, 0.0, x_old)
            x_cur[l_ix, r_ix, d_ar, nt_b] = np.where(
                acc, np.broadcast_to(lat_new, acc.shape), 0.0)
            tt[r_ix, d_ar, l_ix] = np.where(acc, nt_b, ot)
            n_moves[sel] += acc

    # rows with zero accepted moves carry the base schedule through the
    # combine, so bisection + extraction run on the moved rows only;
    # untouched rows get inert placeholders (overridden downstream)
    starts = np.broadcast_to(
        n_lens[:, None, None, None], (n_b, n_d, n_types, k_out)).copy()
    starts[:, :, :, 0] = 0
    loads = np.zeros((n_b, n_d, n_types, k_out))
    segc = np.ones((n_b, n_d, n_types), dtype=np.int64)
    bott = np.full((n_b, n_d), np.inf)
    rsel = np.flatnonzero((n_moves > 0).any(axis=1))
    if rsel.size == 0:
        return tt, n_moves, starts, loads, segc, bott
    lat_r, tt_r, kk_r, dl_r = lat[rsel], tt[rsel], kk[rsel], dl[rsel]
    # tt fixed from here on: one x tensor is shared by all scans (the
    # move loop left x_cur holding exactly _slack_x_rows(lat, tt))
    x_all = (x_cur[:, rsel] if x_cur is not None
             else _slack_x_rows(lat_r, tt_r))
    x_max = x_all.max(axis=0)
    totals, _ = _slack_scan_rows(lat_r, tt_r, kk_r,
                                 np.full_like(dl_r, np.inf), x_all, x_max)
    hi = np.minimum(dl_r, totals.max(axis=-1))
    lo = np.zeros_like(hi)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        _, feas = _slack_scan_rows(lat_r, tt_r, kk_r, mid, x_all, x_max)
        lo = np.where(feas, lo, mid)
        hi = np.where(feas, mid, hi)

    n_r = rsel.size
    k_ar = np.arange(k_out)
    run = np.zeros((n_r, n_d, n_types))
    seg = np.zeros((n_r, n_d, n_types), dtype=np.int64)
    starts_r = np.broadcast_to(
        n_lens[rsel][:, None, None, None],
        (n_r, n_d, n_types, k_out)).copy()
    starts_r[:, :, :, 0] = 0
    loads_r = np.zeros((n_r, n_d, n_types, k_out))
    th = hi[:, :, None]
    for l in range(n_pad):
        x = x_all[l]
        nxt = run + x
        over = nxt > th
        starts_r = np.where(
            over[..., None] & (k_ar == (seg + 1)[..., None]), l, starts_r)
        loads_r = np.where(over[..., None] & (k_ar == seg[..., None]),
                           run[..., None], loads_r)
        seg = seg + over
        run = np.where(over, x, nxt)
    loads_r = np.where(k_ar == seg[..., None], run[..., None], loads_r)
    starts[rsel] = starts_r
    loads[rsel] = loads_r
    segc[rsel] = seg + 1
    bott[rsel] = loads_r.max(axis=(-1, -2))
    return tt, n_moves, starts, loads, segc, bott


@dataclasses.dataclass(frozen=True)
class BatchSlackResult:
    """Array-level output of :func:`batch_slack_schedule`.

    Every field with a leading ``[B, D]`` is indexed (problem,
    deadline); ``base`` is the latency-only :class:`BatchHeteroResult`
    the slack pass started from.  Cells without slack (deadline <= the
    latency-optimal bottleneck, or no accepted move) carry the base
    schedule unchanged, so the slack result weakly dominates the base
    everywhere by construction."""

    base: BatchHeteroResult
    deadlines: np.ndarray         # [B, D] absolute deadlines
    layer_type: np.ndarray        # [B, D, L_pad]
    starts: np.ndarray            # [B, D, T, k_out] full-axis starts
    seg_counts: np.ndarray        # [B, D, T]
    loads: np.ndarray             # [B, D, T, k_out]
    bottleneck: np.ndarray        # [B, D] (<= deadline wherever slack)
    total: np.ndarray             # [B, D] sum of assigned layer latency
    energy: np.ndarray            # [B, D] sum of assigned layer energy
    n_moves: np.ndarray           # [B, D] accepted energy moves
    feasible: np.ndarray          # [B, D] bottleneck <= deadline

    def __len__(self) -> int:
        return int(self.bottleneck.shape[0])

    @property
    def n_deadlines(self) -> int:
        return int(self.bottleneck.shape[1])

    def schedule(self, i: int, d: int = 0) -> HeteroSchedule:
        if not self.feasible[i, d]:
            lab = (self.base.labels[i] if self.base.labels is not None
                   else f"problem {i}")
            raise ValueError(
                f"{lab}: infeasible at deadline {self.deadlines[i, d]} "
                f"(latency-optimal bottleneck "
                f"{float(self.base.bottleneck[i])}) — no schedule meets "
                "the deadline")
        n_t = self.base.counts.shape[1]
        n_l = int(self.base.n_layers[i])
        tt = self.layer_type[i, d, :n_l]
        counts = self.base.counts[i]
        core_off = np.concatenate([[0], np.cumsum(counts)])
        types = tuple(int(t) for t in np.repeat(np.arange(n_t), counts))
        loads = np.zeros(int(core_off[-1]))
        layer_core = np.zeros(n_l, dtype=np.intp)
        for t in range(n_t):
            if counts[t] == 0:
                continue
            kk = int(self.seg_counts[i, d, t])
            st = self.starts[i, d, t, :kk]
            ends = np.concatenate([st[1:], [n_l]])
            lt = np.flatnonzero(tt == t)
            if lt.size:
                layer_core[lt] = core_off[t] + np.searchsorted(
                    ends, lt, side="right")
            loads[core_off[t]:core_off[t] + kk] = self.loads[i, d, t, :kk]
        bott = float(self.bottleneck[i, d])
        total = float(self.total[i, d])
        return HeteroSchedule(
            types=types, layer_type=tuple(int(t) for t in tt),
            layer_core=tuple(int(c) for c in layer_core),
            loads=tuple(float(x) for x in loads),
            bottleneck=bott,
            speedup=total / bott if bott > 0 else float("inf"),
            n_layers=n_l)


def batch_slack_schedule(latencies, energies, counts, deadlines,
                         n_layers=None, *,
                         strict: bool = True,
                         labels=None,
                         base: BatchHeteroResult | None = None,
                         ) -> BatchSlackResult:
    """Solve every energy-aware slack schedule in ONE call.

    ``latencies``/``energies``: per-problem ``[n_types, n_layers]``
    matrices — a sequence of such, or dense ``[B, T, L]`` (or
    ``[B, S, T, L]`` with a fault-scenario axis, flattened
    scenario-minor exactly like :func:`batch_schedule_hetero`).
    ``deadlines``: absolute pipeline-latency budgets — a scalar, a
    ``[D]`` vector shared by every problem, or ``[B, D]`` per-problem
    rows.  For each (problem, deadline) cell the latency-argmin
    schedule is computed first (``base``, reusable across calls), then
    layers are greedily moved to lower-energy types while the greedy-
    covering scan keeps the pipeline within the deadline — all cells in
    one call.  Bit-exact against :func:`slack_schedule_oracle` per cell.
    ``strict``/``labels`` follow :func:`batch_schedule_hetero` (used
    only when ``base`` is not supplied)."""
    lat_in, en_in = latencies, energies
    if isinstance(lat_in, np.ndarray) and lat_in.ndim == 4:
        en_in = np.asarray(en_in, dtype=np.float64)
        if en_in.shape != lat_in.shape:
            raise ValueError(
                f"energies shape {en_in.shape} != latencies shape "
                f"{lat_in.shape}")
        b0, n_s = lat_in.shape[:2]
        en_in = en_in.reshape(b0 * n_s, *en_in.shape[2:])
        lat_in, counts, n_layers = _flatten_scenarios(lat_in, counts,
                                                      n_layers)
    dense = isinstance(lat_in, np.ndarray) and lat_in.ndim == 3
    if dense:
        n_b, in_types, n_max = lat_in.shape
        n_lens = (np.full(n_b, n_max, dtype=np.int64) if n_layers is None
                  else np.asarray(n_layers, dtype=np.int64))
        prob_types = np.full(n_b, in_types, np.int64)
    else:
        lats = [np.asarray(l, dtype=np.float64) for l in lat_in]
        ens = [np.asarray(e, dtype=np.float64) for e in en_in]
        if len(ens) != len(lats):
            raise ValueError(
                f"{len(ens)} energy matrices for {len(lats)} problems")
        for l, e in zip(lats, ens):
            if e.shape != l.shape:
                raise ValueError(
                    f"energies shape {e.shape} != latencies {l.shape}")
        n_b = len(lats)
        in_types = max((l.shape[0] for l in lats), default=0)
        n_lens = np.array([l.shape[1] for l in lats], dtype=np.int64)
        n_max = int(n_lens.max()) if n_b else 0
        prob_types = np.asarray([l.shape[0] for l in lats],
                                dtype=np.int64)
    cnts = np.asarray(counts)
    if cnts.ndim == 1:
        cnts = np.broadcast_to(cnts, (n_b, cnts.shape[0]))
    cnts = cnts.astype(np.int64)

    dl = np.asarray(deadlines, dtype=np.float64)
    if dl.ndim == 0:
        dl = dl.reshape(1)
    if dl.ndim == 1:
        dl = np.broadcast_to(dl, (max(n_b, 1), dl.shape[0]))
    if dl.ndim != 2 or (n_b and dl.shape[0] != n_b):
        raise ValueError(
            f"deadlines shape {np.asarray(deadlines).shape} is not "
            f"scalar, [D], or [B={n_b}, D]")
    n_d = dl.shape[1]

    if n_b == 0:
        z = np.zeros((0, n_d))
        return BatchSlackResult(
            base=_empty_hetero_result(), deadlines=np.zeros((0, n_d)),
            layer_type=np.zeros((0, n_d, 0), np.int64),
            starts=np.zeros((0, n_d, 0, _K_MAX), np.int64),
            seg_counts=np.zeros((0, n_d, 0), np.int64),
            loads=np.zeros((0, n_d, 0, _K_MAX)),
            bottleneck=z.copy(), total=z.copy(), energy=z.copy(),
            n_moves=np.zeros((0, n_d), np.int64),
            feasible=np.zeros((0, n_d), bool))

    if cnts.shape[0] != n_b:
        raise ValueError(f"counts rows {cnts.shape[0]} != problems {n_b}")
    # counts on type slots past a problem's latency rows would hand
    # layers to a phantom zero-latency/zero-energy type once densified
    ghost = np.arange(cnts.shape[1])[None, :] >= prob_types[:, None]
    if (cnts * ghost).any():
        raise ValueError("counts for more types than latency rows")

    n_types = max(in_types, cnts.shape[1])
    counts2 = np.zeros((n_b, n_types), dtype=np.int64)
    counts2[:, :cnts.shape[1]] = cnts
    lat_d = np.zeros((n_b, n_types, n_max))
    en_d = np.zeros((n_b, n_types, n_max))
    if dense:
        lat_d[:, :in_types, :] = lat_in
        en_src = np.asarray(en_in, dtype=np.float64)
        if en_src.shape != lat_in.shape:
            raise ValueError(
                f"energies shape {en_src.shape} != latencies shape "
                f"{lat_in.shape}")
        en_d[:, :in_types, :] = en_src
    else:
        for i, (l, e) in enumerate(zip(lats, ens)):
            lat_d[i, :l.shape[0], :l.shape[1]] = l
            en_d[i, :e.shape[0], :e.shape[1]] = e
    # the scan and the sequential energy/total sums rely on EXACT zeros
    # past each problem's true layer count — scrub dense garbage columns
    valid_cols = np.arange(n_max)[None, :] < n_lens[:, None]
    lat_d = np.where(valid_cols[:, None, :], lat_d, 0.0)
    en_d = np.where(valid_cols[:, None, :], en_d, 0.0)

    if base is None:
        base = batch_schedule_hetero(lat_d, counts2, n_lens,
                                     strict=strict, labels=labels)
    elif len(base) != n_b:
        raise ValueError(
            f"base has {len(base)} problems, inputs have {n_b}")

    # host precompute: energy argmin targets + move order per problem
    tt0 = base.layer_type[:, :n_max].astype(np.int64)
    avail = counts2 > 0
    te = np.argmin(np.where(avail[:, :, None], en_d, np.inf), axis=1)
    l_idx = np.arange(n_max)
    valid_l = l_idx[None, :] < n_lens[:, None]
    e_cur = np.take_along_axis(en_d, tt0[:, None, :], axis=1)[:, 0, :]
    e_new = np.take_along_axis(en_d, te[:, None, :], axis=1)[:, 0, :]
    d_e = e_cur - e_new
    cand = (te != tt0) & (d_e > 0) & valid_l
    key = np.where(cand, -d_e, np.inf)
    order = np.lexsort(
        (np.broadcast_to(l_idx, key.shape), key), axis=-1)
    n_mv = cand.sum(axis=1)
    n_m = int(n_mv.max())
    mv_layer = order[:, :n_m]
    mv_valid = np.arange(n_m)[None, :] < n_mv[:, None]
    mv_to = np.take_along_axis(te, mv_layer, axis=1) if n_m else \
        np.zeros((n_b, 0), np.int64)
    with np.errstate(invalid="ignore"):
        gate = dl > base.bottleneck[:, None]       # inf-bottleneck safe
    kk = np.maximum(counts2, 1)
    k_out = max(base.starts.shape[2],
                max(1, min(int(counts2.max(initial=1)), n_max)))

    tt_s, n_moves, starts_s, loads_s, segc_s, bott_s = _np_slack_kernel(
        lat_d, tt0, kk, mv_layer, mv_to, mv_valid, gate, dl, n_lens, k_out)

    # combine: cells without slack (or with zero accepted moves) carry
    # the base schedule unchanged — weak dominance by construction
    use = gate & (n_moves > 0)
    layer_type = np.where(use[:, :, None], tt_s, tt0[:, None, :])
    k_b = base.starts.shape[2]
    base_starts = base.starts
    base_loads = base.loads
    if k_out > k_b:
        base_starts = np.concatenate(
            [base_starts, np.broadcast_to(
                n_lens[:, None, None],
                (n_b, base_starts.shape[1], k_out - k_b))], axis=2)
        base_loads = np.concatenate(
            [base_loads, np.zeros(
                (n_b, base_loads.shape[1], k_out - k_b))], axis=2)
    starts = np.where(use[:, :, None, None], starts_s,
                      base_starts[:, None])
    loads = np.where(use[:, :, None, None], loads_s,
                     base_loads[:, None])
    seg_counts = np.where(use[:, :, None], segc_s,
                          base.seg_counts[:, None])
    bottleneck = np.where(use, bott_s, base.bottleneck[:, None])
    n_moves = np.where(use, n_moves, 0)
    with np.errstate(invalid="ignore"):
        feasible = ((base.feasible[:, None]
                     if base.feasible is not None else True)
                    & (bottleneck <= dl))

    # totals + energies of the COMBINED assignment: sequential per-layer
    # loops (padded cells gather type 0 whose padding is exact 0.0)
    l_sel = np.take_along_axis(
        np.broadcast_to(lat_d[:, None], (n_b, n_d) + lat_d.shape[1:]),
        layer_type[:, :, None, :], axis=2)[:, :, 0, :]
    e_sel = np.take_along_axis(
        np.broadcast_to(en_d[:, None], (n_b, n_d) + en_d.shape[1:]),
        layer_type[:, :, None, :], axis=2)[:, :, 0, :]
    total = np.zeros((n_b, n_d))
    energy = np.zeros((n_b, n_d))
    for l in range(n_max):
        total = total + l_sel[:, :, l]
        energy = energy + e_sel[:, :, l]
    # base cells keep base.total bit-for-bit (its per-type prefix-sum
    # order differs from the sequential re-gather by ulps)
    total = np.where(use, total, base.total[:, None])

    return BatchSlackResult(
        base=base, deadlines=np.ascontiguousarray(dl),
        layer_type=layer_type, starts=starts, seg_counts=seg_counts,
        loads=loads, bottleneck=bottleneck, total=total, energy=energy,
        n_moves=n_moves, feasible=feasible)
