"""Model parallelism on homogeneous cores (§IV.B, Algorithm II).

The PyTorch port of the Algorithm II part of ``repro.core.partition``.  A
network's layers are distributed *contiguously* over k identical cores
forming a pipeline through off-chip DRAM (Fig. 11).  The pipeline latency
is the maximum per-core latency; the speedup of eq. (6) is

    speedup = sum(latencies) / max(core latency).

``bb_partition`` is the paper's branch-and-bound, ``dp_partition`` an exact
oracle (linear-partition DP), ``brute_force_partition`` enumerates all
splits, and ``batch_partition`` solves every (network × core-count) split
at once by bisection on the bottleneck with a greedy feasibility check over
prefix sums (the reference's numpy body), bit-exact against
``dp_partition``.  All of it is host-side numpy over the layer latencies of
the port's :class:`repro_torch.core.energymodel.NetworkReport`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

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
