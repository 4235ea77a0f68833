"""DSE-as-a-service on the port: a long-lived, fault-tolerant co-design
query server on the card.

The port's copy of ``repro.serving.dse_service``.  The engine's costs are
front-loaded (kernel builds, streamed sweeps, candidate pools), so a
resident process answers many queries, bounds its queue, meets deadlines
and survives faults.  :class:`DSEService` is that process's core,
step-driven (no threads), so every fault-injection test is deterministic.
It runs on ``device`` (the card by default; raises without one) with one
``backend`` (``"cuda"``: the hand-written kernels; ``"torch"``: their
plain versions; the default follows the device).

**Query model.**  Four kinds, submitted via :meth:`DSEService.submit`:
``best_config`` (per-network sweep argmin under a metric), ``best_chip``
(best heterogeneous chip under a relative latency deadline ``d``),
``pareto`` (one network's non-dominated (chip, latency, energy) front),
and ``reschedule`` (a deployed chip suffered a hardware fault — a
:class:`repro_torch.ft.hw_faults.FaultScenario` — and every network's
layers are re-mapped across the survivors).  :meth:`DSEService.step`
pops every queued request of the head request's family (config / chip /
resched) and metric and serves them from ONE shared computation:
concurrent deadline queries coalesce into one
``pareto_codesign(points=...)`` call, concurrent reschedules into ONE
union-grid engine evaluation (``count_layers`` on the card) + ONE
``batch_schedule_hetero(strict=False)`` solve.

**Fault events.**  :meth:`DSEService.fault_event` invalidates every
cached schedule of the affected chip and enqueues the re-schedule query.

**Robustness ladder:**

1. *Bounded admission*: overflow beyond ``max_queue`` is rejected with a
   ``retry_after_s`` estimate.
2. *Deadlines degrade, never hang*: a request whose remaining budget
   ``deadline_s`` cannot cover the projected exact sweep (calibrated
   from the measured subsampled-grid sweep, scaled by point count) — or
   whose exact sweep runs out of budget mid-stream — is answered from
   the subsampled grid, flagged ``degraded=True``.
3. *Retry with exponential backoff*: a failed computation re-runs after
   ``backoff_s · 2^attempt`` on the SAME backend.  Unlike the reference
   there is no backend chain to walk down: a kernel that keeps failing
   surfaces as :class:`ServiceFault` / ``ok=False``, never as an answer
   from the plain path (``backend_fallbacks`` stays 0).
4. *Checkpoint/resume*: every streamed sweep exports its fold state
   after each chunk; a retry resumes from the last folded chunk, and a
   budget-aborted sweep leaves its checkpoint for the next query.
5. *Observability*: :meth:`DSEService.health` (the reference's keys but
   ``jit``: the port compiles no jitted program).
6. *Durability* (``state_dir=``): a write-ahead
   :class:`repro_torch.serving.store.Journal` and a
   :class:`repro_torch.serving.store.DurableStore` of completed streams,
   exact answers and mid-stream checkpoints; a restarted service over the
   same directory replays the accepted-but-unanswered requests and drains
   to bit-identical answers.  The reschedule cache stays memory-only.
7. *Incremental grid deltas*: :meth:`DSEService.extend_grid` folds only
   the appended rows into every completed stream
   (:func:`repro_torch.core.energymodel.merge_layer_topk`), bit-identical
   to re-streaming the grown grid.
8. *Silent-corruption defense* (``verify=True``): every streamed sweep
   runs under a :class:`repro_torch.ft.verify.StreamVerifier` (fold
   invariants + a seeded ``verify_fraction`` of chunks recomputed on the
   plain path on the CPU); :meth:`DSEService.scrub` (also one entry per
   idle :meth:`step`) audits at-rest store entries, quarantines and
   recomputes.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core import energymodel, hetero, partition
from ..core.accelerator import ConfigGrid
from ..device import resolve_backend, resolve_device
from ..core.topology import Layer
from ..ft import hw_faults
from ..ft import verify as ft_verify
from . import store as store_mod


class ServiceFault(RuntimeError):
    """A computation failed after exhausting every retry."""


class _BudgetExhausted(RuntimeError):
    """Internal: the wall-clock budget ran out mid-computation."""


@dataclasses.dataclass
class DSERequest:
    rid: int
    kind: str     # "best_config" | "best_chip" | "pareto" | "reschedule"
    metric: str = "edp"
    network: Optional[str] = None   # best_config: None = all networks
    deadline: float = 2.0           # relative latency deadline (chip family)
    deadline_s: Optional[float] = None   # wall-clock answer budget
    submitted_at: float = 0.0
    # reschedule family: the deployed chip and what broke on it
    chip_types: Optional[Tuple[int, ...]] = None   # flat grid rows
    chip_counts: Optional[Tuple[int, ...]] = None
    scenario: Optional[hw_faults.FaultScenario] = None


@dataclasses.dataclass
class DSEResponse:
    rid: int
    kind: str
    ok: bool
    degraded: bool
    deadline_missed: bool
    answer: Dict[str, Any]
    error: Optional[str]
    latency_s: float
    backend: Optional[str]


def answer_diffs(a, b, rtol: float = 0.0, path: str = "answer") -> List[str]:
    """Where two answers differ, one line each: dicts by key, sequences
    (a tuple equals a list) by element, bools, ints and strings exactly,
    floats within ``rtol`` of ``b`` (equal infinities agree, as do two
    NaNs).  ``rtol=0`` asks for the same bits."""
    if isinstance(a, np.generic):
        a = a.item()
    if isinstance(b, np.generic):
        b = b.item()
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {list(a)} != {list(b)}"]
        return [d for k in a
                for d in answer_diffs(a[k], b[k], rtol, f"{path}[{k!r}]")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: {len(a)} != {len(b)} items"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in answer_diffs(x, y, rtol, f"{path}[{i}]")]
    if isinstance(a, float) or isinstance(b, float):
        if not (isinstance(a, (int, float)) and isinstance(b, (int, float))):
            return [f"{path}: {a!r} != {b!r}"]
        if math.isnan(a) or math.isnan(b):
            agree = math.isnan(a) and math.isnan(b)
        elif math.isinf(a) or math.isinf(b):
            agree = a == b
        else:
            agree = abs(a - b) <= rtol * abs(b)
        return [] if agree else [f"{path}: {a!r} != {b!r} beyond rtol "
                                 f"{rtol}"]
    return [] if type(a) is type(b) and a == b else [f"{path}: {a!r} != "
                                                      f"{b!r}"]


@dataclasses.dataclass
class SubmitResult:
    accepted: bool
    rid: Optional[int]
    queue_depth: int
    retry_after_s: Optional[float] = None


class DSEService:
    """Step-driven DSE query server over one (grid, networks) design space.

    All heavy state is lazy and cached per metric: the streamed per-layer
    sweep (:func:`repro_torch.core.energymodel.stream_layer_topk` with
    boundary sets), the co-design problem set built on it, and the solved
    raw
    (energy, latency) chip points that make every later deadline re-sweep
    a compiled-scoring-only call.  A parallel set of caches covers the
    ``degrade_stride``-subsampled grid — the degraded-answer tier, and the
    calibration source for projecting exact-sweep cost."""

    def __init__(self, grid: ConfigGrid,
                 networks: Mapping[str, Sequence[Layer]], *,
                 metric_bound: float = 0.05,
                 pool_size: int = 4,
                 m_cores: int = 4,
                 max_types: int = 2,
                 topk: int = 8,
                 chunk_size: int = 1024,
                 max_queue: int = 64,
                 degrade_stride: int = 8,
                 device=None,
                 backend: str | None = None,
                 max_retries: int = 3,
                 backoff_s: float = 0.05,
                 safety_factor: float = 2.0,
                 state_dir=None,
                 lat_window: int = 4096,
                 ckpt_every: int = 4,
                 clock=time.monotonic,
                 sleep=time.sleep,
                 verify: bool = True,
                 verify_fraction: float = 1.0 / 16.0,
                 verify_seed: int = 0,
                 scrub_rows: int = 2,
                 idle_scrub: bool = True):
        self.grid = grid
        self.networks = dict(networks)
        self.names = tuple(self.networks)
        self.bound = float(metric_bound)
        self.pool_size = int(pool_size)
        self.m_cores = int(m_cores)
        self.max_types = int(max_types)
        self.topk = max(int(topk), int(pool_size))
        self.chunk_size = int(chunk_size)
        self.max_queue = int(max_queue)
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.safety = float(safety_factor)
        self.ckpt_every = max(int(ckpt_every), 1)
        self._clock = clock
        self._sleep = sleep
        self.verify = bool(verify)
        self.verify_fraction = float(verify_fraction)
        self.verify_seed = int(verify_seed)
        self._scrub_rows = int(scrub_rows)
        self._idle_scrub = bool(idle_scrub)
        self._scrub_cursor: Optional[str] = None
        self._stride = max(1, min(int(degrade_stride), grid.n))
        self._sub_idx = np.arange(0, grid.n, self._stride)
        self._sub_grid = grid.take(self._sub_idx)

        self._queue: List[DSERequest] = []
        self.responses: List[DSEResponse] = []
        self._next_rid = 0
        self._t0 = self._clock()
        # tier ("exact"|"sub") × metric caches
        self._streams: Dict[Tuple[str, str], energymodel.LayerTopK] = {}
        self._points: Dict[Tuple[str, str], tuple] = {}
        self._ckpt: Dict[tuple, energymodel.StreamFoldState] = {}
        self._cost: Dict[tuple, float] = {}     # measured seconds, EMA
        # bounded ring buffer: p50/p99 over the last `lat_window` samples,
        # O(window) memory no matter how long the service lives
        self.lat_window = max(int(lat_window), 1)
        self._lat: collections.deque = collections.deque(
            maxlen=self.lat_window)
        self.stats: Dict[str, int] = dict(
            submitted=0, accepted=0, rejected=0, completed=0, degraded=0,
            deadline_missed=0, errors=0, faults=0, retries=0,
            backend_fallbacks=0, resumes=0, budget_aborts=0,
            sweep_cache_hits=0, sweep_cache_misses=0,
            points_cache_hits=0, points_cache_misses=0,
            coalesced_batches=0,
            fault_events=0, reschedules=0, schedule_invalidations=0,
            resched_cache_hits=0, resched_cache_misses=0,
            store_hits=0, store_misses=0, answer_hits=0,
            replayed=0, replay_dropped=0, ckpt_gc=0,
            grid_extensions=0, delta_folds=0, cache_invalidated=0,
            shadow_checks=0, shadow_mismatches=0,
            invariant_checks=0, invariant_violations=0,
            scrub_entries=0, scrubbed_bad=0, scrub_recomputed=0)
        # (chip_types, chip_counts, scenario.key(), metric) → answer dict
        self._resched: Dict[tuple, Dict[str, Any]] = {}

        # -- durable state (all no-ops when state_dir is None) -------------
        self.state_dir = None if state_dir is None else str(state_dir)
        self._grid_hash = store_mod.grid_hash(self.grid)
        self._sub_hash = store_mod.grid_hash(self._sub_grid)
        self._nets_hash = store_mod.networks_hash(self.networks)
        self.store: Optional[store_mod.DurableStore] = None
        self._journal: Optional[store_mod.Journal] = None
        if self.state_dir is not None:
            self.store = store_mod.DurableStore(self.state_dir)
            self._recover()

    # -- durable state -----------------------------------------------------
    def _journal_path(self) -> str:
        return str(self.store.root / "journal.jsonl")

    def _params_key(self) -> tuple:
        """Service parameters every cached artifact depends on."""
        return ("params", self.bound, self.pool_size, self.m_cores,
                self.max_types, self.topk)

    def _tier_hash(self, tier: str) -> str:
        return self._grid_hash if tier == "exact" else self._sub_hash

    def _stream_key(self, tier: str, metric: str) -> tuple:
        return (self._tier_hash(tier), self._nets_hash, "stream", metric,
                ("params", self.bound, self.topk))

    def _answer_key(self, r: DSERequest, metric: str) -> tuple:
        """Store key of one EXACT answer.  best_config answers do not
        depend on the deadline; chip-family answers do (best_chip is
        scored at it, pareto's slack front is widened by it)."""
        dl = (float(r.deadline)
              if r.kind in ("best_chip", "pareto") else None)
        return (self._grid_hash, self._nets_hash, "answer", r.kind,
                metric, r.network, dl, self._params_key())

    def _expected_ckpt_hash(self, tier: str, fs) -> str:
        """The ``stream_input_hash`` a live stream of ``tier`` at the
        checkpoint's (metric, bound, topk) would carry — a checkpoint
        matches iff its own hash equals this."""
        _, grid, _ = self._tier(tier == "exact")
        chunk = max(1, min(self.chunk_size, grid.n))
        return energymodel.stream_input_hash(
            grid, self.networks, kind=fs.kind, metric=fs.metric,
            bound=fs.bound, topk=fs.topk, chunk=chunk)

    def _recover(self) -> None:
        """Restart path: replay the journal's unanswered requests in
        admission order, garbage-collect stale checkpoint files, and
        register live ones for resume — then reopen the journal for
        append so recovered and new traffic share one log."""
        rr = store_mod.Journal.replay(self._journal_path())
        self._next_rid = max(self._next_rid, rr.next_rid)
        pending = rr.pending
        self._journal = store_mod.Journal(self._journal_path())
        for rec in pending:
            try:
                self._queue.append(self._request_from_journal(rec))
                self.stats["replayed"] += 1
            except Exception:
                self.stats["replay_dropped"] += 1
        # checkpoint GC: a file is live iff its input hash matches what a
        # stream of one of our tiers would compute right now
        for path, fs in self.store.iter_ckpts():
            tier = next((t for t in ("exact", "sub")
                         if fs.input_hash == self._expected_ckpt_hash(
                             t, fs)), None)
            if tier is None:
                self.store.drop_ckpt(fs.input_hash)
                self.stats["ckpt_gc"] += 1
            else:
                self._ckpt[("stream", tier, fs.metric)] = fs

    def _request_from_journal(self, rec: Mapping[str, Any]) -> DSERequest:
        """Rebuild a journalled request; ``submitted_at`` is refreshed —
        monotonic clocks do not survive the process they came from."""
        sc = rec.get("scenario")
        return DSERequest(
            rid=int(rec["rid"]), kind=rec["kind"], metric=rec["metric"],
            network=rec.get("network"),
            deadline=float(rec.get("deadline", 2.0)),
            deadline_s=rec.get("deadline_s"),
            submitted_at=self._clock(),
            chip_types=(None if rec.get("chip_types") is None
                        else tuple(int(t) for t in rec["chip_types"])),
            chip_counts=(None if rec.get("chip_counts") is None
                         else tuple(int(c) for c in rec["chip_counts"])),
            scenario=(None if sc is None
                      else hw_faults.scenario_from_json(sc)))

    def _journal_submit(self, r: DSERequest) -> None:
        if self._journal is None:
            return
        self._journal.submit(r.rid, dict(
            kind=r.kind, metric=r.metric, network=r.network,
            deadline=r.deadline, deadline_s=r.deadline_s,
            chip_types=(None if r.chip_types is None
                        else list(r.chip_types)),
            chip_counts=(None if r.chip_counts is None
                         else list(r.chip_counts)),
            scenario=(None if r.scenario is None
                      else hw_faults.scenario_to_json(r.scenario))))

    def _drop_ckpt(self, key: tuple) -> None:
        """Forget a checkpoint in memory AND on disk."""
        fs = self._ckpt.pop(key, None)
        if fs is not None and self.store is not None:
            self.store.drop_ckpt(fs.input_hash)

    def close(self) -> None:
        """Release the journal file handle (the store is handle-free)."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # -- admission ---------------------------------------------------------
    @staticmethod
    def _family(kind: str) -> str:
        if kind == "reschedule":
            return "resched"
        return "chip" if kind in ("best_chip", "pareto") else "config"

    def submit(self, kind: str, *, network: Optional[str] = None,
               metric: str = "edp", deadline: float = 2.0,
               deadline_s: Optional[float] = None,
               chip_types: Optional[Sequence[int]] = None,
               chip_counts: Optional[Sequence[int]] = None,
               scenario: Optional[hw_faults.FaultScenario] = None
               ) -> SubmitResult:
        """Enqueue a query; reject-with-retry-after when the queue is full."""
        if kind not in ("best_config", "best_chip", "pareto", "reschedule"):
            raise ValueError(f"unknown query kind {kind!r}")
        if network is not None and network not in self.networks:
            raise ValueError(f"unknown network {network!r}")
        if kind == "pareto" and network is None:
            raise ValueError("pareto queries name one network")
        if kind == "reschedule":
            if chip_types is None or chip_counts is None:
                raise ValueError(
                    "reschedule queries name the chip: chip_types "
                    "(flat grid rows) and chip_counts")
            if scenario is None:
                raise ValueError("reschedule queries carry a FaultScenario")
            chip_types = tuple(int(t) for t in chip_types)
            chip_counts = tuple(int(c) for c in chip_counts)
            if len(chip_types) != len(chip_counts):
                raise ValueError(
                    f"{len(chip_types)} chip types but "
                    f"{len(chip_counts)} counts")
            bad = [t for t in chip_types if not 0 <= t < self.grid.n]
            if bad:
                raise ValueError(
                    f"chip_types {bad} out of range for a "
                    f"{self.grid.n}-row grid")
            if any(c < 0 for c in chip_counts):
                raise ValueError("chip_counts must be >= 0")
            # range-check the scenario's type indices up front
            hw_faults.apply_counts(chip_counts, scenario)
        self.stats["submitted"] += 1
        if len(self._queue) >= self.max_queue:
            self.stats["rejected"] += 1
            return SubmitResult(accepted=False, rid=None,
                                queue_depth=len(self._queue),
                                retry_after_s=self._drain_estimate())
        rid = self._next_rid
        self._next_rid += 1
        req = DSERequest(
            rid=rid, kind=kind, metric=metric, network=network,
            deadline=float(deadline), deadline_s=deadline_s,
            submitted_at=self._clock(), chip_types=chip_types,
            chip_counts=chip_counts, scenario=scenario)
        # write-ahead: the fsync'd journal line lands BEFORE the request
        # is queued, so a kill after this point still replays it
        self._journal_submit(req)
        self._queue.append(req)
        self.stats["accepted"] += 1
        return SubmitResult(accepted=True, rid=rid,
                            queue_depth=len(self._queue))

    def _drain_estimate(self) -> float:
        per = self._cost.get(("request",), 0.5)
        return max(per * (len(self._queue) + 1), 0.1)

    # -- retry / backoff / resume core ------------------------------------
    def _with_retries(self, run, *, key: tuple,
                      budget_end: Optional[float]):
        """``run(backend, resume_from)`` with exponential backoff and
        checkpoint-resume, always on ``self.backend``: the port has no
        fallback chain.  ``_BudgetExhausted`` (raised by the budget
        watchdog inside ``run``) propagates — it is a deadline, not a
        fault."""
        attempt = 0
        while True:
            resume = self._ckpt.get(key)
            if resume is not None:
                self.stats["resumes"] += 1
            try:
                return run(self.backend, resume)
            except _BudgetExhausted:
                self.stats["budget_aborts"] += 1
                raise
            except energymodel.StreamStateError:
                # stale checkpoint (inputs changed) — drop it, count the
                # wasted attempt, start the stream over
                self._drop_ckpt(key)
                attempt += 1
            except Exception as e:
                self.stats["faults"] += 1
                attempt += 1
                if attempt > self.max_retries:
                    raise ServiceFault(
                        f"{key} failed after {attempt} attempts on "
                        f"backend {self.backend!r}: {e}") from e
                delay = self.backoff_s * (2.0 ** (attempt - 1))
                if (budget_end is not None
                        and self._clock() + delay > budget_end):
                    raise _BudgetExhausted(
                        f"{key}: backoff would exceed the request budget")
                self.stats["retries"] += 1
                self._sleep(delay)

    # -- silent-corruption defense -----------------------------------------
    def _make_verifier(self) -> Optional[ft_verify.StreamVerifier]:
        if not self.verify:
            return None
        return ft_verify.StreamVerifier(
            verify_fraction=self.verify_fraction, seed=self.verify_seed)

    def _harvest_verify(self, v: Optional[ft_verify.StreamVerifier]):
        """Fold a per-run verifier's counters into the service stats —
        in a finally block, so counts from a detected-and-raised
        corruption are kept too."""
        if v is None:
            return
        for k, n in v.stats.items():
            self.stats[k] = self.stats.get(k, 0) + n

    def scrub(self, *, max_entries: Optional[int] = None,
              cursor: Optional[str] = None,
              recompute: bool = True) -> Dict[str, Any]:
        """Audit at-rest store entries for silent corruption.

        Walks (a slice of) the durable store through
        :meth:`repro_torch.serving.store.DurableStore.scrub`, with cached
        stream payloads re-derived through
        :func:`repro_torch.ft.verify.scrub_layer_topk` (structural
        invariants + ``scrub_rows`` sampled rows recomputed on the plain
        path on the CPU).  Poisoned entries are quarantined-with-reason,
        evicted from the warm caches, and — with ``recompute=True`` —
        rebuilt immediately so the next query is served clean.  Answer entries
        are covered by the integrity check only (they are JSON meta
        derived from stream payloads, which ARE re-derived)."""
        if self.store is None:
            return dict(scanned=0, bad=0, bad_keys=[], recomputed=0,
                        cursor=cursor)
        import ast

        def parse_stream_key(key_repr):
            """(tier, metric) of a CURRENT stream entry, else None."""
            try:
                key = ast.literal_eval(key_repr)
            except (ValueError, SyntaxError):
                return None
            if not (isinstance(key, tuple) and len(key) >= 4
                    and key[2] == "stream"):
                return None
            tier = ("exact" if key[0] == self._grid_hash else
                    "sub" if key[0] == self._sub_hash else None)
            if tier is None or key[1] != self._nets_hash:
                return None      # superseded entry; invalidation reaps it
            return tier, str(key[3])

        def checker(key_repr, arrays, meta):
            tm = parse_stream_key(key_repr)
            if tm is None:
                return None
            tier, _ = tm
            grid = self.grid if tier == "exact" else self._sub_grid
            try:
                st = store_mod.stream_from_payload(arrays, meta)
            except Exception as e:
                return f"stream payload does not decode: {e}"
            return ft_verify.scrub_layer_topk(
                st, grid, self.networks, rows=self._scrub_rows,
                seed=self.verify_seed)

        res = self.store.scrub(checker, max_entries=max_entries,
                               cursor=cursor)
        self.stats["scrub_entries"] += res["scanned"]
        self.stats["scrubbed_bad"] += res["bad"]
        recomputed = 0
        for key_repr in res["bad_keys"]:
            tm = parse_stream_key(key_repr) if key_repr else None
            if tm is None:
                continue
            tier, metric = tm
            self._streams.pop((tier, metric), None)
            self._points.pop((tier, metric), None)
            if recompute:
                self._get_stream(metric, exact=(tier == "exact"))
                recomputed += 1
        self.stats["scrub_recomputed"] += recomputed
        return dict(res, recomputed=recomputed)

    # -- cached artifacts --------------------------------------------------
    def _tier(self, exact: bool):
        if exact:
            return "exact", self.grid, np.arange(self.grid.n)
        return "sub", self._sub_grid, self._sub_idx

    def _get_stream(self, metric: str, *, exact: bool,
                    budget_end: Optional[float] = None
                    ) -> energymodel.LayerTopK:
        tier, grid, _ = self._tier(exact)
        ck = (tier, metric)
        if ck in self._streams:
            self.stats["sweep_cache_hits"] += 1
            return self._streams[ck]
        if self.store is not None:
            got = self.store.get(self._stream_key(tier, metric))
            if got is not None:
                self.stats["store_hits"] += 1
                self.stats["sweep_cache_hits"] += 1
                st = store_mod.stream_from_payload(*got)
                self._streams[ck] = st
                return st
            self.stats["store_misses"] += 1
        self.stats["sweep_cache_misses"] += 1
        key = ("stream", tier, metric)

        def on_chunk(fs):
            self._ckpt[key] = fs
            # durable spill is throttled: an fsync'd npz per chunk would
            # tax the stream ~2×; every `ckpt_every` chunks bounds the
            # re-fold after a process kill at ckpt_every-1 chunks while
            # keeping the tax small.  In-process retries still resume
            # from the PER-CHUNK in-memory state above.
            if (self.store is not None
                    and fs.next_chunk % self.ckpt_every == 0):
                self.store.save_ckpt(fs)
            if budget_end is not None and self._clock() > budget_end:
                raise _BudgetExhausted(
                    f"stream {key} out of budget at chunk {fs.next_chunk}"
                    f"/{fs.n_chunks}; checkpoint retained")

        def run(backend, resume):
            t0 = self._clock()
            v = self._make_verifier()
            try:
                st = energymodel.stream_layer_topk(
                    grid, self.networks, device=self.device,
                    backend=backend, topk=self.topk, bound=self.bound,
                    metric=metric, chunk_size=self.chunk_size,
                    resume_from=resume, on_chunk=on_chunk, verify=v)
            finally:
                self._harvest_verify(v)
            if resume is None:
                self._record_cost(key, self._clock() - t0)
            return st

        st = self._with_retries(run, key=key, budget_end=budget_end)
        self._drop_ckpt(key)
        self._streams[ck] = st
        self._persist_stream(tier, metric, st)
        return st

    def _persist_stream(self, tier: str, metric: str,
                        st: energymodel.LayerTopK) -> None:
        if self.store is None:
            return
        arrays, meta = store_mod.stream_payload(st)
        self.store.put(self._stream_key(tier, metric),
                       arrays=arrays, meta=meta)

    def _get_points(self, metric: str, *, exact: bool,
                    budget_end: Optional[float] = None) -> tuple:
        """(problems, raw energy [n_chips, n_net], raw latency, solved
        BatchHeteroResult) for one tier — the solved chip points every
        deadline re-sweep reuses; the result feeds the energy-aware
        slack pass without re-solving."""
        tier, grid, _ = self._tier(exact)
        ck = (tier, metric)
        if ck in self._points:
            self.stats["points_cache_hits"] += 1
            return self._points[ck]
        self.stats["points_cache_misses"] += 1
        stream = self._get_stream(metric, exact=exact,
                                  budget_end=budget_end)
        key = ("points", tier, metric)

        def run(backend, resume):
            t0 = self._clock()
            probs = hetero.codesign_problems_streaming(
                grid, self.networks, self.m_cores,
                max_types=self.max_types,
                pool_size=min(self.pool_size, grid.n), bound=self.bound,
                metric=metric, device=self.device, backend=backend,
                stream=stream)
            res = partition.batch_schedule_hetero(
                probs.lat_dense, probs.counts, n_layers=probs.n_layers_b)
            energymodel._stage("schedule solve")
            base = hetero.pareto_codesign(probs, res, n_deadlines=2)
            self._record_cost(key, self._clock() - t0)
            return probs, base.energy, base.latency, res

        out = self._with_retries(run, key=key, budget_end=budget_end)
        self._points[ck] = out
        return out

    # -- incremental grid deltas -------------------------------------------
    def extend_grid(self, new_rows: ConfigGrid) -> Dict[str, Any]:
        """Append config rows to the design space WITHOUT re-streaming it.

        Every completed streamed sweep folds just the appended rows via
        :func:`repro_torch.core.energymodel.merge_layer_topk` —
        bit-identical to a from-scratch stream over the grown grid,
        because all streamed reductions tie-break by (value, flat index).  The
        subsampled tier keeps the same stride, and ``arange(0, n,
        stride)`` is a prefix of ``arange(0, n + k, stride)``, so it
        delta-folds too.  Only the store groups keyed on the two
        superseded grid hashes are invalidated; solved chip points and
        in-flight checkpoints are dropped (their inputs changed), and the
        merged streams are re-persisted under the new hashes."""
        if sorted(new_rows.fields) != sorted(self.grid.fields):
            raise ValueError(
                f"extend_grid: column mismatch — grid has "
                f"{sorted(self.grid.fields)}, new rows have "
                f"{sorted(new_rows.fields)}")
        old_n = self.grid.n
        old_sub_n = int(self._sub_idx.size)
        old_hashes = (self._grid_hash, self._sub_hash)

        new_grid = ConfigGrid.concat([self.grid, new_rows])
        new_sub_idx = np.arange(0, new_grid.n, self._stride)
        delta_sub = new_sub_idx[old_sub_n:] - old_n  # rows INTO new_rows

        merged: Dict[Tuple[str, str], energymodel.LayerTopK] = {}
        n_folds = 0
        for (tier, metric), st in self._streams.items():
            if tier == "exact":
                drows = new_rows
            elif delta_sub.size:
                drows = new_rows.take(delta_sub)
            else:                  # no new stride multiple: tier unchanged
                merged[(tier, metric)] = st
                continue
            v = self._make_verifier()
            try:
                delta = energymodel.stream_layer_topk(
                    drows, self.networks, device=self.device,
                    backend=self.backend, topk=self.topk, bound=self.bound,
                    metric=metric, chunk_size=self.chunk_size, verify=v)
            finally:
                self._harvest_verify(v)
            merged[(tier, metric)] = energymodel.merge_layer_topk(
                st, delta)
            n_folds += 1

        self.grid = new_grid
        self._sub_idx = new_sub_idx
        self._sub_grid = new_grid.take(new_sub_idx)
        self._grid_hash = store_mod.grid_hash(self.grid)
        self._sub_hash = store_mod.grid_hash(self._sub_grid)
        self._streams = merged
        self._points.clear()           # candidate pools may change
        for key in list(self._ckpt):   # mid-stream state is now stale
            self._drop_ckpt(key)
        invalidated = 0
        if self.store is not None:
            for h in old_hashes:
                invalidated += self.store.invalidate_group(h)
            for (tier, metric), st in self._streams.items():
                self._persist_stream(tier, metric, st)
        self.stats["grid_extensions"] += 1
        self.stats["delta_folds"] += n_folds
        self.stats["cache_invalidated"] += invalidated
        return dict(added=int(new_rows.n), n_cfg=int(self.grid.n),
                    n_cfg_degraded=int(self._sub_grid.n),
                    delta_folds=n_folds, invalidated=invalidated)

    def _record_cost(self, key: tuple, dt: float):
        prev = self._cost.get(key)
        self._cost[key] = dt if prev is None else 0.5 * prev + 0.5 * dt

    def _projected_exact_cost(self, metric: str, chip_family: bool
                              ) -> Optional[float]:
        """Projected seconds for the exact artifact: measured cost if
        known, else the subsampled tier's measured cost scaled by point
        ratio — None when neither has run yet."""
        scale = self.grid.n / max(self._sub_grid.n, 1)
        total = 0.0
        known = False
        stages = ["stream", "points"] if chip_family else ["stream"]
        for stage in stages:
            k_ex = (stage, "exact", metric)
            k_sub = (stage, "sub", metric)
            if k_ex in self._cost:
                total += self._cost[k_ex]
                known = True
            elif k_sub in self._cost:
                total += self._cost[k_sub] * scale * self.safety
                known = True
        return total if known else None

    # -- serving -----------------------------------------------------------
    def step(self) -> List[DSEResponse]:
        """Serve ONE coalesced batch: every queued request sharing the
        head request's family and metric.

        An idle tick (empty queue) spends itself on the background
        scrubber instead: ONE store entry is audited per tick, the
        cursor carrying across ticks, so a service that keeps stepping
        while idle eventually re-verifies its whole cache."""
        if not self._queue:
            if (self._idle_scrub and self.verify
                    and self.store is not None):
                res = self.scrub(max_entries=1,
                                 cursor=self._scrub_cursor)
                self._scrub_cursor = res["cursor"]
            return []
        head = self._queue[0]
        family = self._family(head.kind)
        batch = [r for r in self._queue
                 if self._family(r.kind) == family
                 and r.metric == head.metric]
        ids = {id(r) for r in batch}
        self._queue = [r for r in self._queue if id(r) not in ids]
        if len(batch) > 1:
            self.stats["coalesced_batches"] += 1
        t0 = self._clock()
        if family == "resched":
            out = self._serve_resched(batch, head.metric)
        else:
            out = self._serve_batch(batch, head.metric, family == "chip")
        self._record_cost(("request",),
                          (self._clock() - t0) / max(len(batch), 1))
        self.responses.extend(out)
        return out

    def _serve_batch(self, batch, metric, chip_family):
        # persistent answer tier: a request whose EXACT answer is already
        # in the store is served without touching a single sweep — the
        # warm-restart path costs one npz read per query
        served = []
        if self.store is not None:
            rest = []
            for r in batch:
                got = self.store.get(self._answer_key(r, metric))
                if got is not None:
                    self.stats["answer_hits"] += 1
                    served.append(self._respond(r, ok=True, degraded=False,
                                                answer=got[1]))
                else:
                    rest.append(r)
            if not rest:
                return served
            batch = rest
        now = self._clock()

        def rem(r):
            if r.deadline_s is None:
                return None
            return r.deadline_s - (now - r.submitted_at)

        exact_ready = (("exact", metric) in
                       (self._points if chip_family else self._streams))
        if exact_ready:
            exact_grp, degraded_grp = list(batch), []
        else:
            # the sub tier is cheap, always useful (degraded answers) and
            # calibrates the exact-cost projection — build it first
            try:
                self._ensure_tier(metric, chip_family, exact=False,
                                  budget_end=None)
            except ServiceFault as e:
                return served + [self._respond(r, ok=False, degraded=True,
                                               answer={}, error=str(e))
                                 for r in batch]
            proj = self._projected_exact_cost(metric, chip_family)
            exact_grp, degraded_grp = [], []
            for r in batch:
                budget = rem(r)
                if budget is not None and (
                        budget <= 0 or (proj is not None and budget < proj)):
                    degraded_grp.append(r)
                else:
                    exact_grp.append(r)
        if exact_grp and not exact_ready:
            ends = [r.submitted_at + r.deadline_s for r in exact_grp
                    if r.deadline_s is not None]
            budget_end = (None if len(ends) < len(exact_grp)
                          else max(ends))
            try:
                self._ensure_tier(metric, chip_family, exact=True,
                                  budget_end=budget_end)
            except (_BudgetExhausted, ServiceFault):
                # budget ran out mid-stream (checkpoint retained for the
                # next caller) or the retries are exhausted — degrade
                degraded_grp.extend(exact_grp)
                exact_grp = []
        out = []
        for grp, degraded in ((exact_grp, False), (degraded_grp, True)):
            if not grp:
                continue
            try:
                out.extend(self._answer_group(grp, metric, chip_family,
                                              degraded=degraded))
            except ServiceFault as e:        # pragma: no cover
                out.extend(self._respond(r, ok=False, degraded=degraded,
                                         answer={}, error=str(e))
                           for r in grp)
        return served + out

    # -- hardware-fault re-scheduling --------------------------------------
    def fault_event(self, chip_types: Sequence[int],
                    chip_counts: Sequence[int],
                    scenario: hw_faults.FaultScenario, *,
                    metric: str = "edp",
                    deadline_s: Optional[float] = None) -> SubmitResult:
        """A hardware fault was reported on a deployed chip: invalidate
        every cached schedule of that chip (nominal included — its
        hardware is no longer what those schedules assumed) and enqueue
        the re-schedule query.  Returns the :class:`SubmitResult`; the
        answer arrives through the normal :meth:`step` loop."""
        self.stats["fault_events"] += 1
        ct = tuple(int(t) for t in chip_types)
        cc = tuple(int(c) for c in chip_counts)
        stale = [k for k in self._resched if k[0] == ct and k[1] == cc]
        for k in stale:
            del self._resched[k]
        self.stats["schedule_invalidations"] += len(stale)
        return self.submit("reschedule", metric=metric,
                           deadline_s=deadline_s, chip_types=ct,
                           chip_counts=cc, scenario=scenario)

    @staticmethod
    def _resched_key(r: DSERequest, metric: str) -> tuple:
        return (r.chip_types, r.chip_counts, r.scenario.key(), metric)

    def _serve_resched(self, batch, metric):
        now = self._clock()
        out, misses = [], []
        for r in batch:
            ans = self._resched.get(self._resched_key(r, metric))
            if ans is not None:
                self.stats["resched_cache_hits"] += 1
                out.append(self._respond(r, ok=True, degraded=False,
                                         answer=ans))
            else:
                self.stats["resched_cache_misses"] += 1
                misses.append(r)
        if not misses:
            return out
        # degradation rung: a request whose remaining budget cannot cover
        # the projected solve is answered from the chip's cached NOMINAL
        # schedule (flagged degraded) when one exists; with no fallback it
        # computes anyway and the deadline_missed flag tells the story.
        proj = self._cost.get(("resched", metric))
        compute, late = [], set()
        for r in misses:
            budget = (None if r.deadline_s is None
                      else r.deadline_s - (now - r.submitted_at))
            if budget is not None and (
                    budget <= 0 or (proj is not None and budget < proj)):
                nom = self._resched.get(
                    (r.chip_types, r.chip_counts, (), metric))
                if nom is not None:
                    out.append(self._respond(
                        r, ok=True, degraded=True,
                        answer=dict(nom, scenario=r.scenario.name,
                                    nominal_only=True)))
                    continue
                late.add(r.rid)
            compute.append(r)
        if not compute:
            return out
        ends = [r.submitted_at + r.deadline_s for r in compute
                if r.deadline_s is not None]
        budget_end = max(ends) if len(ends) == len(compute) else None
        key = ("resched", metric)

        def run(backend, resume):
            t0 = self._clock()
            answers = self._solve_resched(compute, metric, backend)
            self._record_cost(key,
                              (self._clock() - t0) / len(compute))
            return answers

        try:
            answers = self._with_retries(run, key=key,
                                         budget_end=budget_end)
        except (_BudgetExhausted, ServiceFault) as e:
            out.extend(self._respond(r, ok=False, degraded=True,
                                     answer={}, error=str(e))
                       for r in compute)
            return out
        for r, (nom_ans, ans) in zip(compute, answers):
            self._resched[(r.chip_types, r.chip_counts, (),
                           metric)] = nom_ans
            self._resched[self._resched_key(r, metric)] = ans
            self.stats["reschedules"] += 1
            out.append(self._respond(r, ok=True,
                                     degraded=r.rid in late, answer=ans))
        return out

    def _solve_resched(self, reqs, metric, backend):
        """Coalesced fault re-schedule: ONE union-grid engine evaluation
        and ONE ``batch_schedule_hetero(strict=False)`` call cover every
        (request, {nominal, fault}, network) problem; returns one
        ``(nominal answer, fault answer)`` pair per request."""
        batches = [hw_faults.expand_scenarios(
            self.grid, r.chip_types, r.chip_counts, [r.scenario],
            include_nominal=True) for r in reqs]
        union = ConfigGrid.concat([b.grid for b in batches])
        e_l, t_l = energymodel.evaluate_networks(
            union, self.networks, device=self.device, backend=backend,
            per_layer=True)
        energymodel._stage("degraded evaluation")
        lens = energymodel.network_layer_counts(self.networks)
        n_net = len(self.names)
        t_max = max(b.n_types for b in batches)
        lats, cnts, nls, ens, labels = [], [], [], [], []
        off = 0
        for r, b in zip(reqs, batches):
            lat, cnt, nl, en = hw_faults.scenario_problems(
                b, e_l[off:off + b.grid.n], t_l[off:off + b.grid.n], lens)
            off += b.grid.n
            pad = t_max - lat.shape[1]
            if pad:
                lat = np.pad(lat, ((0, 0), (0, pad), (0, 0)))
                en = np.pad(en, ((0, 0), (0, pad), (0, 0)))
                cnt = np.pad(cnt, ((0, 0), (0, pad)))
            lats.append(lat)
            cnts.append(cnt)
            nls.append(nl)
            ens.append(en)
            labels.extend(f"rid{r.rid}:{sn}:{nm}"
                          for sn in b.names for nm in self.names)
        res = partition.batch_schedule_hetero(
            np.concatenate(lats), np.concatenate(cnts),
            n_layers=np.concatenate(nls), strict=False,
            labels=labels)
        energymodel._stage("scenario solve")
        en_all = np.concatenate(ens)

        def one(i, nl_i):
            feas = bool(res.feasible[i])
            tt = res.layer_type[i, :nl_i]
            energy = float(np.take_along_axis(
                en_all[i][:, :nl_i], tt[None, :],
                axis=0)[0].sum()) if feas else float("inf")
            return dict(feasible=feas,
                        bottleneck=float(res.bottleneck[i]),
                        energy=energy,
                        layer_type=tt.tolist() if feas else None)

        out = []
        ro = 0
        for r, b in zip(reqs, batches):
            nets_nom, nets_f = {}, {}
            for j, nm in enumerate(self.names):
                nl_i = int(lens[j])
                nom = one(ro + j, nl_i)
                fl = one(ro + n_net + j, nl_i)
                nom["overhead"] = 1.0 if nom["feasible"] else float("inf")
                fl["overhead"] = (
                    fl["bottleneck"] / nom["bottleneck"]
                    if fl["feasible"] and nom["bottleneck"] > 0
                    else float("inf"))
                nets_nom[nm], nets_f[nm] = nom, fl
            base = dict(chip_types=list(r.chip_types),
                        chip_counts=list(r.chip_counts))
            nom_ans = dict(base, scenario="nominal",
                           counts_after=list(r.chip_counts),
                           feasible=all(v["feasible"]
                                        for v in nets_nom.values()),
                           networks=nets_nom)
            ans = dict(base, scenario=r.scenario.name,
                       counts_after=[int(c) for c in b.counts[1]],
                       feasible=all(v["feasible"]
                                    for v in nets_f.values()),
                       networks=nets_f)
            out.append((nom_ans, ans))
            ro += 2 * n_net
        return out

    def _ensure_tier(self, metric, chip_family, *, exact, budget_end):
        if chip_family:
            self._get_points(metric, exact=exact, budget_end=budget_end)
        else:
            self._get_stream(metric, exact=exact, budget_end=budget_end)

    def _answer_group(self, grp, metric, chip_family, *, degraded):
        tier_exact = not degraded
        _, _, idx_map = self._tier(tier_exact)
        if not chip_family:
            stream = self._get_stream(metric, exact=tier_exact)
            out = []
            for r in grp:
                ans = self._config_answer(r, stream, idx_map)
                self._cache_answer(r, metric, ans, degraded=degraded)
                out.append(self._respond(r, ok=True, degraded=degraded,
                                         answer=ans))
            return out
        probs, pts_e, pts_l, res = self._get_points(metric,
                                                    exact=tier_exact)
        deadlines = sorted({float(r.deadline) for r in grp})
        par = hetero.pareto_codesign(probs, res,
                                     deadlines=np.asarray(deadlines),
                                     points=(pts_e, pts_l), slack=True)
        out = []
        for r in grp:
            di = deadlines.index(float(r.deadline))
            if r.kind == "best_chip":
                ans = self._chip_answer(par, probs, di, idx_map)
            else:
                # the slack union is restricted to THIS request's deadline
                # so the answer is independent of the coalesced batch's
                # other deadlines — a precondition for caching it and for
                # restart-replay bit-parity (the restarted batch is a
                # subset of the original one)
                ans = dict(network=r.network,
                           frontier=par.frontier(r.network),
                           slack_frontier=par.slack_frontier(
                               r.network, deadline_index=di),
                           pool=[int(idx_map[p]) for p in probs.pool])
            self._cache_answer(r, metric, ans, degraded=degraded)
            out.append(self._respond(r, ok=True, degraded=degraded,
                                     answer=ans))
        return out

    def _cache_answer(self, r, metric, ans, *, degraded):
        """Persist one EXACT answer (degraded ones are budget artefacts,
        not functions of the design space — never cached).  The JSON
        round trip returns lists where the computed answer had tuples;
        see the note in :mod:`repro_torch.serving.store`."""
        if self.store is None or degraded:
            return
        self.store.put(self._answer_key(r, metric), meta=ans)

    def _config_answer(self, r, stream, idx_map):
        def one(j):
            return dict(
                idx=int(idx_map[stream.argmin[j]]),
                metric=float(stream.min_metric[j]),
                energy=float(stream.min_energy[j]),
                latency=float(stream.min_latency[j]))
        if r.network is not None:
            return one(self.names.index(r.network))
        return {nm: one(j) for j, nm in enumerate(self.names)}

    def _chip_answer(self, par, probs, di, idx_map):
        ci = int(par.best_chip[di])
        if ci < 0:
            return dict(feasible=False, deadline=float(par.deadlines[di]))
        ans = dict(
            feasible=True, deadline=float(par.deadlines[di]),
            chip_types=[int(idx_map[probs.pool[p]])
                        for p in par.chip_types[ci]],
            chip_counts=[int(c) for c in par.chip_counts[ci]],
            score=float(par.scores[ci, di]))
        if par.slack_scores is not None:
            cs = int(par.best_chip_slack[di])
            ans["slack"] = dict(
                chip_types=[int(idx_map[probs.pool[p]])
                            for p in par.chip_types[cs]],
                chip_counts=[int(c) for c in par.chip_counts[cs]],
                score=float(par.slack_scores[cs, di]),
                moves=int(par.slack_moves[cs, :, di].sum()),
                energy_saved_pct=float(
                    (1.0 - par.slack_scores[cs, di] / par.scores[cs, di])
                    * 100.0))
        return ans

    def _respond(self, r, *, ok, degraded, answer, error=None):
        lat = self._clock() - r.submitted_at
        missed = r.deadline_s is not None and lat > r.deadline_s
        self.stats["completed"] += 1
        self.stats["degraded"] += int(degraded and ok)
        self.stats["deadline_missed"] += int(missed)
        self.stats["errors"] += int(not ok)
        self._lat.append(lat)          # deque(maxlen=) bounds the window
        if self._journal is not None:
            self._journal.done(r.rid)  # answered — replay skips this rid
        return DSEResponse(rid=r.rid, kind=r.kind, ok=ok,
                           degraded=degraded, deadline_missed=missed,
                           answer=answer, error=error, latency_s=lat,
                           backend=energymodel.last_backend())

    def run_until_drained(self, max_steps: int = 1000,
                          timeout_s: Optional[float] = None
                          ) -> Tuple[List[DSEResponse], bool]:
        """Step until the queue empties; ``(responses, drained)`` where
        ``drained=False`` means max_steps/timeout stopped it early."""
        out: List[DSEResponse] = []
        t0 = self._clock()
        for _ in range(max_steps):
            if not self._queue:
                return out, True
            if timeout_s is not None and self._clock() - t0 > timeout_s:
                return out, False
            out.extend(self.step())
        return out, not self._queue

    # -- observability -----------------------------------------------------
    def health(self) -> Dict[str, Any]:
        lat = sorted(self._lat)

        def pct(p):
            if not lat:
                return 0.0
            return float(lat[min(int(p * (len(lat) - 1)), len(lat) - 1)])
        return dict(
            uptime_s=self._clock() - self._t0,
            queue_depth=len(self._queue),
            max_queue=self.max_queue,
            n_cfg=self.grid.n,
            n_cfg_degraded=self._sub_grid.n,
            checkpoints=len(self._ckpt),
            last_backend=energymodel.last_backend(),
            p50_s=pct(0.50), p99_s=pct(0.99), n_lat=len(lat),
            lat_window=self.lat_window,
            state_dir=self.state_dir,
            store=None if self.store is None else self.store.health(),
            **self.stats)
