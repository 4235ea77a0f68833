"""Silent-data-corruption defense for the port's streamed DSE engine.

The port's copy of ``repro.ft.verify``.  The chunk guard
(:func:`repro_torch.core.energymodel._guard_chunk`) trips only on NaN/inf;
a bit-flip or miscompile that yields a plausible FINITE wrong value sails
through it, is checksummed by the durable store and then served as a
cached exact answer.  This module is the ladder against that:

* :class:`StreamVerifier`, passed as ``verify=`` to
  :func:`repro_torch.core.energymodel.stream_networks` /
  :func:`~repro_torch.core.energymodel.stream_layer_topk`:

  1. **Fold invariants** after every chunk, BEFORE the new state commits:
     running minima never increase, top-k rows stay (value, flat
     index)-lex sorted without duplicate indices, the metric minimum is
     the best top-k value, per-layer rows sum to the ranked aggregate,
     boundary hits lie within ``bound`` of the updated minimum.  A
     violation raises :class:`FoldInvariantError` with provenance.
  2. **Sampled shadow recompute**: a seeded share of chunks
     (``verify_fraction``) is re-evaluated on the port's plain path —
     ``backend="torch"`` on the CPU in float64, the engine's ``ref_eval``
     — and compared: bit for bit when the chunk itself was computed by
     ``backend="torch"`` on the CPU (the same computation), else within
     :data:`SHADOW_RTOL`.  A mismatch raises :class:`ShadowMismatchError`
     with (grid row, network, term) provenance.

* :func:`check_layer_topk_result` / :func:`scrub_layer_topk`: the at-rest
  rung — structural invariants plus a sampled re-derivation of a
  completed (possibly store-loaded) ``LayerTopK``'s rows on the same
  plain path.

Where the checks run.  The engine hands over device tensors; every check
works on a host copy (the carried state and the chunk's ``[rows, n_net]``
aggregates each chunk, the whole per-layer chunk only when it is sampled
for the shadow), so the checks are the reference's numpy code line for
line.  Sampling depends on ``(seed, chunk)`` alone, so a resumed stream
samples the chunks an uninterrupted one would.  With
``REPRO_VERIFY_EVIDENCE_DIR`` set, every mismatch writes its provenance
there as JSON before raising.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import energymodel
from ..core.energymodel import _to_host

#: Relative tolerance of a shadow comparison against a chunk computed by
#: another route than the shadow's own (the CUDA kernels, or torch on the
#: card, whose float64 sums may round differently): ~4 decades above
#: last-ulp noise, ~9 below an injected 1e-3 perturbation.
SHADOW_RTOL = 1e-12

#: Relative tolerance for "per-layer rows sum to the aggregate": the fold
#: summed on the device, the checker re-sums on the host.
SUM_RTOL = 1e-9


class FoldInvariantError(RuntimeError):
    """A streamed fold state violates a structural invariant.

    Raised BEFORE the offending state commits (or, for resumed states,
    before any chunk folds into it); carries the violated ``invariant``
    name plus chunk / grid row / network provenance."""

    def __init__(self, msg: str, *, invariant: str, chunk: int | None = None,
                 start: int | None = None, stop: int | None = None,
                 network: str | None = None, row: int | None = None):
        super().__init__(msg)
        self.invariant = invariant
        self.chunk = chunk
        self.start = start
        self.stop = stop
        self.network = network
        self.row = row


class ShadowMismatchError(RuntimeError):
    """A chunk evaluation diverges from the plain-path shadow recompute.

    ``mismatches`` holds one provenance dict per diverging element —
    ``{"row": <flat grid row>, "network": <name>, "term": "energy" |
    "latency" (with the layer index in per-layer streams), "got": ...,
    "want": ...}`` — capped at ``MAX_MISMATCH_RECORDS``."""

    MAX_MISMATCH_RECORDS = 32

    def __init__(self, msg: str, *, chunk: int, start: int, stop: int,
                 mismatches: Sequence[Dict[str, Any]] = ()):
        super().__init__(msg)
        self.chunk = int(chunk)
        self.start = int(start)
        self.stop = int(stop)
        self.mismatches = list(mismatches)[:self.MAX_MISMATCH_RECORDS]


def _dump_evidence(kind: str, payload: Dict[str, Any]) -> None:
    """Persist mismatch provenance where ``REPRO_VERIFY_EVIDENCE_DIR``
    points; best-effort, never masks the raise."""
    root = os.environ.get("REPRO_VERIFY_EVIDENCE_DIR")
    if not root:
        return
    try:
        os.makedirs(root, exist_ok=True)
        n = len(os.listdir(root))
        path = os.path.join(root, f"{kind}_{n:04d}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, default=str)
    except OSError:                                    # pragma: no cover
        pass


@dataclasses.dataclass
class VerifyConfig:
    """Knobs of one :class:`StreamVerifier`.

    ``verify_fraction`` is the seeded share of chunks shadow-recomputed
    (1.0 = every chunk, 0.0 = invariants only); ``rtol=None`` picks 0.0
    (bit for bit) for a chunk computed on the shadow's own path and
    :data:`SHADOW_RTOL` otherwise."""

    verify_fraction: float = 1.0 / 16.0
    seed: int = 0
    invariants: bool = True
    shadow: bool = True
    rtol: Optional[float] = None
    sum_rtol: float = SUM_RTOL


class StreamVerifier:
    """Per-stream verification hooks; pass as ``verify=`` to the engines.

    The engine calls :meth:`bind` once at stream start (the reduction
    parameters, its backend and the plain-path chunk evaluator
    ``ref_eval``), then :meth:`check_chunk` (shadow) and
    :meth:`check_fold` (invariants) per chunk and :meth:`check_resume`
    on resumed states.  ``stats`` counts checks and violations;
    violations also raise."""

    def __init__(self, config: VerifyConfig | None = None, **kw):
        self.cfg = config if config is not None else VerifyConfig(**kw)
        self.stats: Dict[str, int] = dict(
            shadow_checks=0, shadow_mismatches=0,
            invariant_checks=0, invariant_violations=0)
        self._kind: Optional[str] = None
        self._names: Tuple[str, ...] = ()
        self._metric = "edp"
        self._topk = 0
        self._bound: Optional[float] = None
        self._backend: Optional[str] = None
        self._ref_eval: Optional[Callable] = None

    # -- engine contract ---------------------------------------------------

    def bind(self, *, kind: str, names: Sequence[str], metric: str,
             topk: int, bound: Optional[float], backend: str,
             ref_eval: Optional[Callable] = None) -> None:
        """Called by the engine at stream start.  ``ref_eval(fc)`` returns
        the plain-path numpy ``(e, t)`` of one chunk's columns."""
        self._kind = kind
        self._names = tuple(names)
        self._metric = metric
        self._topk = int(topk)
        self._bound = None if bound is None else float(bound)
        self._backend = backend
        self._ref_eval = ref_eval

    def rtol_for(self, e) -> float:
        """The shadow tolerance for a chunk tensor: 0 (bit for bit) when it
        was computed on the shadow's own path — ``backend="torch"`` on the
        CPU (or, for the reference's engine, its numpy path) — else
        :data:`SHADOW_RTOL`."""
        if self.cfg.rtol is not None:
            return float(self.cfg.rtol)
        on_host = (e.device.type == "cpu" if isinstance(e, torch.Tensor)
                   else True)
        exact = on_host and self._backend in ("torch", "numpy")
        return 0.0 if exact else SHADOW_RTOL

    def sampled(self, ci: int) -> bool:
        """Deterministic per-chunk sampling from ``(seed, chunk)`` alone —
        independent of the chunk count and of any resume point."""
        f = self.cfg.verify_fraction
        if f >= 1.0:
            return True
        if f <= 0.0:
            return False
        return bool(np.random.default_rng(
            (int(self.cfg.seed), int(ci))).random() < f)

    # -- shadow recompute --------------------------------------------------

    def check_chunk(self, ci: int, start: int, stop: int, fc, e, t) -> None:
        """Sampled shadow recompute of one chunk (copied to the host)."""
        if not self.cfg.shadow or self._ref_eval is None:
            return
        if not self.sampled(ci):
            return
        self.stats["shadow_checks"] += 1
        rtol = self.rtol_for(e)
        e, t = _to_host(e), _to_host(t)
        e_ref, t_ref = self._ref_eval(fc)
        # the port's chunks are unpadded; a padded chunk (the reference's
        # engine) compares whole, its padding rows duplicating its first
        m = stop - start
        mism: List[Dict[str, Any]] = []
        for term, got, want in (("energy", e, _to_host(e_ref)),
                                ("latency", t, _to_host(t_ref))):
            if rtol == 0.0:
                bad = (got != want) & ~(np.isnan(got) & np.isnan(want))
            else:
                bad = ~np.isclose(got, want, rtol=rtol, atol=0.0,
                                  equal_nan=True)
            for pos in np.argwhere(bad):
                r, j = int(pos[0]), int(pos[1])
                layer = f"[layer {int(pos[2])}]" if len(pos) > 2 else ""
                pad = " (padding dup of first row)" if r >= m else ""
                mism.append(dict(
                    row=(start + r if r < m else start),
                    network=self._names[j],
                    term=f"{term}{layer}{pad}",
                    got=float(got[tuple(pos)]),
                    want=float(want[tuple(pos)])))
        if not mism:
            return
        self.stats["shadow_mismatches"] += 1
        worst = mism[0]
        err = ShadowMismatchError(
            f"shadow recompute mismatch in streamed chunk {ci} (grid rows "
            f"{start}:{stop}): {len(mism)} element(s) diverge from the "
            f"plain torch path beyond rtol={rtol:g}; first at grid row "
            f"{worst['row']}, network {worst['network']}, term "
            f"{worst['term']} (got {worst['got']!r}, want "
            f"{worst['want']!r}).  The fold state was NOT updated with "
            f"this chunk — retry the chunk or resume from the last "
            f"exported state", chunk=ci, start=start, stop=stop,
            mismatches=mism)
        _dump_evidence("shadow_mismatch", dict(
            chunk=ci, start=start, stop=stop, rtol=rtol,
            kind=self._kind, metric=self._metric,
            mismatches=err.mismatches))
        raise err

    # -- fold invariants ---------------------------------------------------

    def check_fold(self, ci: int, start: int, stop: int, prev_state,
                   new_state, *, es=None, ts=None, mask=None) -> None:
        """Invariant-check the post-chunk state BEFORE it commits."""
        if not self.cfg.invariants:
            return
        self.stats["invariant_checks"] += 1
        try:
            prov = dict(chunk=ci, start=start, stop=stop)
            new_state = tuple(_to_host(s) for s in new_state)
            prev_state = (None if prev_state is None
                          else tuple(_to_host(s) for s in prev_state))
            if self._kind == "networks":
                self._check_networks_state(prev_state, new_state, prov)
            else:
                self._check_layer_state(prev_state, new_state, prov)
            if mask is not None and self._bound is not None:
                self._check_boundary_hits(new_state, es, ts, mask, start,
                                          prov)
        except FoldInvariantError as err:
            self.stats["invariant_violations"] += 1
            _dump_evidence("invariant_violation", dict(
                chunk=ci, start=start, stop=stop, kind=self._kind,
                invariant=err.invariant, network=err.network, row=err.row,
                message=str(err)))
            raise

    def check_resume(self, state, cand) -> None:
        """Invariant-check a RESUMED fold state before any chunk folds
        into it: checkpoint files carry no checksum, so a finite
        corruption of the npz payload is caught only here."""
        if not self.cfg.invariants:
            return
        self.stats["invariant_checks"] += 1
        try:
            prov: Dict[str, Any] = dict(chunk=None, start=None, stop=None)
            state = tuple(_to_host(s) for s in state)
            self._check_finite_state(state, prov)
            if self._kind == "networks":
                self._check_networks_state(None, state, prov)
                min_m = state[2]
            else:
                self._check_layer_state(None, state, prov)
                min_m = state[7]
            self._check_cand(cand, min_m, prov)
        except FoldInvariantError as err:
            self.stats["invariant_violations"] += 1
            _dump_evidence("invariant_violation", dict(
                where="resume", kind=self._kind,
                invariant=err.invariant, network=err.network, row=err.row,
                message=str(err)))
            raise

    # -- invariant internals (host numpy) ------------------------------------

    def _raise(self, invariant: str, detail: str, prov: Dict[str, Any],
               *, network: str | None = None, row: int | None = None):
        where = ("resumed fold state" if prov.get("chunk") is None else
                 f"streamed chunk {prov['chunk']} (grid rows "
                 f"{prov['start']}:{prov['stop']})")
        raise FoldInvariantError(
            f"fold invariant {invariant!r} violated after {where}: "
            f"{detail}; the poisoned state was NOT committed",
            invariant=invariant, chunk=prov.get("chunk"),
            start=prov.get("start"), stop=prov.get("stop"),
            network=network, row=row)

    def _check_finite_state(self, state, prov):
        for i, a in enumerate(state):
            if a.dtype.kind == "f" and np.isnan(a).any():
                self._raise("state_finite",
                            f"state array {i} contains NaN", prov)

    def _check_monotone(self, label, prev, new, prov):
        """Running minima may only move down (or stay); +inf "not seen
        yet" sentinels compare equal, never worse."""
        worse = new > prev
        if worse.any():
            pos = np.argwhere(worse)[0]
            j = int(pos[0]) if pos.size else None
            nm = (self._names[j] if j is not None and j < len(self._names)
                  else None)
            self._raise(
                "monotone_min",
                f"running {label} increased at position {tuple(pos)} "
                f"(network {nm if nm is not None else j})",
                prov, network=nm)

    def _check_topk(self, top_v, top_i, prov):
        """Top-k rows must be (value, flat-index)-lex sorted per network
        with no duplicate valid indices; -1 sentinels (unfilled slots)
        carry +inf and may repeat."""
        for j, nm in enumerate(self._names):
            v, i = top_v[:, j], top_i[:, j]
            if np.isnan(v).any():
                self._raise("topk_sorted", f"NaN in top-k values of {nm}",
                            prov, network=nm)
            with np.errstate(invalid="ignore"):   # inf-inf on sentinels
                dv, di = np.diff(v), np.diff(i)
                bad = (dv < 0) | ((dv == 0) & (di < 0) & (i[1:] >= 0))
            if bad.any():
                k = int(np.nonzero(bad)[0][0])
                self._raise(
                    "topk_sorted",
                    f"top-k rows {k}..{k + 1} of network {nm} are not "
                    f"(value, flat-index)-lex sorted: "
                    f"({v[k]!r}, {i[k]}) then ({v[k + 1]!r}, {i[k + 1]})",
                    prov, network=nm, row=int(i[k + 1]))
            valid = i[i >= 0]
            if valid.size != np.unique(valid).size:
                dup = valid[np.nonzero(np.diff(np.sort(valid)) == 0)[0][0]]
                self._raise(
                    "topk_unique",
                    f"duplicate flat grid index {int(dup)} in the top-k "
                    f"of network {nm}", prov, network=nm, row=int(dup))

    def _check_min_is_top(self, min_m, top_v, prov):
        """The running metric minimum IS the best top-k value: both fold
        the same chunk values."""
        best = top_v[0]
        bad = (min_m != best) & ~(np.isinf(min_m) & np.isinf(best))
        if bad.any():
            j = int(np.nonzero(bad)[0][0])
            self._raise(
                "min_equals_top",
                f"running min_metric {min_m[j]!r} != best top-k value "
                f"{best[j]!r} for network {self._names[j]}",
                prov, network=self._names[j])

    def _check_networks_state(self, prev, new, prov):
        min_e, min_t, min_m, argm, top_v, top_i = new
        if prev is not None:
            for label, p, q in (("min_energy", prev[0], min_e),
                                ("min_latency", prev[1], min_t),
                                ("min_metric", prev[2], min_m)):
                self._check_monotone(label, p, q, prov)
        self._check_topk(top_v, top_i, prov)
        self._check_min_is_top(min_m, top_v, prov)

    def _check_layer_state(self, prev, new, prov):
        (top_v, top_i, top_e, top_t, min_e, min_t, min_edp, min_m, argm,
         lmin, larg) = new
        if prev is not None:
            for label, p, q in (("min_energy", prev[4], min_e),
                                ("min_latency", prev[5], min_t),
                                ("min_edp", prev[6], min_edp),
                                ("min_metric", prev[7], min_m),
                                ("layer_min_metric", prev[9], lmin)):
                self._check_monotone(label, p, q, prov)
        self._check_topk(top_v, top_i, prov)
        self._check_min_is_top(min_m, top_v, prov)
        # per-layer rows reproduce the aggregate the row was ranked by
        with np.errstate(invalid="ignore"):       # inf*0 on -1 sentinels
            agg = energymodel._metric_of(self._metric, top_e.sum(-1),
                                         top_t.sum(-1))
        valid = top_i >= 0
        if valid.any():
            with np.errstate(invalid="ignore"):   # inf-inf on sentinels
                err = (np.abs(agg - top_v)
                       > self.cfg.sum_rtol * np.abs(top_v))
            bad = valid & err
            if bad.any():
                k, j = (int(x) for x in np.argwhere(bad)[0])
                self._raise(
                    "layer_sum_aggregate",
                    f"per-layer rows of top-{k} config (grid row "
                    f"{int(top_i[k, j])}, network {self._names[j]}) sum "
                    f"to metric {agg[k, j]!r} but the fold ranked it at "
                    f"{top_v[k, j]!r}", prov, network=self._names[j],
                    row=int(top_i[k, j]))

    def _check_boundary_hits(self, new_state, es, ts, mask, start, prov):
        """This chunk's boundary hits lie within ``bound`` of the updated
        running minimum, and none beats the minimum itself."""
        if es is None or ts is None:
            return
        mask = _to_host(mask)
        if not mask.any():
            return
        min_m = new_state[2] if self._kind == "networks" else new_state[7]
        v = energymodel._metric_of(self._metric, _to_host(es), _to_host(ts))
        thresh = min_m[None, :] * (1.0 + self._bound)
        bad = mask & ((v < min_m[None, :]) | (v > thresh))
        if bad.any():
            r, j = (int(x) for x in np.argwhere(bad)[0])
            self._raise(
                "boundary_bound",
                f"boundary hit at grid row {start + r} of network "
                f"{self._names[j]} has metric {v[r, j]!r} outside "
                f"[min, min*(1+bound)] = [{min_m[j]!r}, {thresh[0, j]!r}]",
                prov, network=self._names[j], row=start + r)

    def _check_cand(self, cand, min_m, prov):
        """Resumed boundary candidates: finite, and none beats the fold
        minimum (every candidate was folded into it when collected)."""
        for j, nm in enumerate(self._names):
            for idx, ee, tt in cand.get(nm, ()):
                v = energymodel._metric_of(self._metric, _to_host(ee),
                                           _to_host(tt))
                if np.isnan(v).any():
                    self._raise("boundary_bound",
                                f"NaN boundary candidate in network {nm}",
                                prov, network=nm)
                bad = v < min_m[j]
                if bad.any():
                    r = int(np.nonzero(bad)[0][0])
                    row = int(_to_host(idx)[r])
                    self._raise(
                        "boundary_bound",
                        f"boundary candidate at grid row {row} of network "
                        f"{nm} has metric {v[r]!r} BELOW the running "
                        f"minimum {min_m[j]!r} — the fold missed an update",
                        prov, network=nm, row=row)


# ---------------------------------------------------------------------------
# At-rest verification: completed LayerTopK results and store payloads
# ---------------------------------------------------------------------------


def check_layer_topk_result(st, *, sum_rtol: float = SUM_RTOL
                            ) -> Optional[str]:
    """Structural invariants of a completed (possibly store-loaded)
    :class:`~repro_torch.core.energymodel.LayerTopK`; a reason string on
    the first violation, ``None`` when clean."""
    top_v = np.asarray(st.topk_metric)
    top_i = np.asarray(st.topk_idx)
    for j, nm in enumerate(st.networks):
        v, i = top_v[:, j], top_i[:, j]
        if np.isnan(v).any():
            return f"NaN in top-k metrics of network {nm}"
        with np.errstate(invalid="ignore"):       # inf-inf on sentinels
            dv, di = np.diff(v), np.diff(i)
            unsorted = (dv < 0) | ((dv == 0) & (di < 0) & (i[1:] >= 0))
        if unsorted.any():
            return (f"top-k of network {nm} is not (value, flat-index)-"
                    f"lex sorted")
        valid = i[i >= 0]
        if valid.size != np.unique(valid).size:
            return f"duplicate flat grid index in the top-k of network {nm}"
        if st.min_metric is not None and v.size:
            mm = float(np.asarray(st.min_metric)[j])
            if mm != float(v[0]) and not (np.isinf(mm) and np.isinf(v[0])):
                return (f"min_metric {mm!r} != best top-k value "
                        f"{float(v[0])!r} for network {nm}")
    with np.errstate(invalid="ignore"):           # inf*0 on -1 sentinels
        agg = energymodel._metric_of(
            st.metric, np.asarray(st.layer_energy).sum(-1),
            np.asarray(st.layer_latency).sum(-1))
    with np.errstate(invalid="ignore"):           # inf-inf on -1 sentinels
        bad = ((top_i >= 0)
               & (np.abs(agg - top_v) > sum_rtol * np.abs(top_v)))
    if bad.any():
        k, j = (int(x) for x in np.argwhere(bad)[0])
        return (f"per-layer rows of top-{k} config (grid row "
                f"{int(top_i[k, j])}, network {st.networks[j]}) sum to "
                f"{agg[k, j]!r} but were ranked at {top_v[k, j]!r}")
    if st.bound is not None:
        for j, nm in enumerate(st.networks):
            bv = energymodel._metric_of(st.metric,
                                        np.asarray(st.boundary_energy[nm]),
                                        np.asarray(st.boundary_latency[nm]))
            if np.isnan(bv).any():
                return f"NaN in the boundary set of network {nm}"
            if bv.size:
                mm = float(np.asarray(st.min_metric)[j])
                if (bv < mm).any():
                    return (f"boundary entry of network {nm} beats the "
                            f"minimum {mm!r} — the fold missed an update")
                if (bv > mm * (1.0 + float(st.bound))).any():
                    return (f"boundary entry of network {nm} exceeds "
                            f"min*(1+bound)")
                if (np.diff(bv) < 0).any():
                    return (f"boundary set of network {nm} is not "
                            f"metric-sorted")
    return None


def scrub_layer_topk(st, grid, networks, *, rows: int = 2, seed: int = 0,
                     rtol: float = SHADOW_RTOL,
                     sum_rtol: float = SUM_RTOL) -> Optional[str]:
    """At-rest audit of one stream payload: structural invariants plus a
    seeded sample of its top-k rows re-derived on the plain path
    (``evaluate_networks(per_layer=True, backend="torch")`` of exactly
    those grid rows on the CPU) and compared within ``rtol``.  Returns a
    quarantine reason, or ``None`` when the payload checks out."""
    reason = check_layer_topk_result(st, sum_rtol=sum_rtol)
    if reason is not None:
        return reason
    top_i = np.asarray(st.topk_idx)
    cells = np.argwhere(top_i >= 0)
    if not cells.size or rows <= 0:
        return None
    rng = np.random.default_rng(seed)
    pick = cells[rng.choice(len(cells), size=min(int(rows), len(cells)),
                            replace=False)]
    rows_idx = np.unique(top_i[pick[:, 0], pick[:, 1]])
    e_ref, t_ref = energymodel.evaluate_networks(
        grid.take(rows_idx), networks, device="cpu", backend="torch",
        per_layer=True)
    pos = {int(r): i for i, r in enumerate(rows_idx)}
    for k, j in pick:
        k, j = int(k), int(j)
        gi = int(top_i[k, j])
        i = pos[gi]
        nm = st.networks[j]
        for term, stored, ref in (
                ("energy", np.asarray(st.layer_energy)[k, j], e_ref[i, j]),
                ("latency", np.asarray(st.layer_latency)[k, j],
                 t_ref[i, j])):
            bad = ~np.isclose(stored, ref, rtol=rtol, atol=0.0)
            if bad.any():
                li = int(np.nonzero(bad)[0][0])
                _dump_evidence("scrub_mismatch", dict(
                    grid_row=gi, network=nm, term=f"{term}[layer {li}]",
                    got=float(stored[li]), want=float(ref[li]),
                    rtol=rtol))
                return (f"stored per-layer {term} of grid row {gi}, "
                        f"network {nm} diverges from the plain-path "
                        f"recompute at layer {li} (got {stored[li]!r}, "
                        f"want {ref[li]!r}, rtol {rtol:g}) — the entry "
                        f"was poisoned before it was written")
    return None
