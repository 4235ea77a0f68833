"""Durable state for the port's DSE service: persistent cache + journal.

The port's copy of ``repro.serving.store``, unchanged in layout: an entry,
a journal line or a checkpoint written by either package reads in the
other, and :func:`grid_hash` / :func:`networks_hash` give the reference's
digests for the same inputs.  Everything the service keeps warm in memory
— streamed reductions, per-request answers, mid-stream checkpoints — dies
with the process; this module is the disk tier that survives it:

* :class:`DurableStore` — a content-addressed npz cache under
  ``root/entries``.  Keys are nested tuples whose FIRST element is the
  invalidation group (the service uses the grid content hash), so
  ``invalidate_group`` drops every entry of a superseded grid.  Every
  entry carries a schema version and a checksum over its full payload;
  anything that fails to load, verify or parse is *quarantined* —
  atomically moved to ``root/quarantine`` with a reason, never served:
  ``get`` returns ``None`` and the caller recomputes.  Writes go to a
  temp file, are fsync'd, then renamed over the entry.
  :meth:`DurableStore.scrub` re-audits decoded entries through a
  caller-supplied checker (the service wires
  :func:`repro_torch.ft.verify.scrub_layer_topk` in) and quarantines
  entries that were poisoned BEFORE they were written.

* :class:`Journal` — a write-ahead request log (JSONL, one fsync'd line
  per record): ``submit`` before a request is queued, ``done`` when its
  answer is delivered; :meth:`Journal.replay` returns the
  accepted-but-unanswered records in admission order.  A torn final line
  is dropped and counted, never fatal.

* :func:`stream_payload` / :func:`stream_from_payload` — a completed
  :class:`repro_torch.core.energymodel.LayerTopK` to plain numpy arrays +
  JSON meta and back, bit for bit.

Answers cached through :meth:`DurableStore.put`'s ``meta`` come back with
lists where the computed answer had tuples (JSON has no tuple).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from ..core import rs_mapping
from ..core.accelerator import ConfigGrid
from ..core.energymodel import LayerTopK, StreamFoldState, StreamStateError

#: Bump when the on-disk entry layout changes; older entries quarantine.
SCHEMA_VERSION = 1


def grid_hash(grid: ConfigGrid) -> str:
    """Content hash of a config grid (column bytes, order-independent)."""
    h = hashlib.sha256()
    for k in sorted(grid.fields):
        h.update(k.encode())
        h.update(np.ascontiguousarray(
            np.asarray(grid.fields[k], dtype=np.float64)).tobytes())
    return h.hexdigest()


def networks_hash(networks: Mapping[str, Any]) -> str:
    """Content hash of a network set (names + layer structs, as float64
    bytes: the reference's digest)."""
    h = hashlib.sha256()
    for nm in sorted(networks):
        h.update(nm.encode())
        struct = rs_mapping.layer_struct(
            [l for l in networks[nm] if l.kind != "input"], device="cpu")
        for sk in sorted(struct):
            h.update(sk.encode())
            h.update(np.ascontiguousarray(
                struct[sk].numpy().astype(np.float64)).tobytes())
    return h.hexdigest()


def _checksum(arrays: Mapping[str, np.ndarray], meta_json: str) -> str:
    """Checksum over every array's (name, dtype, shape, bytes) + meta."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(meta_json.encode())
    return h.hexdigest()


def _atomic_savez(path: Path, payload: Dict[str, Any]) -> None:
    """Crash-safe write: temp file in the same dir, fsync, os.replace."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _json_scalar(z, name: str) -> str:
    v = z[name]
    return str(np.asarray(v)[()])


class DurableStore:
    """Disk-backed content-addressed cache with quarantine-on-corruption.

    ``key`` is any nested tuple of JSON-ish scalars; ``key[0]`` is the
    invalidation group.  The filename embeds both the group hash and the
    full key hash, so group invalidation is a directory scan, not an
    index."""

    def __init__(self, root, *, schema: int = SCHEMA_VERSION):
        self.root = Path(root)
        self.schema = int(schema)
        self.entries = self.root / "entries"
        self.quarantine = self.root / "quarantine"
        self.ckpt_dir = self.root / "ckpt"
        for d in (self.root, self.entries, self.quarantine, self.ckpt_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.stats: Dict[str, int] = dict(
            puts=0, hits=0, misses=0, quarantined=0, invalidated=0,
            ckpt_saved=0, ckpt_loaded=0, ckpt_deleted=0,
            scrub_entries=0, scrubbed_bad=0)

    # -- key addressing ----------------------------------------------------

    @staticmethod
    def _group_hash(group) -> str:
        return hashlib.sha256(repr(group).encode()).hexdigest()[:16]

    def _path(self, key: tuple) -> Path:
        g = self._group_hash(key[0])
        k = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return self.entries / f"{g}_{k}.npz"

    # -- entries -----------------------------------------------------------

    def put(self, key: tuple, *,
            arrays: Optional[Mapping[str, np.ndarray]] = None,
            meta: Any = None) -> Path:
        """Write (or overwrite) one entry atomically."""
        arrays = {f"a_{k}": np.asarray(v)
                  for k, v in (arrays or {}).items()}
        meta_json = json.dumps(meta, sort_keys=True)
        head = json.dumps(dict(
            schema=self.schema, key=repr(key),
            checksum=_checksum(arrays, meta_json)), sort_keys=True)
        path = self._path(key)
        _atomic_savez(path, dict(arrays, __head__=head,
                                 __meta__=meta_json))
        self.stats["puts"] += 1
        return path

    def _load_entry(self, path: Path
                    ) -> Tuple[str, Dict[str, np.ndarray], Any]:
        """Load + integrity-check one entry file.

        Returns ``(key_repr, arrays, meta)`` with the ``a_`` prefixes
        stripped; raises on any damage (unreadable npz, missing members,
        schema or checksum mismatch).  Shared by :meth:`get` and
        :meth:`scrub`."""
        with np.load(path, allow_pickle=False) as z:
            head = json.loads(_json_scalar(z, "__head__"))
            meta_json = _json_scalar(z, "__meta__")
            arrays = {k: z[k] for k in z.files
                      if k not in ("__head__", "__meta__")}
        if int(head["schema"]) != self.schema:
            raise StreamStateError(
                f"schema {head['schema']} != {self.schema}")
        if head["checksum"] != _checksum(arrays, meta_json):
            raise StreamStateError("checksum mismatch")
        return (head["key"], {k[2:]: v for k, v in arrays.items()},
                json.loads(meta_json))

    def get(self, key: tuple
            ) -> Optional[Tuple[Dict[str, np.ndarray], Any]]:
        """Load one entry, or ``None`` (miss, or quarantined on damage).

        EVERY failure mode — unreadable npz, missing members, schema or
        key mismatch, checksum mismatch — quarantines the file and falls
        through to a miss; the caller recomputes."""
        path = self._path(key)
        if not path.exists():
            self.stats["misses"] += 1
            return None
        try:
            key_repr, arrays, meta = self._load_entry(path)
            if key_repr != repr(key):
                raise StreamStateError("key mismatch (hash collision or "
                                       "tampered entry)")
        except Exception as e:
            self._quarantine(path, reason=str(e))
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return arrays, meta

    def scrub(self, checker=None, *, max_entries: Optional[int] = None,
              cursor: Optional[str] = None) -> Dict[str, Any]:
        """Audit cached entries beyond what the checksum can see.

        The checksum protects against damage AFTER the write; an entry
        whose payload was silently corrupted BEFORE ``put`` verifies
        clean forever.  ``scrub`` walks entry files (integrity check
        first) and hands each decoded entry to ``checker(key_repr,
        arrays, meta)`` — a domain auditor returning a quarantine-reason
        string or ``None``/falsy (the service wires
        :func:`repro_torch.ft.verify.scrub_layer_topk` in here).  Bad entries
        are quarantined-with-reason; the caller recomputes on the next
        miss.

        ``cursor``/``max_entries`` support incremental idle-time passes:
        pass the returned ``cursor`` back in to continue the walk
        (wrapping around), bound each pass with ``max_entries``.
        Returns ``dict(scanned=..., bad=..., bad_keys=[key_repr | None,
        ...], cursor=...)``."""
        names = sorted(p.name for p in self.entries.glob("*.npz"))
        if cursor is not None:
            after = [nm for nm in names if nm > cursor]
            names = after + [nm for nm in names if nm <= cursor]
        if max_entries is not None:
            names = names[:max(0, int(max_entries))]
        scanned = bad = 0
        bad_keys: List[Optional[str]] = []
        for nm in names:
            path = self.entries / nm
            if not path.exists():      # racing invalidation
                continue               # pragma: no cover
            scanned += 1
            try:
                key_repr, arrays, meta = self._load_entry(path)
            except Exception as e:
                self._quarantine(path, reason=f"scrub: {e}")
                bad += 1
                bad_keys.append(None)  # key unrecoverable from the file
                continue
            reason = checker(key_repr, arrays, meta) if checker else None
            if reason:
                self._quarantine(path, reason=f"scrub: {reason}")
                bad += 1
                bad_keys.append(key_repr)
        self.stats["scrub_entries"] += scanned
        self.stats["scrubbed_bad"] += bad
        return dict(scanned=scanned, bad=bad, bad_keys=bad_keys,
                    cursor=names[-1] if names else cursor)

    def _quarantine(self, path: Path, *, reason: str = "") -> None:
        """Atomically move a damaged file aside (never delete evidence)."""
        dest = self.quarantine / path.name
        i = 0
        while dest.exists():
            i += 1
            dest = self.quarantine / f"{path.name}.{i}"
        try:
            os.replace(path, dest)
            with open(str(dest) + ".reason", "w") as f:
                f.write(reason + "\n")
        except OSError:        # a concurrent reader beat us to the move
            pass               # pragma: no cover
        self.stats["quarantined"] += 1

    def invalidate_group(self, group) -> int:
        """Delete every entry whose ``key[0]`` equals ``group``."""
        g = self._group_hash(group)
        n = 0
        for p in self.entries.glob(f"{g}_*.npz"):
            try:
                p.unlink()
                n += 1
            except OSError:    # pragma: no cover
                pass
        self.stats["invalidated"] += n
        return n

    # -- mid-stream checkpoints --------------------------------------------

    def ckpt_path(self, input_hash: str) -> Path:
        return self.ckpt_dir / f"ckpt_{input_hash}.npz"

    def save_ckpt(self, fs: StreamFoldState) -> Path:
        """Spill a fold state, keyed by its ``stream_input_hash``."""
        path = self.ckpt_path(fs.input_hash)
        fs.save(path)
        self.stats["ckpt_saved"] += 1
        return path

    def iter_ckpts(self) -> Iterator[Tuple[Path, StreamFoldState]]:
        """Yield every loadable checkpoint; unloadable files quarantine."""
        for p in sorted(self.ckpt_dir.glob("ckpt_*.npz")):
            try:
                fs = StreamFoldState.load(p)
            except Exception as e:
                self._quarantine(p, reason=str(e))
                continue
            self.stats["ckpt_loaded"] += 1
            yield p, fs

    def drop_ckpt(self, input_hash: str) -> bool:
        path = self.ckpt_path(input_hash)
        try:
            path.unlink()
        except OSError:
            return False
        self.stats["ckpt_deleted"] += 1
        return True

    # -- introspection -----------------------------------------------------

    def health(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["n_entries"] = sum(1 for _ in self.entries.glob("*.npz"))
        out["n_quarantined_files"] = sum(
            1 for _ in self.quarantine.glob("*.npz*")
            if not str(_).endswith(".reason"))
        out["n_ckpt_files"] = sum(
            1 for _ in self.ckpt_dir.glob("ckpt_*.npz"))
        return out


# ---------------------------------------------------------------------------
# Write-ahead request journal
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayResult:
    """What :meth:`Journal.replay` recovered from a journal file."""

    pending: List[dict]            # unanswered submit records, in order
    next_rid: int                  # first rid a restarted service may use
    n_done: int                    # answered requests found
    n_torn: int                    # undecodable (torn-write) lines dropped


class Journal:
    """Append-only fsync'd JSONL write-ahead log of service requests.

    One record per line: ``{"op": "submit", "rid": ..., ...request
    fields...}`` when a request is admitted, ``{"op": "done", "rid":
    ...}`` when its answer is handed back.  The file is opened in append
    mode, so a replayed journal keeps extending — recovery state and new
    traffic share one log."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def append(self, record: Mapping[str, Any]) -> None:
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def submit(self, rid: int, fields: Mapping[str, Any]) -> None:
        self.append(dict(fields, op="submit", rid=int(rid)))

    def done(self, rid: int) -> None:
        self.append(dict(op="done", rid=int(rid)))

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:        # pragma: no cover
            pass

    @staticmethod
    def replay(path) -> ReplayResult:
        """Read a journal (possibly from a killed process) back.

        A line that fails to decode is a torn write: the crash happened
        mid-append, before the fsync returned, so the record was never
        acknowledged — it is dropped and counted, never fatal."""
        path = Path(path)
        pending: Dict[int, dict] = {}
        next_rid, n_done, n_torn = 0, 0, 0
        if not path.exists():
            return ReplayResult([], 0, 0, 0)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    op, rid = rec["op"], int(rec["rid"])
                except (ValueError, KeyError, TypeError):
                    n_torn += 1
                    continue
                next_rid = max(next_rid, rid + 1)
                if op == "submit":
                    pending[rid] = rec
                elif op == "done":
                    if pending.pop(rid, None) is not None:
                        n_done += 1
                else:
                    n_torn += 1
        return ReplayResult(
            pending=[pending[r] for r in sorted(pending)],
            next_rid=next_rid, n_done=n_done, n_torn=n_torn)


# ---------------------------------------------------------------------------
# LayerTopK <-> store payload
# ---------------------------------------------------------------------------

_STREAM_ARRAYS = (
    "layer_counts", "topk_idx", "topk_metric", "layer_energy",
    "layer_latency", "min_energy", "min_latency", "min_edp", "min_metric",
    "argmin", "layer_min_metric", "layer_argmin")


def stream_payload(st: LayerTopK
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Flatten a COMPLETED streamed sweep to (arrays, meta) for the
    store."""
    arrays = {k: np.asarray(getattr(st, k)) for k in _STREAM_ARRAYS}
    if st.bound is not None:
        for j, nm in enumerate(st.networks):
            arrays[f"bnd{j}_idx"] = np.asarray(st.boundary_idx[nm])
            arrays[f"bnd{j}_e"] = np.asarray(st.boundary_energy[nm])
            arrays[f"bnd{j}_t"] = np.asarray(st.boundary_latency[nm])
    meta = dict(networks=list(st.networks), n_cfg=int(st.n_cfg),
                metric=st.metric,
                bound=None if st.bound is None else float(st.bound))
    return arrays, meta


def stream_from_payload(arrays: Mapping[str, np.ndarray],
                        meta: Mapping[str, Any]) -> LayerTopK:
    """Inverse of :func:`stream_payload`, bit-identical round trip."""
    nets = tuple(meta["networks"])
    bound = meta["bound"]
    kw: Dict[str, Any] = {k: np.asarray(arrays[k]) for k in _STREAM_ARRAYS}
    b_idx = b_e = b_t = None
    if bound is not None:
        b_idx, b_e, b_t = {}, {}, {}
        for j, nm in enumerate(nets):
            b_idx[nm] = np.asarray(arrays[f"bnd{j}_idx"])
            b_e[nm] = np.asarray(arrays[f"bnd{j}_e"])
            b_t[nm] = np.asarray(arrays[f"bnd{j}_t"])
    return LayerTopK(networks=nets, n_cfg=int(meta["n_cfg"]),
                     metric=str(meta["metric"]), bound=bound,
                     boundary_idx=b_idx, boundary_energy=b_e,
                     boundary_latency=b_t, **kw)
