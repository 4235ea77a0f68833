"""Checkpointing with atomic commits (the JAX package's
``checkpoint/manager.py``), over trees of torch tensors.

Layout (one directory per step), the reference's own:

    <root>/step_00000400/
        manifest.json            # step, treedef, leaves (file, shape,
                                 # dtype), extra
        arr_00000.npy ...        # one file per leaf, in the reference's
                                 # leaf order (dict keys sorted, lists in
                                 # order); bfloat16 saved as its uint16 bits
                                 # with dtype "bfloat16" in the manifest
        COMMITTED                # written last: a partial checkpoint is
                                 # never visible to restore()

So a checkpoint of nested dicts of arrays written by either package
restores in the other.  A step is written to ``.tmp_step_…`` and renamed
when whole; ``keep`` newest steps stay.

``save`` copies every leaf to host memory synchronously
(``.detach().to("cpu", copy=True)``: on the CPU ``.numpy()`` would alias
the tensor, and the trainer's in-place optimizer step would change a
pending write) and writes on a background thread; ``wait`` joins the
writes.  ``restore`` places each leaf on the device and in the dtype of
the matching leaf of ``tree_like``.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import flatten

_BF16 = "bfloat16"


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory; bfloat16 as its
    uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x, copy=True)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


class CheckpointManager:
    def __init__(self, root, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> Path:
        flat, treedef = flatten(tree)
        names = [_dtype_name(x) for x in flat]
        host = [_host(x) for x in flat]
        d = self.root / f"step_{step:08d}"
        tmp = self.root / f".tmp_step_{step:08d}"

        def write():
            try:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = dict(
                    step=step, treedef=str(treedef),
                    leaves=[dict(file=f"arr_{i:05d}.npy", shape=list(a.shape),
                                 dtype=name)
                            for i, (a, name) in enumerate(zip(host, names))],
                    extra=extra or {})
                for i, a in enumerate(host):
                    np.save(tmp / f"arr_{i:05d}.npy", a)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                (tmp / "COMMITTED").write_text("ok")
                if d.exists():
                    shutil.rmtree(d)
                tmp.rename(d)
                self._gc()
            except BaseException as e:      # re-raised by wait()
                self._errors.append(e)

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending.append(t)
        if blocking:
            self.wait()
        return d

    def wait(self):
        """Join every pending write; raise the first write's error."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def _gc(self):
        steps = sorted(self.available())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def available(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> tuple[Any, Dict]:
        """Restore into the structure of ``tree_like``: each tensor leaf on
        its target's device and in its dtype (a numpy leaf stays numpy,
        cast to its target's dtype)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat, treedef = flatten(tree_like)
        if len(flat) != len(manifest["leaves"]):
            raise ValueError(f"leaf count mismatch: {len(flat)} vs "
                             f"{len(manifest['leaves'])}")
        out = []
        for leaf, meta in zip(flat, manifest["leaves"]):
            a = np.load(d / meta["file"])
            if meta["dtype"] == _BF16:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            elif a.dtype.kind == "u" and meta["dtype"] not in (
                    str(a.dtype), "bool"):
                raise ValueError(f"leaf {meta['file']} holds {meta['dtype']}, "
                                 f"which the port cannot read")
            else:
                t = torch.from_numpy(a)
            if isinstance(leaf, torch.Tensor):
                out.append(t.to(device=leaf.device, dtype=leaf.dtype))
            else:
                out.append(t.numpy().astype(np.asarray(leaf).dtype))
        return treedef.unflatten(out), manifest["extra"]
