"""Batched serving engine: prefill + decode with continuous batching (lite),
the port of the JAX package's ``serving/engine.py``.

The engine owns a fixed-capacity batch of sequence *slots*.  Requests queue
up; free slots are filled by prefilling the prompt token by token through
the decode step, then all active slots decode in lock-step single-token
steps.  Finished sequences free their slot for the next queued request
("continuous batching" at slot granularity).

The semantics are the reference's, quirks included, so that both serve
the same tokens: the cache length is one integer shared by every slot
(each prefill token of any slot advances it for all, and inactive slots
write token 0's K/V at that position); ``step`` feeds the last prompt
token once more for a slot that has no output yet; the cache index clamps
at ``max_seq - 1`` once the length reaches ``max_seq``.  ROADMAP.md lists
these under Queue C.

``device=None`` means the card and raises without one; ``backend`` is
``"cuda"`` (the hand kernels, the default on a card) or ``"torch"`` (their
plain versions, the default on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_backend, resolve_device
from ..models import model_zoo as Z
from ..models import params as P


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [T] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, *,
                 batch_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, device=None,
                 backend: Optional[str] = None):
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.finished: List[Request] = []
        self.cache = P.init_tree(Z.cache_spec(cfg, batch_slots, max_seq),
                                 device=self.device)

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One decode step over all slots: tokens [slots, 1] → logits."""
        t = torch.from_numpy(tokens).to(self.device)
        logits, self.cache = Z.decode_step(self.params, self.cfg, t,
                                           self.cache, backend=self.backend)
        return logits

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                self._prefill(slot, req)

    def _prefill(self, slot: int, req: Request):
        """Sequential prefill through the decode step: the prompt's tokens
        go in slot ``slot``, every other slot gets token 0."""
        for tok in req.prompt:
            t = np.zeros((self.slots, 1), np.int64)
            t[slot, 0] = int(tok)
            self._decode(t)

    # -- decode loop ------------------------------------------------------------
    def step(self) -> Dict[int, int]:
        """One lock-step decode across all active slots → {rid: token}."""
        self._admit()
        if not any(r is not None for r in self.active):
            return {}
        last = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is not None and req.out_tokens:
                last[s, 0] = req.out_tokens[-1]
            elif req is not None and len(req.prompt):
                last[s, 0] = int(req.prompt[-1])
        logits = self._decode(last)
        toks = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        emitted = {}
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(toks[s])
            req.out_tokens.append(tok)
            emitted[req.rid] = tok
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)):
                req.done = True
                self.finished.append(req)
                self.active[s] = None       # slot freed → continuous batching
        return emitted

    def run_until_drained(self, max_steps: int = 1000,
                          timeout_s: Optional[float] = None
                          ) -> "DrainResult":
        """Step until queue and slots empty; never silently truncates.

        Stops early at ``max_steps`` or after ``timeout_s`` seconds of
        wall clock; either way the return value is the list of finished
        requests so far, with ``drained`` telling whether the engine
        actually emptied."""
        t0 = time.monotonic()
        drained = False
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                drained = True
                break
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                break
            self.step()
        else:
            drained = (not self.queue
                       and all(a is None for a in self.active))
        return DrainResult(self.finished, drained)


class DrainResult(List[Request]):
    """``run_until_drained``'s finished requests + a ``drained`` flag
    (False: stopped at max_steps/timeout with work still queued)."""

    def __init__(self, finished: List[Request], drained: bool):
        super().__init__(finished)
        self.drained = drained
