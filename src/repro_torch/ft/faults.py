"""Deterministic fault injection for the port's streamed DSE engine.

The port's copy of ``repro.ft.faults``.  :class:`FaultPlan` installs into
the streaming engine's per-chunk seam
(``repro_torch.core.energymodel._CHUNK_HOOK``, applied to every chunk's raw
``(e, t)`` evaluation right before the fold) and fires these fault kinds
at chosen chunk indices:

* ``fail_at``   — raise :class:`BackendFault` (a transient backend death;
  the service's retry/backoff path rides this),
* ``corrupt_at`` — overwrite one seeded-random element of the chunk's
  energies (``target="e"``) or latencies (``target="t"``) with NaN or
  +inf (loud corruption: the engine's NaN/inf guard must raise
  :class:`repro_torch.core.energymodel.ChunkCorruption` before the fold
  commits),
* ``kill_at``   — raise :class:`StreamKill` (a simulated process death
  mid-stream, recovered in-process from the last fold state),
* ``pkill_at``  — raise :class:`ProcessKill` (a whole-process death that
  no ``except Exception`` swallows),
* ``perturb_at`` — multiply one seeded-random NONZERO finite element by
  ``1 + perturb_rel`` (finite silent corruption; only
  :class:`repro_torch.ft.verify.StreamVerifier`'s shadow recompute sees
  it).

The hook receives device tensors: a corruption is written into a float64
clone on the tensor's own device, so the fold never moves to the host.
Positions are drawn exactly as the reference draws them — from
``default_rng(seed * 1_000_003 + chunk)`` over the flattened chunk — so on
a full chunk the port and the reference hit the same element.  The port
does not pad its last chunk, so there the element count, and with it the
drawn position, can differ from the reference's.

``FaultPlan.random`` builds a reproducible plan from a seed; ``fail_at``
counts down (a chunk can fail N times then succeed) and the other kinds
fire once, so retry loops terminate; ``fired`` records every injection.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import energymodel


class BackendFault(RuntimeError):
    """Injected transient backend failure (retryable)."""


class StreamKill(RuntimeError):
    """Injected mid-stream kill (simulated process death).

    The service's retry ladder treats this as recoverable: it resumes from
    the last checkpoint inside the same process."""


class ProcessKill(BaseException):
    """Injected whole-PROCESS death (kill -9 analogue).

    A :class:`BaseException`, so no ``except Exception`` retry path
    swallows it: it propagates out of ``DSEService.step()``, leaving
    queues, caches and half-written state as the kill found them.  A
    fresh service over the same ``state_dir`` then replays the journal
    and resumes from the checkpoints."""


def _f64_clone(victim) -> torch.Tensor:
    """A float64 copy of a chunk tensor, on its own device."""
    return victim.detach().to(dtype=torch.float64, copy=True).contiguous()


@dataclasses.dataclass
class FaultPlan:
    """Seeded, chunk-indexed fault schedule; callable as the chunk hook."""

    fail_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    corrupt_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    kill_at: Optional[int] = None
    pkill_at: Optional[int] = None   # whole-process kill (ProcessKill)
    # finite corruption: chunk -> relative perturbation of one element
    perturb_at: Dict[int, float] = dataclasses.field(default_factory=dict)
    perturb_rel: float = 1e-3
    seed: int = 0
    target: str = "e"              # corruption tensor: "e" | "t"
    fired: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.target not in ("e", "t"):
            raise ValueError(f"FaultPlan.target must be 'e' or 't', got "
                             f"{self.target!r}")

    @classmethod
    def random(cls, seed: int, n_chunks: int, *, p_fail: float = 0.2,
               p_corrupt: float = 0.1, max_fails: int = 2,
               p_perturb: float = 0.0,
               perturb_rel: float = 1e-3) -> "FaultPlan":
        """Reproducible random plan over ``n_chunks`` chunk indices — the
        reference's draws in the reference's order, so a seed gives both
        packages the same plan.

        Per-chunk fail counts stay ≤ ``max_fails``, so any retry budget
        above it converges.  The corruption target is a seeded coin flip
        between the energy and latency tensors; ``p_perturb`` draws come
        after all others."""
        rng = np.random.default_rng(seed)
        target = "e" if rng.random() < 0.5 else "t"
        fail_at = {ci: int(rng.integers(1, max_fails + 1))
                   for ci in range(n_chunks) if rng.random() < p_fail}
        corrupt_at = {ci: ("nan" if rng.random() < 0.5 else "inf")
                      for ci in range(n_chunks)
                      if rng.random() < p_corrupt}
        perturb_at = {ci: perturb_rel for ci in range(n_chunks)
                      if rng.random() < p_perturb and ci not in corrupt_at}
        return cls(fail_at=fail_at, corrupt_at=corrupt_at,
                   perturb_at=perturb_at, perturb_rel=perturb_rel,
                   seed=seed, target=target)

    def _rng(self, ci: int) -> np.random.Generator:
        return np.random.default_rng(self.seed * 1_000_003 + ci)

    def __call__(self, ci: int, e, t):
        if self.pkill_at is not None and ci == self.pkill_at:
            self.pkill_at = None
            self.fired.append((ci, "pkill"))
            raise ProcessKill(f"injected process kill at chunk {ci}")
        if self.kill_at is not None and ci == self.kill_at:
            self.kill_at = None
            self.fired.append((ci, "kill"))
            raise StreamKill(f"injected kill at chunk {ci}")
        left = self.fail_at.get(ci, 0)
        if left > 0:
            self.fail_at[ci] = left - 1
            self.fired.append((ci, "fail"))
            raise BackendFault(f"injected backend failure at chunk {ci}")
        kind = self.corrupt_at.pop(ci, None)
        if kind is not None:
            self.fired.append((ci, kind))
            victim = _f64_clone(e if self.target == "e" else t)
            flat = int(self._rng(ci).integers(victim.numel()))
            victim.view(-1)[flat] = float("nan" if kind == "nan" else "inf")
            e, t = (victim, t) if self.target == "e" else (e, victim)
        rel = self.perturb_at.pop(ci, None)
        if rel is not None:
            # finite silent corruption: scale ONE element by (1 + rel).
            # Pop-once, so the service's retry of the failed chunk is clean.
            self.fired.append((ci, "perturb"))
            victim = _f64_clone(e if self.target == "e" else t)
            flat_v = victim.view(-1)
            # among NONZERO finite elements: scaling a zero (the per-layer
            # tensors zero-pad each network's layer tail) changes nothing
            eligible = torch.nonzero(
                torch.isfinite(flat_v) & (flat_v != 0.0)).flatten()
            rng = self._rng(ci)
            n_ok = int(eligible.numel())
            flat = (int(eligible[int(rng.integers(n_ok))]) if n_ok
                    else int(rng.integers(flat_v.numel())))
            flat_v[flat] *= (1.0 + rel)
            e, t = (victim, t) if self.target == "e" else (e, victim)
        return e, t


@contextlib.contextmanager
def inject_chunk_faults(plan: FaultPlan):
    """Install ``plan`` as the port's streaming chunk hook for the block;
    the previous hook is restored on exit, so plans nest."""
    prev = energymodel._CHUNK_HOOK
    energymodel._CHUNK_HOOK = plan
    try:
        yield plan
    finally:
        energymodel._CHUNK_HOOK = prev
