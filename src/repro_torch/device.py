"""Device and backend choice, shared by every entry point of the port.

``device=None`` means the card and raises without one: nothing moves to
the CPU unless the caller asks for it.  ``backend`` is ``"cuda"`` (the
hand-written kernels) or ``"torch"`` (their plain versions); it defaults
to ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU, and ``"cuda"``
on the CPU raises.  There is no fallback chain.
"""

from __future__ import annotations

import torch

#: Selectable backends: the hand-written CUDA kernels, and the same
#: arithmetic as plain torch operations.
BACKENDS = ("cuda", "torch")


def resolve_device(device=None) -> torch.device:
    """``None`` → the card.  A CUDA device without a card raises: the
    port never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port's plain torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or the CPU, got {dev}")
    return dev


def resolve_backend(backend: str | None, device: torch.device) -> str:
    """``None`` → ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU.
    ``"cuda"`` on the CPU raises; there is no fallback."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' runs the hand-written kernels and needs a CUDA "
            f"device, got device={str(device)!r}; use backend='torch' on "
            f"the CPU")
    return backend
