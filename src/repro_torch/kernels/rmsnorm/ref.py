"""Plain torch version of the RMSNorm kernel (the JAX package's
``kernels/rmsnorm/ref.py::rmsnorm_ref``)."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` in float32 over the last
    axis, cast once to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
