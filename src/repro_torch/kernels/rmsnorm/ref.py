"""Plain torch versions of the RMSNorm kernels: the forward (the JAX
package's ``kernels/rmsnorm/ref.py::rmsnorm_ref``) and its backward."""

from __future__ import annotations

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    """float64 inputs compute in float64, every other type in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` in float32 over the last
    axis, cast once to x's dtype."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(acc)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients of :func:`rmsnorm_ref` for the output gradient ``g``
    → (dx in x's dtype, dscale in scale's dtype): with r = rsqrt(mean(x²)
    + eps), dx = r (g s − x r² mean(g s x)) per row and dscale = Σ_rows
    g x r, in float32 (float64 for float64 inputs)."""
    acc = _acc(x.dtype)
    xf, gf, s = x.to(acc), g.to(acc), scale.to(acc)
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    gs = gf * s
    dx = r * (gs - xf * (r * r) * (gs * xf).mean(-1, keepdim=True))
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
