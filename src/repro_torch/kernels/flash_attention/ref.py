"""Plain torch version of the flash-attention kernel: masked softmax
attention in float32 (the JAX package's ``kernels/flash_attention/ref.py::
attention_ref``), taken in the grouped-query layout of the kernel."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: [B, T, H, D]; k, v: [B, S, KV, D] with KV dividing H → [B, T, H, D].

    Query row t sits at position ``q_offset + t`` and sees key s where
    ``s <= q_offset + t`` (causal) and ``s > q_offset + t - window``
    (window > 0).  Scores, softmax and the product with v are float32;
    the result is cast to q's dtype.  A row that sees no key gives 0, as
    the kernel does."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, t, kvh, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / math.sqrt(d)
    qpos = torch.arange(t, device=q.device)[:, None] + q_offset
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones(t, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(-1, keepdim=True).clamp_min(torch.finfo(torch.float32).min)
    p = torch.exp(scores - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p / den, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
