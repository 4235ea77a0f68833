"""Plain torch versions of the flash-attention kernels: masked softmax
attention in float32 (the JAX package's ``kernels/flash_attention/ref.py::
attention_ref``), taken in the grouped-query layout of the kernel, the same
forward with its per-row log-sum-exp, and its backward."""

from __future__ import annotations

import math

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    """float64 inputs compute in float64, every other type in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mask(t, s, causal, window, q_offset, device) -> torch.Tensor:
    """[t, s]: query row t (at position q_offset + t) sees key s."""
    qpos = torch.arange(t, device=device)[:, None] + q_offset
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones(t, s, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, causal, window, q_offset):
    """Masked scaled scores [B, KV, G, T, S] (-inf where masked)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    acc = _acc(q.dtype)
    qg = q.to(acc).reshape(b, t, kvh, h // kvh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(acc)) / math.sqrt(d)
    return scores.masked_fill(~_mask(t, s, causal, window, q_offset, q.device),
                              -math.inf)


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """q: [B, T, H, D]; k, v: [B, S, KV, D] with KV dividing H → (out [B, T,
    H, D] in q's dtype, lse [B, H, T] float32, float64 for float64
    inputs).

    Query row t sits at position ``q_offset + t`` and sees key s where
    ``s <= q_offset + t`` (causal) and ``s > q_offset + t - window``
    (window > 0).  Scores, softmax and the product with v are float32
    (float64 for float64 inputs); the result is cast to q's dtype.  A row
    that sees no key gives 0 and a log-sum-exp of -inf, as the kernels
    do."""
    b, t, h, d = q.shape
    acc = _acc(q.dtype)
    scores = _scores(q, k, causal, window, q_offset)
    m = scores.amax(-1, keepdim=True).clamp_min(torch.finfo(acc).min)
    p = torch.exp(scores - m)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", p / den.clamp_min(1e-30), v.to(acc))
    lse = torch.where(den > 0, m + torch.log(den), -math.inf)[..., 0]
    return (out.reshape(b, t, h, d).to(q.dtype),
            lse.reshape(b, h, t))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """The output of :func:`attention_fwd_ref`."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)[0]


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0):
    """The gradients of attention for the output gradient ``dout`` →
    (dq, dk, dv) in q's, k's and v's dtypes, from the forward's ``out``
    and ``lse`` [B, H, T]: P = exp(S / √D − lse), Δ = rowsum(dO ∘ O), dS =
    P (dO Vᵀ − Δ), dq = dS K / √D, dk = dSᵀ Q / √D, dv = Pᵀ dO, summed over
    the G query heads of each kv head; float32 (float64 for float64
    inputs)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    acc = _acc(q.dtype)
    scores = _scores(q, k, causal, window, q_offset)
    lse_g = lse.to(acc).reshape(b, kvh, g, t)[..., None]
    p = torch.where(lse_g > -math.inf, torch.exp(scores - lse_g), 0.0)
    do = dout.to(acc).reshape(b, t, kvh, g, d)
    delta = (do * out.to(acc).reshape(b, t, kvh, g, d)).sum(-1)
    dp = torch.einsum("btkgd,bskd->bkgts", do, v.to(acc))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(d)
    qg = q.to(acc).reshape(b, t, kvh, g, d)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", p, do)
    return (dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
