"""Shared transformer building blocks: norms, RoPE, GQA attention (with a
KV cache and local windows), dense MLPs — the port of the JAX package's
``models/layers.py`` for the dense family.

Parameters come in as mappings (``nn.ParameterDict`` or dicts of tensors)
with the reference's keys and layouts: ``wq`` [d, h, hd], ``wo`` [h, hd,
d], activations [B, T, H, D].  Where the reference computes RMSNorm and
attention in XLA, the port calls its kernels: ``apply_norm``'s rms branch
goes through :mod:`repro_torch.kernels.rmsnorm` and ``mha`` through
:mod:`repro_torch.kernels.flash_attention`.  ``backend`` picks the
hand-written kernels (``"cuda"``) or their plain versions (``"torch"``);
it has no default here: the model's entry points resolve it from the
device (:func:`repro_torch.device.resolve_backend`).
The reference's ``shard`` calls are no-ops outside a mesh and are dropped.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention import ref as flash_ref
from ..kernels.rmsnorm import ops as rms_ops
from ..kernels.rmsnorm import ref as rms_ref
from .params import Spec

_EPS = 1e-6


# backend → function; an unknown backend raises KeyError, so nothing here
# picks the plain versions without being asked
_RMSNORM = {"cuda": rms_ops.rmsnorm, "torch": rms_ref.rmsnorm_ref}
_ATTENTION = {"cuda": flash_ops.flash_attention,
              "torch": flash_ref.attention_ref}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(cfg, d: Optional[int] = None) -> Dict[str, Spec]:
    d = d or cfg.d_model
    s = {"scale": Spec((d,), init="ones", dtype=torch.float32)}
    if cfg.norm == "ln":
        s["bias"] = Spec((d,), init="zeros", dtype=torch.float32)
    return s


def apply_norm(p, cfg, x: torch.Tensor, *, backend: str) -> torch.Tensor:
    """RMSNorm (through the kernel) or LayerNorm (plain torch, as the
    reference computes it outside any kernel).

    The rms branch is all float32 with one cast at the end, as the TPU
    kernel is; the reference's XLA branch rounds the inverse to x's dtype
    first, so in bf16 the two differ by bf16 ulps."""
    if cfg.norm == "ln":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + _EPS)
        return ((x - mu.to(x.dtype)) * inv.to(x.dtype)
                * p["scale"].to(x.dtype) + p["bias"].to(x.dtype))
    return rmsnorm(x, p["scale"], backend=backend)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, backend: str
            ) -> torch.Tensor:
    """RMSNorm over the last axis through the kernel table: float32 math,
    eps 1e-6, one cast to x's dtype."""
    return _RMSNORM[backend](x, scale, _EPS)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] (or [T])."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)              # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # [B, T, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_spec(cfg, d: Optional[int] = None) -> Dict[str, Spec]:
    d = d or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((d, h, hd)),
        "wk": Spec((d, kv, hd)),
        "wv": Spec((d, kv, hd)),
        "wo": Spec((h, hd, d)),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((h, hd), init="zeros")
        s["bk"] = Spec((kv, hd), init="zeros")
        s["bv"] = Spec((kv, hd), init="zeros")
    return s


def _qkv(p, cfg, x, xkv=None):
    xkv = x if xkv is None else xkv
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _sdpa(cfg, q, k, v, mask) -> torch.Tensor:
    """Grouped-query attention core of the reference, kept plain for the
    tests.  q: [B,T,H,D]; k,v: [B,S,KV,D]; mask broadcasts to
    [B,KV,G,T,S]."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, t, kvh, g, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(
            -1e30, dtype=torch.float32, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, hd)


def causal_mask(t: int, s: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """[1,1,1,t,s] boolean mask; query i attends keys ≤ i+offset, within
    ``window`` when nonzero."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    return m[None, None, None]


def mha(p, cfg, x, *, positions, mask_mode="causal", window=0,
        cache=None, apply_rope=True, backend: str):
    """Full attention path → (out, new_cache).

    Prefill/forward: cache is None → self-attention over x through the
    flash kernel (``mask_mode`` 'causal' or 'full'; window > 0 adds a
    sliding window).  The reference picks its blockwise XLA attention or
    ``_sdpa`` by length; the kernel serves both.

    Decode: cache = dict(k=[B, S, KV, D], v=..., length=int).  The new
    token's K/V are written into the cache tensors IN PLACE at ``length``
    — clamped to S - T, as ``jax.lax.dynamic_update_slice`` clamps its
    start — and the query attends the cache prefix of keys ≤ length
    (all S keys once length ≥ S), as the reference's mask
    ``kpos <= length`` does.  Rope uses the unclamped ``length``."""
    q, k, v = _qkv(p, cfg, x)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    attend = _ATTENTION[backend]

    if cache is None:
        out = attend(q, k, v, causal=mask_mode == "causal", window=window)
        new_cache = None
    else:
        length = int(cache["length"])
        ck, cv = cache["k"], cache["v"]
        t, s = x.shape[1], ck.shape[1]
        if window and t != 1:
            raise NotImplementedError(
                "windowed decode takes one token per step; the reference "
                "masks every row of a multi-token step at `length`")
        start = min(max(length, 0), s - t)
        ck[:, start:start + t] = k.to(ck.dtype)
        cv[:, start:start + t] = v.to(cv.dtype)
        new_cache = dict(k=ck, v=cv, length=length + t)
        n = min(length + 1, s)
        kp, vp = ck[:, :n], cv[:, :n]
        if kp.dtype != q.dtype:
            # f32 activations over a bf16 cache: widening is exact
            kp, vp = kp.to(q.dtype), vp.to(q.dtype)
        out = attend(q, kp, vp, causal=False, window=window,
                     q_offset=length)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi_gate": Spec((d, f)),
            "wi_up": Spec((d, f)),
            "wo": Spec((f, d)),
        }
    return {
        "wi": Spec((d, f)),
        "wo": Spec((f, d)),
    }


def apply_mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    if "wi_gate" in p:
        g = torch.einsum("btd,df->btf", x, p["wi_gate"])
        u = torch.einsum("btd,df->btf", x, p["wi_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.einsum("btd,df->btf", x, p["wi"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("btf,fd->btd", h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(cfg) -> Dict[str, Spec]:
    s = {"tok": Spec((cfg.vocab, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec((cfg.d_model, cfg.vocab))
    return s


def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the table for ``tokens`` (``F.embedding``: its gradient
    on the card sums each row's contributions in a fixed order, where
    indexing's would add them with atomics)."""
    return F.embedding(tokens, p["tok"])


def unembed(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits stay in the parameters' dtype, as in the reference."""
    w = p["unembed"] if "unembed" in p else p["tok"].T
    return torch.einsum("btd,dv->btv", x, w)
