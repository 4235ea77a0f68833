"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), attention-free:
the port of the JAX package's ``models/mamba2.py``.

Block layout (Mamba-2 paper): fused in-projection → (z | x | B | C | dt),
causal depthwise conv over (x | B | C), SSD core, gated RMSNorm,
out-projection.  The prefill forward runs the SSD core through the SSD
kernel (:mod:`repro_torch.kernels.ssd`) where the reference computes the
same chunked scan in XLA (``ssd_chunked``); decode is the O(1) recurrent
update against a [B, H, P, N] float32 state, plain torch as in the
reference.  Both RMSNorms of a block (the pre-norm and the gated norm) go
through the RMSNorm kernel table of :mod:`.layers`.

Parameter names follow the reference's tree keys (``layers.3.in_proj``,
``layers.3.norm.scale``, ``embed.unembed``); the reference's layer
``scan`` becomes a Python loop and its ``shard`` calls are dropped.
``forward`` is differentiable: with trainable parameters and grad mode
on, autograd records it (the SSD scan and RMSNorm through their
``autograd.Function``s on the card), each layer under
``torch.utils.checkpoint`` where ``cfg.remat`` and some parameter
requires grad (the reference's ``jax.checkpoint`` of its scan body with
nothing saved).  Decode runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_backend
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd import ref as ssd_ref
from . import layers as L
from .params import Spec, param_dict

# backend → SSD scan; an unknown backend raises KeyError (as in layers.py)
_SSD = {"cuda": ssd_ops.ssd_scan, "torch": ssd_ref.ssd_scan_ref}

_BLOCK_PARAMS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                 "gate_norm", "out_proj")


def _dims(cfg):
    di = cfg.d_model * cfg.ssm_expand         # inner width
    h = di // cfg.ssm_head_dim                # heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    return di, h, g, n, conv_dim


def block_spec(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    di, h, g, n, conv_dim = _dims(cfg)
    proj_out = 2 * di + 2 * g * n + h          # z, x, B, C, dt
    f32 = torch.float32
    return {
        "norm": L.norm_spec(cfg),
        "in_proj": Spec((d, proj_out)),
        "conv_w": Spec((cfg.conv_kernel, conv_dim)),
        "conv_b": Spec((conv_dim,), init="zeros"),
        "A_log": Spec((h,), init="zeros", dtype=f32),
        "D": Spec((h,), init="ones", dtype=f32),
        "dt_bias": Spec((h,), init="zeros", dtype=f32),
        "gate_norm": Spec((di,), init="ones", dtype=f32),
        "out_proj": Spec((di, d)),
    }


def spec(cfg) -> Dict[str, Any]:
    """Parameter Spec tree; ``layers`` is a list of per-layer block trees
    (the reference stacks them on a leading axis)."""
    return {
        "embed": L.embed_spec(cfg),
        "layers": [block_spec(cfg) for _ in range(cfg.n_layers)],
        "final_norm": L.norm_spec(cfg),
    }


class Block(nn.Module):
    """One Mamba-2 block's parameters, named as the reference's keys;
    frozen unless ``trainable``."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        self.norm = param_dict(tree["norm"], trainable)
        own = param_dict({k: tree[k] for k in _BLOCK_PARAMS}, trainable)
        for name in _BLOCK_PARAMS:
            self.register_parameter(name, own[name])


class Mamba2(nn.Module):
    """The parameters of a Mamba-2 model, built from an initialised tree
    (``params.init_tree(spec(cfg), ...)``); frozen unless ``trainable``."""

    def __init__(self, cfg, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                             f"{cfg.name} {cfg.n_layers}")
        self.embed = param_dict(tree["embed"], trainable)
        self.layers = nn.ModuleList(Block(t, trainable)
                                    for t in tree["layers"])
        self.final_norm = param_dict(tree["final_norm"], trainable)


#: The family's model class, for ``model_zoo.build``.
Model = Mamba2


def _split_proj(cfg, zxbcdt):
    di, h, g, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def _causal_conv(x, w, b):
    """x: [B, T, C]; depthwise causal conv, kernel K."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu((out + b).float()).to(x.dtype)


def _block(p: Block, cfg, x, *, backend: str, state=None, conv_state=None):
    """One Mamba-2 block → x + its output.

    Forward (``state`` None): the SSD kernel over the whole sequence.
    Decode (one token): the recurrent update; ``state`` [B, H, P, N] and
    ``conv_state`` [B, K-1, conv_dim] are updated IN PLACE (the reference
    returns new ones).  Head h reads group ``h // (H / G)`` of B and C in
    both branches; the reference's decode sums B over the groups instead
    (ROADMAP.md, Queue C), which is the same for G = 1."""
    di, h, g, n, _ = _dims(cfg)
    res = x
    x = L.apply_norm(p.norm, cfg, x, backend=backend)
    zxbcdt = torch.einsum("btd,dk->btk", x, p.in_proj)
    z, xin, bmat, cmat, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xin, bmat, cmat], -1)           # [B, T, conv_dim]
    if state is not None:
        if x.shape[1] != 1:
            raise ValueError(f"the recurrent decode takes one token per "
                             f"step, got {x.shape[1]}")
        buf = torch.cat([conv_state, conv_in], dim=1)     # [B, K, conv_dim]
        conv_state.copy_(buf[:, 1:])
        k = p.conv_w.shape[0]
        out = sum(buf[:, i:i + 1] * p.conv_w[i] for i in range(k))
        conv_out = F.silu((out + p.conv_b).float()).to(x.dtype)
    else:
        conv_out = _causal_conv(conv_in, p.conv_w, p.conv_b)

    xin, bmat, cmat = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    bsz, t = x.shape[0], x.shape[1]
    xh = xin.reshape(bsz, t, h, di // h)
    bmat = bmat.reshape(bsz, t, g, n)
    cmat = cmat.reshape(bsz, t, g, n)
    dtf = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)                               # [H] negative

    if state is not None:
        da = torch.exp(dtf[:, 0, :] * A)                  # [B, H]
        bh = bmat[:, 0].float().repeat_interleave(h // g, dim=1)
        ch = cmat[:, 0].float().repeat_interleave(h // g, dim=1)
        upd = torch.einsum("bhn,bh,bhp->bhpn", bh, dtf[:, 0],
                           xh[:, 0].float())
        state.mul_(da[..., None, None]).add_(upd)
        y = torch.einsum("bhn,bhpn->bhp", ch, state)
        y = (y[:, None] + p.D[None, None, :, None] * xh.float()).to(x.dtype)
    else:
        # the kernel forms x·dt in float32 itself; the reference passes
        # xh·dt rounded to the activation dtype to ssd_chunked
        y = _SSD[backend](xh, dtf, A, bmat, cmat, chunk=cfg.ssm_chunk)
        y = y + p.D[None, None, :, None].to(y.dtype) * xh

    y = y.reshape(bsz, t, di)
    # gated RMSNorm: norm(y * silu(z)), rounded to y's dtype first
    gated = y * F.silu(z.float()).to(y.dtype)
    gated = L.rmsnorm(gated, p.gate_norm, backend=backend)
    out = torch.einsum("btk,kd->btd", gated, p.out_proj)
    return res + out


def forward(params: Mamba2, cfg, batch: Dict[str, torch.Tensor], *,
            backend: Optional[str] = None) -> torch.Tensor:
    """Train / prefill forward → logits [B, T, vocab].  ``backend=None`` →
    the kernels on a CUDA device, their plain versions on the CPU.

    Differentiable where parameters require grad (module docstring);
    serving and the prefill check call it under ``torch.no_grad()``."""
    tokens = batch["tokens"]
    backend = resolve_backend(backend, tokens.device)
    x = L.embed(params.embed, cfg, tokens)
    # remat only where autograd records: frozen parameters under grad mode
    # run the layers plainly, as under torch.no_grad()
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params.parameters()))
    for lp in params.layers:
        if remat:
            x = checkpoint(_block, lp, cfg, x, backend=backend,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(lp, cfg, x, backend=backend)
    x = L.apply_norm(params.final_norm, cfg, x, backend=backend)
    return L.unembed(params.embed, cfg, x)


# ---------------------------------------------------------------------------
# Decode (the O(1) recurrent state)
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Per-layer SSM state (float32) and conv buffer (bf16), zeros, and a
    host integer length; O(1) in ``seq_len``."""
    di, h, g, n, conv_dim = _dims(cfg)
    nl, k = cfg.n_layers, cfg.conv_kernel
    return {
        "state": Spec((nl, batch_size, h, di // h, n), init="zeros",
                      dtype=torch.float32),
        "conv": Spec((nl, batch_size, k - 1, conv_dim), init="zeros"),
        "length": 0,
    }


@torch.no_grad()
def decode_step(params: Mamba2, cfg, tokens: torch.Tensor,
                cache: Dict[str, Any], *, backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B, 1] → (logits [B, 1, vocab], new cache).

    ``cache["state"]`` and ``cache["conv"]`` are updated IN PLACE; the
    returned dict holds the same tensors and the advanced length.  Every
    slot's state advances on every call.  ``backend`` as in
    :func:`forward`."""
    backend = resolve_backend(backend, tokens.device)
    x = L.embed(params.embed, cfg, tokens)
    for i, lp in enumerate(params.layers):
        x = _block(lp, cfg, x, backend=backend, state=cache["state"][i],
                   conv_state=cache["conv"][i])
    x = L.apply_norm(params.final_norm, cfg, x, backend=backend)
    logits = L.unembed(params.embed, cfg, x)
    return logits, dict(state=cache["state"], conv=cache["conv"],
                        length=int(cache["length"]) + tokens.shape[1])
