"""Decoder-only transformer, dense family (qwen2-0.5b): the port of the
JAX package's ``models/transformer.py``.

Each layer is an ``nn.Module`` (:class:`Block`) in an ``nn.ModuleList``,
with parameter names that follow the reference's tree keys
(``layers.3.attn.wq``, ``layers.3.ffn.wi_gate``, ``final_norm.scale``,
``embed.tok``), so carrying weights across is a name map
(:func:`repro_torch.core.convert.params_from_arrays`).  The reference's
layer ``scan`` and ``fori_loop`` become Python loops; where ``cfg.remat``
and autograd records, each layer of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body with nothing saved): its activations are recomputed in the
backward, through the same kernels.  The MoE and VLM variants are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_backend
from . import layers as L
from .params import Spec, param_dict


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue A: "
            f"the LM modules); the port's transformer runs the dense family")


def block_spec(cfg) -> Dict[str, Any]:
    _check_family(cfg)
    return {
        "attn_norm": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.norm_spec(cfg),
        "ffn": L.mlp_spec(cfg),
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
    """One pre-norm layer: attention and MLP, each around a residual."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        self.attn_norm = param_dict(tree["attn_norm"], trainable)
        self.attn = param_dict(tree["attn"], trainable)
        self.mlp_norm = param_dict(tree["mlp_norm"], trainable)
        self.ffn = param_dict(tree["ffn"], trainable)


class Transformer(nn.Module):
    """The parameters of a dense decoder, built from an initialised tree
    (``params.init_tree(spec(cfg), ...)``); frozen unless ``trainable``."""

    def __init__(self, cfg, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        _check_family(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                             f"{cfg.name} {cfg.n_layers}")
        self.embed = param_dict(tree["embed"], trainable)
        self.layers = nn.ModuleList(Block(t, trainable)
                                    for t in tree["layers"])
        self.final_norm = param_dict(tree["final_norm"], trainable)


#: The family's model class, for ``model_zoo.build``.
Model = Transformer


def _layer(p: Block, cfg, x, positions, backend: str) -> torch.Tensor:
    """One layer of the forward (the unit that remat recomputes)."""
    return _block(p, cfg, x, positions=positions, backend=backend)[0]


def _block(p: Block, cfg, x, *, positions, backend: str, cache=None):
    h, new_cache = L.mha(p.attn, cfg,
                         L.apply_norm(p.attn_norm, cfg, x, backend=backend),
                         positions=positions, cache=cache, backend=backend)
    x = x + h
    x = x + L.apply_mlp(p.ffn, cfg,
                        L.apply_norm(p.mlp_norm, cfg, x, backend=backend))
    return x, new_cache


def forward(params: Transformer, cfg, batch: Dict[str, torch.Tensor], *,
            backend: Optional[str] = None) -> torch.Tensor:
    """Train / prefill forward → logits [B, T, vocab].  ``backend=None`` →
    the kernels on a CUDA device, their plain versions on the CPU.

    Differentiable: with trainable parameters and grad mode on, autograd
    records it (the kernels through their ``autograd.Function``s), each
    layer under ``torch.utils.checkpoint`` where ``cfg.remat`` and some
    parameter requires grad.  Serving calls it under
    ``torch.no_grad()``."""
    _check_family(cfg)
    tokens = batch["tokens"]
    backend = resolve_backend(backend, tokens.device)
    x = L.embed(params.embed, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    # remat only where autograd records: frozen parameters under grad mode
    # run the layers plainly, as under torch.no_grad()
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params.parameters()))
    for lp in params.layers:
        if remat:
            x = checkpoint(_layer, lp, cfg, x, positions, backend,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(lp, cfg, x, positions, backend)
    x = L.apply_norm(params.final_norm, cfg, x, backend=backend)
    return L.unembed(params.embed, cfg, x)


# ---------------------------------------------------------------------------
# Decode (new tokens against a prefilled KV cache)
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Stacked per-layer KV cache (bf16 zeros, as the reference's) and its
    length, one host integer shared by every slot."""
    kvh, hd, nl = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    kv = Spec((nl, batch_size, seq_len, kvh, hd), init="zeros")
    return {"k": kv, "v": kv, "length": 0}


@torch.no_grad()
def decode_step(params: Transformer, cfg, tokens: torch.Tensor,
                cache: Dict[str, Any], *, backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B, T] new token ids → (logits [B, T, vocab], new cache).

    The new K/V are written into ``cache["k"]`` / ``cache["v"]`` IN
    PLACE (the reference returns updated copies); the returned dict holds
    the same tensors and the advanced length.  Every slot writes at the
    one shared length, and it advances for all of them.  ``backend`` as
    in :func:`forward`."""
    _check_family(cfg)
    backend = resolve_backend(backend, tokens.device)
    x = L.embed(params.embed, cfg, tokens)
    length = int(cache["length"])
    positions = torch.full((1, 1), length, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params.layers):
        x, _ = _block(lp, cfg, x, positions=positions,
                      cache=dict(k=cache["k"][i], v=cache["v"][i],
                                 length=length), backend=backend)
    x = L.apply_norm(params.final_norm, cfg, x, backend=backend)
    logits = L.unembed(params.embed, cfg, x)
    return logits, dict(k=cache["k"], v=cache["v"],
                        length=length + tokens.shape[1])
