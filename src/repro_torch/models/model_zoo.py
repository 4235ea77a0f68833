"""Model API of the port: the JAX package's ``models/model_zoo.py`` for
the families the port runs (dense, ssm).

``spec(cfg)`` → parameter Spec tree; ``init`` → the model's parameters as
an ``nn.Module``; ``forward`` → logits; ``cache_spec`` / ``decode_step`` →
the serving path.  The loss and ``input_specs`` belong to training and
the dry-run, which are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from . import params as P
from . import mamba2, transformer

_FAMILY = {
    "dense": transformer,
    "ssm": mamba2,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md); the "
            f"port runs {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def spec(cfg: ModelConfig):
    return module_for(cfg).spec(cfg)


def build(cfg: ModelConfig, tree: Dict[str, Any]) -> torch.nn.Module:
    """The model's parameters as a module of its family's class, from a
    tree of tensors."""
    return module_for(cfg).Model(cfg, tree)


def init(cfg: ModelConfig, generator: torch.Generator, device=None
         ) -> torch.nn.Module:
    """Random parameters from ``generator``, placed on ``device``."""
    return build(cfg, P.init_tree(spec(cfg), generator, device))


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            backend: Optional[str] = None):
    """Logits [B, T, vocab]; ``backend=None`` → the kernels on a CUDA
    device, their plain versions on the CPU."""
    return module_for(cfg).forward(params, cfg, batch, backend=backend)


def cache_spec(cfg: ModelConfig, batch_size: int, seq_len: int):
    return module_for(cfg).cache_spec(cfg, batch_size, seq_len)


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                backend: Optional[str] = None):
    return module_for(cfg).decode_step(params, cfg, tokens, cache,
                                       backend=backend)


def make_batch(cfg: ModelConfig, *, seq_len: int, global_batch: int,
               generator: torch.Generator, device=None
               ) -> Dict[str, torch.Tensor]:
    """Random token batch {tokens: [B, T] int64} (examples and smoke runs)."""
    module_for(cfg)
    tokens = torch.randint(0, cfg.vocab, (global_batch, seq_len),
                           generator=generator, device=generator.device)
    return {"tokens": tokens.to(device)}
