"""Model API of the port: the JAX package's ``models/model_zoo.py`` for
the families the port runs (dense, ssm).

``spec(cfg)`` → parameter Spec tree; ``init`` → the model's parameters as
an ``nn.Module``; ``forward`` → logits; ``cache_spec`` / ``decode_step`` →
the serving path; ``next_token_loss`` / ``loss_fn`` → the training loss
(both families: their kernels, flash attention, RMSNorm and the SSD scan,
have backward kernels).  ``input_specs`` belongs to the dry-run, which is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a family the port cannot train: every family it runs
    (dense, ssm) trains; any other raises ``NotImplementedError``."""
    module_for(cfg)


def build(cfg: ModelConfig, tree: Dict[str, Any], *,
          trainable: bool = False) -> torch.nn.Module:
    """The model's parameters as a module of its family's class, from a
    tree of tensors (sharing their storage); frozen unless ``trainable``."""
    if trainable:
        check_trainable(cfg)
        return module_for(cfg).Model(cfg, tree, trainable=True)
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


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    text_offset: int = 0) -> torch.Tensor:
    """Mean cross-entropy of predicting tokens[:, 1:] from logits.

    ``text_offset`` skips a non-text prefix in the logits (a view).  As in
    the reference, a position mask takes the place of a slice, so no [B,
    T−1, V] copy of the logits is made, the reductions run in float32 from
    the logits' own dtype, and the max subtracted before ``exp`` carries
    no gradient."""
    if text_offset:
        logits = logits[:, text_offset:]
    b, t, v = logits.shape
    # shifted targets; final position masked out
    tgt = torch.cat([tokens[:, 1:],
                     torch.zeros((b, 1), dtype=tokens.dtype,
                                 device=tokens.device)], dim=1)
    mask = (torch.arange(t, device=logits.device) < t - 1).float()[None, :]
    lf = logits.float()
    m = lf.detach().amax(-1, keepdim=True)
    logz = m[..., 0] + torch.log(torch.exp(lf - m).sum(-1))
    gold = torch.gather(logits, -1, tgt[..., None].long())[..., 0]
    nll = (logz - gold.float()) * mask
    return nll.sum() / mask.sum() / b


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (the next-token loss of ``batch``, {"loss": it}).  A family the
    port does not run raises ``NotImplementedError`` on every device."""
    check_trainable(cfg)
    logits = forward(params, cfg, batch, backend=backend)
    loss = next_token_loss(logits, batch["tokens"])
    return loss, {"loss": loss}


def make_batch(cfg: ModelConfig, *, seq_len: int, global_batch: int,
               generator: torch.Generator, device=None
               ) -> Dict[str, torch.Tensor]:
    """Random token batch {tokens: [B, T] int64} (examples and smoke runs)."""
    module_for(cfg)
    tokens = torch.randint(0, cfg.vocab, (global_batch, seq_len),
                           generator=generator, device=generator.device)
    return {"tokens": tokens.to(device)}
