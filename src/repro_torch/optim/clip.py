"""Global-norm gradient clipping (the JAX package's ``optim/clip.py``)."""

from __future__ import annotations

import torch

from ..tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, the leaves
    added in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """→ (grads scaled to a global norm of at most ``max_norm``, each in
    its own dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
