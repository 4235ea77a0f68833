"""Parameter specs: shape + initializer + dtype, in one tree.

A model describes its parameters once as a tree of :class:`Spec` (nested
dicts and lists); ``init_tree`` materialises it into torch tensors.  The
JAX package's Spec also carries logical sharding axes for its mesh; on
one card there is no mesh, so the port's Spec does not (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def init_tree(tree, generator: Optional[torch.Generator] = None,
              device=None):
    """Materialise a Spec tree into tensors on ``device``.

    ``normal`` leaves draw from ``generator`` one after the other, in
    sorted-key order, on the generator's own device (so a seed gives the
    same weights wherever they are placed).  Leaves that are not Specs
    (a cache's integer length) pass through unchanged."""

    def mk(spec: Any):
        if not is_spec(spec):
            return spec
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init != "normal":
            raise ValueError(f"unknown init {spec.init!r}")
        if generator is None:
            raise ValueError("init_tree needs a torch.Generator for the "
                             "tree's normal leaves")
        x = torch.randn(spec.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (x * spec.scale).to(device=device, dtype=spec.dtype)

    return tree_map(mk, tree)


def param_dict(tree: Dict[str, torch.Tensor], trainable: bool = False
               ) -> nn.ParameterDict:
    """A flat dict of tensors as parameters: frozen (inference) unless
    ``trainable``.  Each parameter shares its tensor's storage."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
                             for k, v in tree.items()})


def tree_of(module: nn.Module):
    """A model's parameters as the tree it was built from: a
    ``ParameterDict`` as a dict, a ``ModuleList`` as a list, any other
    module as a dict of its children and its own parameters."""
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    if isinstance(module, nn.ModuleList):
        return [tree_of(m) for m in module]
    out = {k: tree_of(m) for k, m in module.named_children()}
    out.update(module.named_parameters(recurse=False))
    return out


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(tree) if is_spec(s))


def cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda a: a.to(dtype) if a.dtype != dtype else a, tree)
