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


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _map(tree, fn):
    """Apply ``fn`` to every leaf of a tree of dicts and lists, in the
    order of sorted dict keys (the order the JAX package flattens in)."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


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

    return _map(tree, mk)


def param_dict(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    """A flat dict of tensors as frozen parameters (inference only)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(tree) if is_spec(s))


def cast_tree(tree, dtype: torch.dtype):
    return _map(tree, lambda a: a.to(dtype) if a.dtype != dtype else a)
