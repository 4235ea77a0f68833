"""Carry inputs across from another package as plain data.

The port keeps its own copies of ``accelerator`` and ``topology``.
``grid_from_fields`` and ``networks_from_dicts`` rebuild the port's
objects from plain numpy columns and dicts — ``ConfigGrid.fields`` and
``dataclasses.asdict(layer)`` of the JAX package's objects, say — so both
packages evaluate the same grid and the same layers.
``params_from_arrays`` loads a language model's parameter tree, as nested
dicts of numpy arrays, into the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from .accelerator import GRID_COLUMNS, ConfigGrid
from .topology import Layer


def grid_from_fields(fields: Mapping[str, np.ndarray]) -> ConfigGrid:
    """A port ConfigGrid from ``{column: float64 [n]}`` (every column of
    ``GRID_COLUMNS``; validated like any grid)."""
    return ConfigGrid({k: np.array(fields[k], dtype=np.float64)
                       for k in GRID_COLUMNS})


def networks_from_dicts(nets: Mapping[str, Sequence[Mapping[str, Any]]]
                        ) -> Dict[str, List[Layer]]:
    """Port networks from ``{name: [layer as a field dict, ...]}``."""
    return {name: [Layer(**dict(d)) for d in layers]
            for name, layers in nets.items()}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy → torch, exactly.  bfloat16 arrays (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) go through a uint16 view of their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_arrays(tree: Mapping[str, Any], cfg, device=None
                       ) -> torch.nn.Module:
    """The port's model from another package's parameter tree.

    ``tree`` is nested dicts of numpy arrays with the JAX package's keys,
    its layer leaves stacked on a leading ``[n_layers, ...]`` axis (as
    ``jax.tree.map(np.asarray, params)`` gives them).  Every leaf keeps
    its dtype and bits; the layers are unstacked into the port's
    per-layer modules."""
    from ..models import model_zoo

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), device)

    def unstack(node, i):
        if isinstance(node, Mapping):
            return {k: unstack(v, i) for k, v in node.items()}
        return node[i].clone()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    layers = conv(tree["layers"])
    out["layers"] = [unstack(layers, i) for i in range(cfg.n_layers)]
    return model_zoo.build(cfg, out)
