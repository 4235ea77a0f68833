"""Carry inputs across from another package as plain data.

The port keeps its own copies of ``accelerator`` and ``topology``.
``grid_from_fields`` and ``networks_from_dicts`` rebuild the port's
objects from plain numpy columns and dicts — ``ConfigGrid.fields`` and
``dataclasses.asdict(layer)`` of the JAX package's objects, say — so both
packages evaluate the same grid and the same layers.
``params_from_arrays`` loads a language model's parameter tree, as nested
dicts of numpy arrays, into the port's modules, and
``opt_state_from_arrays`` an optimizer's state (AdamW's ``m``, ``v``,
``master`` and ``step``, Adafactor's ``slots`` and ``step``) into the
port's optimizer state.  ``tree_to_arrays`` maps the port's parameters,
gradients or state back to the reference's tree (the layers stacked on a
leading axis) as numpy, so tests compare leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..tree import flatten
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


def tree_from_arrays(tree: Mapping[str, Any], cfg, device=None
                     ) -> Dict[str, Any]:
    """The port's tree of tensors from a reference tree of numpy arrays
    whose ``layers`` leaves are stacked on a leading ``[n_layers, ...]``
    axis: every leaf keeps its dtype and bits, ``layers`` becomes a list
    of per-layer trees."""

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), device)

    def unstack(node, i):
        if isinstance(node, Mapping):
            return {k: unstack(v, i) for k, v in node.items()}
        return node[i].clone()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        layers = conv(tree["layers"])
        out["layers"] = [unstack(layers, i) for i in range(cfg.n_layers)]
    return out


def params_from_arrays(tree: Mapping[str, Any], cfg, device=None
                       ) -> torch.nn.Module:
    """The port's model from another package's parameter tree.

    ``tree`` is nested dicts of numpy arrays with the JAX package's keys,
    its layer leaves stacked on a leading ``[n_layers, ...]`` axis (as
    ``jax.tree.map(np.asarray, params)`` gives them).  Every leaf keeps
    its dtype and bits; the layers are unstacked into the port's
    per-layer modules."""
    from ..models import model_zoo

    return model_zoo.build(cfg, tree_from_arrays(tree, cfg, device))


def opt_state_from_arrays(state: Mapping[str, Any], cfg, device=None
                          ) -> Dict[str, Any]:
    """The port's optimizer state from the reference's, as numpy: AdamW's
    ``{"m", "v", "master", "step"}`` or Adafactor's ``{"slots",
    "step"}``, each tree's layers unstacked as in
    :func:`tree_from_arrays`, ``step`` a 0-dim int32 tensor."""
    out = {k: tree_from_arrays(v, cfg, device)
           for k, v in state.items() if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


def _array(x) -> np.ndarray:
    """A tensor as numpy: bfloat16 widened to float32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def tree_to_arrays(tree) -> Dict[str, Any]:
    """The reference's tree, as numpy, from the port's parameters (a model
    or its tree), gradients or optimizer state: ``layers``' per-layer
    trees stacked on a leading axis, bfloat16 leaves widened to float32
    (exactly), every other leaf as it is."""
    from ..models.params import tree_of

    if isinstance(tree, torch.nn.Module):
        tree = tree_of(tree)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _array(node)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        per_layer = [flatten(conv(t)) for t in tree["layers"]]
        treedef = per_layer[0][1]
        out["layers"] = treedef.unflatten(
            np.stack(leaves) for leaves in zip(*(f for f, _ in per_layer)))
    return out
