"""AdamW with float32 moments and float32 master weights over bf16
parameters (the JAX package's ``optim/adamw.py``).

The state mirrors the parameter tree: ``{"m", "v", "master"}`` trees of
float32 tensors and ``"step"``, a 0-dim int32 tensor.  The reference's
``state_shardings`` has no counterpart: the port runs on one card.

``update`` works IN PLACE where the reference returns new arrays: it
writes the new moments and master weights into the state's tensors and
the new parameters into ``params``' tensors (no second copy of a 6 GB
state at qwen2-0.5b), and returns the same trees with the advanced step.
The arithmetic is the reference's, operation for operation: the learning
rate and the bias corrections ``1 - b1**step``, ``1 - b2**step`` are
float32 tensors (Python floats would be float64 and move the master
weights' last bits), weight decay applies to the master, and the result
is cast to the parameter's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..tree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, step_lr=None) -> (params, state)
    update: Callable[..., Tuple[Any, Any]]


def _device(params) -> torch.device:
    flat, _ = flatten(params)
    return flat[0].device if flat else torch.device("cpu")


def step_lr_tensor(schedule, step, step_lr, lr) -> torch.Tensor:
    """The step's learning rate as a float32 tensor on the step's device."""
    if schedule is not None:
        return schedule(step)
    return torch.tensor(step_lr if step_lr is not None else lr,
                        dtype=torch.float32, device=step.device)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          schedule=None, keep_master=True) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        st = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
              "step": torch.zeros((), dtype=torch.int32,
                                  device=_device(params))}
        if keep_master:
            st["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return st

    @torch.no_grad()
    def update(grads, state, params, step_lr=None):
        step = state["step"] + 1
        cur_lr = step_lr_tensor(schedule, step, step_lr, lr)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=sf.device), sf)

        flat_p, treedef = flatten(params)
        flat_g = treedef.flatten_up_to(grads)
        flat_m = treedef.flatten_up_to(state["m"])
        flat_v = treedef.flatten_up_to(state["v"])
        flat_ma = (treedef.flatten_up_to(state["master"]) if keep_master
                   else [None] * len(flat_p))
        for g, m, v, p, master in zip(flat_g, flat_m, flat_v, flat_p,
                                      flat_ma):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            base = master if master is not None else p.float()
            step_vec = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            new_master = base - cur_lr * (step_vec + weight_decay * base)
            if master is not None:
                master.copy_(new_master)
            p.copy_(new_master.to(p.dtype))
        state["step"] = step
        return params, state

    return Optimizer(init=init, update=update)
