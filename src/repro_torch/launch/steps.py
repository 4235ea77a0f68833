"""The train step of the port (the JAX package's ``launch/steps.py::
build_train_step``), on one device.

``build_train_step`` returns ``(step_fn, opt)``.  ``step_fn(params,
opt_state, batch)`` takes the parameters as a tree of tensors (the tree
the model is built from, ``models.params.tree_of(model)``), runs the
batch's microbatches forward and backward, adds their gradients in float32
(bf16 above 100e9 parameters, as the reference does), divides by their
number, clips to a global norm of 1.0 and applies the optimizer; it
returns ``(params, opt_state, {"loss", "grad_norm"})``.  The update is in
place: the returned trees are the ones passed in.  Both families the port
runs train: dense (qwen2-0.5b) and ssm (mamba2-2.7b, through the SSD
scan's backward kernel on the card).  There is no mesh and
no sharding.  The reference's ``build_serve_step`` and
``build_prefill_step`` wait for the dry-run slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_backend, resolve_device
from ..models import model_zoo as Z
from ..models.params import tree_of
from ..optim import make_optimizer
from ..optim.clip import clip_by_global_norm
from ..tree import flatten


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   *, microbatches: int = 1, backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """→ (the batch's mean loss, its gradients as a tree like ``params``).

    With ``microbatches`` m > 1 the batch splits on dim 0 into m equal
    parts; each part's gradients (in the parameters' dtypes, as autograd
    gives them) are added to a running sum in the accumulation dtype,
    starting from zeros, and the sum and the summed loss are divided by m.
    With m = 1 the gradients keep the parameters' dtypes."""
    Z.check_trainable(cfg)
    flat, treedef = flatten(params)
    model = Z.build(cfg, params, trainable=True)
    leaves = flatten(tree_of(model))[0]
    m = microbatches
    if m <= 1:
        loss, _ = Z.loss_fn(model, cfg, batch, backend=backend)
        loss.backward()
        return loss.detach(), treedef.unflatten(p.grad for p in leaves)
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"global batch {b} does not split into {m} "
                         f"microbatches")
    acc = torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32
    gacc = [torch.zeros(p.shape, dtype=acc, device=p.device) for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    per = b // m
    for i in range(m):
        one = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        for p in leaves:
            p.grad = None
        loss, _ = Z.loss_fn(model, cfg, one, backend=backend)
        loss.backward()
        with torch.no_grad():
            for a, p in zip(gacc, leaves):
                a.add_(p.grad.to(acc))
            lsum = lsum + loss.detach()
    for p in leaves:
        p.grad = None
    with torch.no_grad():
        grads = [a / m for a in gacc]
    return lsum / m, treedef.unflatten(grads)


def build_train_step(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                     lr: float = 3e-4, microbatches: Optional[int] = None,
                     device=None, backend: Optional[str] = None):
    """→ (step_fn, opt).  ``device=None`` is the card (raising without
    one); ``backend=None`` the kernels there and the plain versions on
    the CPU (as :func:`repro_torch.device.resolve_backend` picks).
    ``seq_len`` and ``global_batch`` are the batch's shape, checked on
    each call."""
    Z.check_trainable(cfg)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    opt = make_optimizer(cfg, lr=lr)
    m = microbatches if microbatches is not None else cfg.microbatches

    def step(params, opt_state, batch):
        shape = tuple(batch["tokens"].shape)
        if shape != (global_batch, seq_len):
            raise ValueError(f"batch tokens {shape}, the step was built for "
                             f"{(global_batch, seq_len)}")
        loss, grads = loss_and_grads(params, cfg, batch, microbatches=m,
                                     backend=backend)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return step, opt
