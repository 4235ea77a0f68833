"""Adafactor (Shazeer & Stern): factored second moment, no first moment,
no float32 master copy (the JAX package's ``optim/adafactor.py``).

For a parameter of shape [..., R, C] with R and C at least
``min_dim_factored`` the second moment is kept as row and column running
means [..., R] and [..., C]; other leaves keep a full moment.  ``update``
works in place, as :mod:`.adamw`'s does.  The update's RMS clip is taken
per leaf, so it sees one layer's tensor where the reference, whose
layers are stacked on a leading axis, sees all layers' at once: on
stacked trees the two differ (on the same trees they agree).
"""

from __future__ import annotations

import torch

from ..tree import flatten, tree_map
from .adamw import Optimizer, _device, step_lr_tensor


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, schedule=None, min_dim_factored=128
              ) -> Optimizer:
    def factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"slots": tree_map(per, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, step_lr=None):
        step = state["step"] + 1
        cur_lr = step_lr_tensor(schedule, step, step_lr, lr)
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)

        flat_p, treedef = flatten(params)
        flat_g = treedef.flatten_up_to(grads)
        flat_s = treedef.flatten_up_to(state["slots"])
        for g, slot, p in zip(flat_g, flat_s, flat_p):
            g = g.float()
            g2 = g * g + eps
            if "vr" in slot:
                vr = beta * slot["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * slot["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=eps))
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
                slot["vr"].copy_(vr)
                slot["vc"].copy_(vc)
            else:
                v = beta * slot["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                slot["v"].copy_(v)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            new_p = pf - cur_lr * (u + weight_decay * pf)
            p.copy_(new_p.to(p.dtype))
        state["step"] = step
        return params, state

    return Optimizer(init=init, update=update)

