"""Learning-rate schedules, pure functions of the step counter (the JAX
package's ``optim/schedule.py``): float32 tensors on the step's device.

A division by a constant is a product with its float32 reciprocal, as
XLA compiles the reference's, so the two give the same bits."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup_steps: int = 100,
                    total_steps: int = 10_000, min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step * (1.0 / max(warmup_steps, 1)),
                                     max=1.0)
        t = torch.clamp((step - warmup_steps)
                        * (1.0 / max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return lr


def constant_schedule(base_lr: float):
    def lr(step):
        return torch.tensor(base_lr, dtype=torch.float32,
                            device=torch.as_tensor(step).device)

    return lr
