"""Optimizers of the port (the JAX package's ``optim``): AdamW, Adafactor,
schedules and global-norm clipping.  ``compress.py``'s collectives wait
for the port's parallel slice (ROADMAP.md)."""

from .adamw import Optimizer, adamw  # noqa: F401
from .adafactor import adafactor  # noqa: F401
from .schedule import constant_schedule, cosine_schedule  # noqa: F401
from .clip import clip_by_global_norm, global_norm  # noqa: F401


def make_optimizer(cfg, lr=3e-4, **kw):
    """Optimizer factory keyed off the architecture config."""
    if cfg.optimizer == "adafactor":
        return adafactor(lr=lr, **kw)
    return adamw(lr=lr, **kw)
