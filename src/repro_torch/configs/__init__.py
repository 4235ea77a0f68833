"""Architecture registry of the port: ``--arch <id>`` resolves here.

It holds only the architectures whose every module the port runs.  The
JAX package knows more; asking for one of those raises ``KeyError``
saying that it is not ported yet (ROADMAP.md lists them).
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from . import mamba2_2_7b, qwen2_0_5b

ARCHS: Dict[str, ModelConfig] = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
}

#: Architectures of the JAX package the port cannot run yet.
NOT_PORTED = ("qwen2-moe-a2.7b", "arctic-480b", "qwen2-vl-72b",
              "whisper-base", "recurrentgemma-9b",
              "qwen2.5-32b", "stablelm-1.6b", "phi3-mini-3.8b")


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (see ROADMAP.md); "
                       f"the port runs {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
