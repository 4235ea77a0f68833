"""Wrapper of the CUDA RMSNorm kernel: check, flatten, launch.

``rmsnorm(x, scale)`` normalises over the last axis of x (any leading
shape, float32 or bfloat16, D ≤ 8192) with a float32 scale [D].  On a CPU
tensor it runs the plain version in ``ref.py``; on a CUDA tensor it
launches the kernel of ``src/repro_torch/csrc/rmsnorm.cu`` or raises — no
fallback.  ``launch_counts()`` rises only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "rmsnorm.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

#: Widest row the kernel takes: 128 threads × 64 values held per thread.
MAX_D = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None
_LAUNCHES: Dict[str, int] = {"rmsnorm": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["rmsnorm"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "rmsnorm_launch": [i32, p, p, p, i64, i32, ctypes.c_float, p]})
    return _LIB


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D] float32 → x's shape and dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm operands must lie together on the CPU or "
                         f"on one CUDA device, got {x.device} and "
                         f"{scale.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm scale must be float32 [{d}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm takes 0 < D <= {MAX_D}, got {d}")
    lib = _lib()
    x2 = x.reshape(-1, d).contiguous()
    sc = scale.contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_launch(
            _DTYPES[x.dtype], x2.data_ptr(), sc.data_ptr(), out.data_ptr(),
            x2.shape[0], d, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    _LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
