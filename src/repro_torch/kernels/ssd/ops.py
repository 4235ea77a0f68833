"""Wrapper of the CUDA SSD chunked-scan kernel: check, launch.

``ssd_scan(x, dt, A, b, c)`` takes the JAX wrapper's layout — x
[B, T, H, P], dt [B, T, H], A [H] float32, b and c [B, T, G, N] with G
dividing H — and returns y [B, T, H, P] in x's dtype.  Unlike the JAX
wrapper it repeats no group and pads nothing: the kernel reads head h's
group ``h // (H / G)`` through the strides and masks a ragged last chunk.
x, b and c may be strided views (column slices of the model's conv
output) as long as their last axis is contiguous; they are not copied.
dt is float32 or x's dtype (widened to float32 here, a [B, T, H] copy).
On CPU tensors it runs the plain version in ``ref.py``; on CUDA tensors
it launches the kernel of ``src/repro_torch/csrc/ssd.cu`` or raises — no
fallback.  ``launch_counts()`` rises only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "ssd.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

#: Largest head width, state width and chunk the kernel takes.
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None
_LAUNCHES: Dict[str, int] = {"ssd": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["ssd"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "ssd_scan_launch": [i32, p, p, p, p, p, p] + [i32] * 7 + [p, p]})
    return _LIB


def _check(x, dt, A, b, c, chunk) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or b.dim() != 4 \
            or b.shape != c.shape:
        raise ValueError(
            f"ssd_scan takes x [B, T, H, P], dt [B, T, H], A [H] and b, c "
            f"[B, T, G, N], got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, t, h, _ = x.shape
    g = b.shape[2]
    if (tuple(dt.shape) != (bsz, t, h) or tuple(A.shape) != (h,)
            or tuple(b.shape[:2]) != (bsz, t)):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} or b, c {tuple(b.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if h % g:
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x, b, c of one "
                         f"dtype, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype not in (torch.float32, x.dtype) or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan takes dt in float32 or x's dtype and A "
                         f"in float32, got {dt.dtype}, {A.dtype}")
    if chunk < 1:
        raise ValueError(f"ssd_scan takes chunk >= 1, got {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256
             ) -> torch.Tensor:
    """x: [B, T, H, P]; dt: [B, T, H]; A: [H] float32 (negative); b, c:
    [B, T, G, N] → y [B, T, H, P] in x's dtype.  Chunks of
    ``min(chunk, T)`` steps."""
    _check(x, dt, A, b, c, chunk)
    devs = {x.device, dt.device, A.device, b.device, c.device}
    if devs == {torch.device("cpu")}:
        return ref.ssd_scan_ref(x, dt, A, b, c, chunk=chunk)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd_scan operands must lie together on the CPU or "
                         f"on one CUDA device, got {devs}")
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, t)
    if p > MAX_P or n > MAX_N or q > MAX_CHUNK or bsz * h > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan's kernel takes P <= {MAX_P}, N <= "
                         f"{MAX_N} and chunk <= {MAX_CHUNK}, got P={p}, "
                         f"N={n}, chunk={q}")
    x, b, c = (a if a.stride(-1) == 1 else a.contiguous() for a in (x, b, c))
    dt = dt.float()
    A = A.contiguous()
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                    *b.stride()[:3], *c.stride()[:3])
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), bsz, t, h, p, g, n, q,
            strides, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    _LAUNCHES["ssd"] += 1
    return y
