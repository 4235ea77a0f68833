"""Wrapper of the CUDA flash-attention kernel: check, launch.

``flash_attention(q, k, v)`` takes the model's grouped-query layout —
q [B, T, H, D], k and v [B, S, KV, D] with KV dividing H — and returns
[B, T, H, D] in q's dtype.  Unlike the JAX package's wrapper it pads
nothing and repeats no kv head: the kernel masks the ragged tails and
maps each query head to its kv head itself, and k and v may be strided
views (a prefix of the KV cache).  On CPU tensors it runs the plain
version in ``ref.py``; on CUDA tensors it launches the kernel of
``src/repro_torch/csrc/flash_attention.cu`` or raises — no fallback.
``launch_counts()`` rises only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "flash_attention.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None
_LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "flash_attention_launch": ([i32, p, p, p, p] + [i32] * 6
                                       + [i64] * 9
                                       + [i32, i32, i32, ctypes.c_float, p])})
    return _LIB


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x with a contiguous last axis and 16-byte aligned rows, as the
    kernel's vector loads need; copied only where it has neither."""
    vec = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in x.stride()[:-1])):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, T, H, D]; k, v: [B, S, KV, D] → [B, T, H, D].

    Query row t sits at position ``q_offset + t``: ``causal`` lets it see
    keys up to that position, ``window`` > 0 only the last ``window`` of
    them.  Every key of k is valid otherwise (pass a prefix view of a
    cache to mask its unwritten tail)."""
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention operands must lie together on "
                         f"the CPU or on one CUDA device, got {devs}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, T, H, D] and k, v "
                         f"[B, S, KV, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and D, KV dividing H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < b <= 65535 or window < 0:
        raise ValueError(f"flash_attention takes 0 < B <= 65535 and "
                         f"window >= 0, got B={b}, window={window}")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, t, s, h, kvh, d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
            int(q_offset), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _LAUNCHES["flash_attention"] += 1
    return out
