"""Wrapper of the CUDA flash-attention kernels: check, route, launch.

``flash_attention(q, k, v)`` takes the model's grouped-query layout —
q [B, T, H, D], k and v [B, S, KV, D] with KV dividing H — and returns
[B, T, H, D] in q's dtype.  Unlike the JAX package's wrapper it pads
nothing and repeats no kv head: the kernels mask the ragged tails and
map each query head to its kv head themselves, and k and v may be
strided views (a prefix of the KV cache).  On CPU tensors it runs the
plain version in ``ref.py``; on CUDA tensors it launches a kernel of
``src/repro_torch/csrc/flash_attention.cu`` or raises — no fallback.

Two routes, a pure function of (dtype, T, D) (:func:`_route`): bf16
with T >= ``MMA_MIN_ROWS`` query rows (prefill) takes ``"mma"``, the
kernel on the tensor cores; float32 at every shape and bf16 below that
(decode) take ``"fma"``, the kernel on the CUDA cores.  A failed build
or launch of either raises; neither route stands in for the other.
``launch_counts()`` rises by one a launch, whichever route;
``route_counts()`` counts the same launches by route.
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

#: Query rows from which bf16 attention takes the tensor-core kernel: one
#: warp's 16-row tile of ``mma.sync``.
MMA_MIN_ROWS = 16
ROUTES = ("fma", "mma")

_LIB = None
_LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_ROUTES: Dict[str, int] = dict.fromkeys(ROUTES, 0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0


def route_counts() -> Dict[str, int]:
    """Kernel launches by route since the last :func:`reset_route_counts`
    (at most one route a call; CPU tensors count on neither)."""
    return dict(_ROUTES)


def reset_route_counts() -> None:
    for r in ROUTES:
        _ROUTES[r] = 0


def _route(dtype: torch.dtype, t: int, d: int) -> str:
    """The kernel that serves q of ``dtype`` with ``t`` rows of head dim
    ``d``: ``"mma"`` (tensor cores) or ``"fma"`` (CUDA cores)."""
    if dtype == torch.bfloat16 and t >= MMA_MIN_ROWS and d in HEAD_DIMS:
        return "mma"
    return "fma"


def _lib():
    global _LIB
    if _LIB is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "flash_attention_launch": ([i32, i32, p, p, p, p] + [i32] * 6
                                       + [i64] * 9
                                       + [i32, i32, i32, ctypes.c_float, p]),
            "flash_attention_mma_resources": [i32, p]})
    return _LIB


def mma_resources(d: int) -> Tuple[int, int]:
    """(dynamic shared memory of one block in bytes, blocks that one SM of
    the current card holds at once) of the mma route's kernel at head dim
    ``d``."""
    out = (ctypes.c_int * 2)()
    rc = _lib().flash_attention_mma_resources(d, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention mma resources: CUDA error {rc}")
    return out[0], out[1]


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
    route = _route(q.dtype, t, d)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            ROUTES.index(route), _DTYPES[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            int(window), int(q_offset), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {rc}")
    _LAUNCHES["flash_attention"] += 1
    _ROUTES[route] += 1
    return out
