"""Wrapper of the CUDA RMSNorm kernel: check, plan, launch.

``rmsnorm(x, scale)`` normalises over the last axis of x (any leading
shape, float32 or bfloat16, D ≤ 8192) with a float32 scale [D].  On a CPU
tensor it runs the plain version in ``ref.py``; on a CUDA tensor it
launches the kernel of ``src/repro_torch/csrc/rmsnorm.cu`` or raises — no
fallback.  ``launch_counts()`` rises only where the kernel is launched.

How a row is served is a pure function of (dtype, D, alignment)
(:func:`_plan`): a warp a row up to ``WARP_MAX_D`` elements, a block a
row above; 16-byte vectors where D and every pointer allow, one element
at a time otherwise.  The host path of a call is kept short, as in the
flash-attention wrapper: one packed argument (``_LAUNCH``, the source's
``struct Launch``), the current stream read as a raw handle, no device
switch when x's device is current, no copy of an operand that is already
contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Dict, NamedTuple, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "rmsnorm.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Elements of a row that one thread holds at most: 32 // vec vectors.
ELEMS_PER_THREAD = 32
#: Rows up to this many elements take the warp route (32 lanes × 32).
WARP_MAX_D = 32 * ELEMS_PER_THREAD
#: Rows (one warp each) a block of the warp route.
WARP_ROWS = 4
#: Widest row: the block route's most threads (256) × 32 elements.
MAX_D = 8 * WARP_MAX_D
ROUTES = ("warp", "block")
_ROUTE_IDS = {r: i for i, r in enumerate(ROUTES)}

#: The C launcher's one argument: x, scale, out, the stream and the row
#: count (int64); dtype, vector width, route, threads and rows a block, D
#: (int32); eps; 4 bytes of padding.
_LAUNCH = struct.Struct("<5q6if4x")

_LIB = None
_LAUNCHES: Dict[str, int] = {"rmsnorm": 0}
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


class Plan(NamedTuple):
    """How the kernel serves a row: ``route`` ("warp" or "block"), ``vec``
    elements an access, ``items`` vectors a thread holds at most,
    ``threads`` a block and ``rows`` a block.  Vector j of a row goes to
    thread j % (threads // rows) of the row."""
    route: str
    vec: int
    items: int
    threads: int
    rows: int


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["rmsnorm"] = 0


@functools.lru_cache(maxsize=None)
def _plan(dtype: torch.dtype, d: int, aligned: bool) -> Plan:
    """The plan for rows of ``d`` elements of ``dtype``; ``aligned``: x,
    out and scale all lie on 16-byte boundaries.  16-byte vectors (8 bf16
    or 4 float32) where D is a multiple of their width and the pointers
    are aligned, one element otherwise; a warp a row (``WARP_ROWS`` rows a
    block) up to ``WARP_MAX_D`` elements, else a block a row of ⌈D /
    ``WARP_MAX_D``⌉ warps."""
    width = 16 // (4 if dtype == torch.float32 else 2)
    vec = width if aligned and d % width == 0 else 1
    items = ELEMS_PER_THREAD // vec
    if d <= WARP_MAX_D:
        return Plan("warp", vec, items, 32 * WARP_ROWS, WARP_ROWS)
    return Plan("block", vec, items, 32 * -(-d // WARP_MAX_D), 1)


def _lib():
    global _LIB
    if _LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib = _build.load(SOURCE, NVCC_FLAGS, {
            "rmsnorm_launch": [ctypes.c_char_p],
            "rmsnorm_constants": [p],
            "rmsnorm_resources": [i32, i32, i32, i32, p]})
        out = (ctypes.c_int * 5)()
        lib.rmsnorm_constants(out)
        want = (_LAUNCH.size, ELEMS_PER_THREAD, MAX_D, WARP_ROWS,
                MAX_D // ELEMS_PER_THREAD)
        if tuple(out) != want:
            raise RuntimeError(
                f"rmsnorm.cu's Launch size, elements a thread, widest D, rows "
                f"a warp-route block and most threads a block {tuple(out)} "
                f"do not match the wrapper's {want}")
        _LIB = lib
    return _LIB


def resources(dtype: torch.dtype, plan: Plan) -> Tuple[int, int, int]:
    """(registers a thread, local memory bytes a thread, blocks that one SM
    of the current card holds at once) of the kernel instance that serves
    ``plan`` for ``dtype``."""
    out = (ctypes.c_int * 3)()
    rc = _lib().rmsnorm_resources(_DTYPES[dtype], plan.vec,
                                  _ROUTE_IDS[plan.route], plan.threads, out)
    if rc != 0:
        raise RuntimeError(f"rmsnorm resources: CUDA error {rc}")
    return out[0], out[1], out[2]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D] float32 → x's shape and dtype."""
    dev = x.device
    if not x.is_cuda or scale.device != dev:
        if dev.type == "cpu" and scale.device.type == "cpu":
            return ref.rmsnorm_ref(x, scale, eps)
        raise ValueError(f"rmsnorm operands must lie together on the CPU or "
                         f"on one CUDA device, got {dev} and {scale.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise ValueError(f"rmsnorm scale must be float32 [{d}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm takes 0 < D <= {MAX_D}, got {d}")
    lib = _lib()
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty_like(x)      # fewer arguments to parse than torch.empty
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    plan = _plan(x.dtype, d, not (xp | sp | op) & 15)
    stream = (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    packed = _LAUNCH.pack(xp, sp, op, stream, x.numel() // d,
                          _DTYPES[x.dtype], plan.vec, _ROUTE_IDS[plan.route],
                          plan.threads, plan.rows, d, eps)
    if dev.index == (_GET_DEVICE() if _GET_DEVICE is not None
                     else torch.cuda.current_device()):
        rc = lib.rmsnorm_launch(packed)
    else:
        with torch.cuda.device(dev):
            rc = lib.rmsnorm_launch(packed)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    _LAUNCHES["rmsnorm"] += 1
    return out
