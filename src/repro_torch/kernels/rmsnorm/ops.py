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

Gradients.  Where autograd needs one (grad mode on and x or the scale
requiring a gradient) the call goes through :class:`RMSNorm`, an
``autograd.Function`` whose backward is :func:`rmsnorm_bwd`: the kernels
of ``src/repro_torch/csrc/rmsnorm_bwd.cu`` on the card (a row a warp up
to ``WARP_MAX_D``, a row a block above; dscale as per-block partial sums
added in block order, no atomics) and the plain backward of ``ref.py``
on the CPU.  ``backward_launch_counts()`` counts the backward calls that
launched the kernels.
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

BWD_SOURCE = _build.CSRC / "rmsnorm_bwd.cu"
#: The backward launcher's one argument: x, scale, g, dx, the partial sums,
#: dscale, the stream and the row count (int64); dtype, route, threads a
#: block, blocks, D (int32); eps.
_BWD_LAUNCH = struct.Struct("<8q5if")
#: Rows (one warp each) a block of the backward's warp route, and the most
#: blocks of a backward launch: the partial sums are [blocks, D].
BWD_WARP_ROWS = 8
BWD_MAX_BLOCKS = 264

_LIB = None
_BWD_LIB = None
_LAUNCHES: Dict[str, int] = {"rmsnorm": 0}
_BWD_LAUNCHES: Dict[str, int] = {"rmsnorm_bwd": 0}
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


def backward_launch_counts() -> Dict[str, int]:
    """Backward calls that launched the kernels since the last
    :func:`reset_backward_launch_counts` (one a call, two device
    launches)."""
    return dict(_BWD_LAUNCHES)


def reset_backward_launch_counts() -> None:
    _BWD_LAUNCHES["rmsnorm_bwd"] = 0


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


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load(BWD_SOURCE, NVCC_FLAGS, {
            "rmsnorm_bwd_launch": [ctypes.c_char_p],
            "rmsnorm_bwd_constants": [ctypes.c_void_p]})
        out = (ctypes.c_int * 5)()
        lib.rmsnorm_bwd_constants(out)
        want = (_BWD_LAUNCH.size, ELEMS_PER_THREAD, MAX_D, BWD_WARP_ROWS,
                MAX_D // ELEMS_PER_THREAD)
        if tuple(out) != want:
            raise RuntimeError(
                f"rmsnorm_bwd.cu's BwdLaunch size, elements a thread, widest "
                f"D, warps a warp-route block and most threads a block "
                f"{tuple(out)} do not match the wrapper's {want}")
        _BWD_LIB = lib
    return _BWD_LIB


def bwd_plan(n: int, d: int) -> Tuple[str, int, int]:
    """(route, threads a block, blocks) of the backward for ``n`` rows of
    ``d`` elements, a pure function of the shape (so the order of every
    sum, dscale's too, is fixed by it)."""
    if d <= WARP_MAX_D:
        return ("warp", 32 * BWD_WARP_ROWS,
                min(-(-n // BWD_WARP_ROWS), BWD_MAX_BLOCKS))
    return "block", 32 * -(-d // WARP_MAX_D), min(n, BWD_MAX_BLOCKS)


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


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise ValueError(f"rmsnorm scale must be float32 [{d}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm takes 0 < D <= {MAX_D}, got {d}")


def _on_cpu(x, scale) -> bool:
    """True for CPU operands; raises unless both lie on one CUDA device."""
    dev = x.device
    if not x.is_cuda or scale.device != dev:
        if dev.type == "cpu" and scale.device.type == "cpu":
            return True
        raise ValueError(f"rmsnorm operands must lie together on the CPU or "
                         f"on one CUDA device, got {dev} and {scale.device}")
    return False


def _stream(dev: torch.device) -> int:
    return (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
            else torch.cuda.current_stream(dev).cuda_stream)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dev = x.device
    d = x.shape[-1]
    lib = _lib()
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty_like(x)      # fewer arguments to parse than torch.empty
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    plan = _plan(x.dtype, d, not (xp | sp | op) & 15)
    stream = _stream(dev)
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D] float32 → x's shape and dtype.  Where
    autograd needs a gradient the call goes through :class:`RMSNorm`."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    if _on_cpu(x, scale):
        return ref.rmsnorm_ref(x, scale, eps)
    _check(x, scale)
    return _launch(x, scale, eps)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with a gradient: the backward is :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        if _on_cpu(x, scale):
            out = ref.rmsnorm_ref(x, scale, eps)
        else:
            _check(x, scale)
            out = _launch(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6):
    """The gradients (dx in x's dtype, dscale float32 [D]) of RMSNorm for
    the output gradient ``g`` (x's shape).  On CPU tensors the plain
    backward of ``ref.py``; on CUDA tensors the kernels of
    ``rmsnorm_bwd.cu`` or an error — no fallback."""
    if _on_cpu(x, scale) and g.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, g, eps)
    _check(x, scale)
    if g.device != x.device or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd takes g of x's shape {tuple(x.shape)} "
                         f"on {x.device}, got {tuple(g.shape)} on {g.device}")
    dev = x.device
    d = x.shape[-1]
    n = x.numel() // d
    lib = _bwd_lib()
    x, scale = x.contiguous(), scale.contiguous()
    g = g.to(x.dtype).contiguous()
    route, threads, blocks = bwd_plan(n, d)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=dev)
    dscale = torch.empty(d, dtype=torch.float32, device=dev)
    stream = _stream(dev)
    packed = _BWD_LAUNCH.pack(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), stream, n, _DTYPES[x.dtype],
        _ROUTE_IDS[route], threads, blocks, d, eps)
    with torch.cuda.device(dev):
        rc = lib.rmsnorm_bwd_launch(packed)
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA "
                           f"error {rc}")
    _BWD_LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale
