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
of ``src/repro_torch/csrc/rmsnorm_bwd.cu`` on the card and the plain
backward of ``ref.py`` on the CPU.  Its plan (:func:`bwd_plan`) takes the
forward's route and vector width (16-byte vectors where D and the x, g,
dx and scale pointers allow) with ``BWD_WARP_ROWS`` rows a warp-route
block, and a grid capped by a constant a route; dscale is one row of
partial sums a block (in a workspace kept per device and stream), summed
by a second launch in a fixed order, no atomics.  Its host path is the
forward's: one packed argument (``_BWD_LAUNCH``), no device switch when
x's device is current, no copy of an operand that is already contiguous
and of x's dtype.
``backward_launch_counts()`` counts the backward calls that launched the
kernels.
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
#: dscale, the stream and the row count (int64); dtype, vector width,
#: route, threads a block, blocks, D (int32); eps; 4 bytes of padding.
_BWD_LAUNCH = struct.Struct("<8q6if4x")
#: Rows (one warp each) a block of the backward's warp route.
BWD_WARP_ROWS = 8
#: The most blocks of a warp-route backward launch and the most warps of
#: a block-route one (constants, not read from the card): the partial sums
#: are [blocks, D].
BWD_WARP_BLOCKS = 264
BWD_BLOCK_WARPS = 1980
#: Warps of a block of the dscale launch, which sums 32 columns.
BWD_REDUCE_WARPS = 16

_LIB = None
_BWD_LIB = None
_LAUNCHES: Dict[str, int] = {"rmsnorm": 0}
_BWD_LAUNCHES: Dict[str, int] = {"rmsnorm_bwd": 0}
# the backward's workspace of dscale partial sums by (device index,
# stream): (tensor, address); calls on one stream run in turn
_PARTIALS: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


class BwdPlan(NamedTuple):
    """How the backward serves ``n`` rows: ``route``, ``vec`` and ``items``
    as the forward's :class:`Plan`, ``threads`` a block, ``blocks`` (the
    partial rows of dscale) and ``reduce_blocks`` of the dscale launch (32
    columns each).  Warp route: warp w of block b takes rows b·8 + w,
    b·8 + w + 8·blocks, ...; block route: block b takes rows b, b +
    blocks, ...; vector j of a row goes to lane (thread) j % (threads of
    the row)."""
    route: str
    vec: int
    items: int
    threads: int
    blocks: int
    reduce_blocks: int


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
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib = _build.load(BWD_SOURCE, NVCC_FLAGS, {
            "rmsnorm_bwd_launch": [ctypes.c_char_p],
            "rmsnorm_bwd_constants": [p],
            "rmsnorm_bwd_resources": [i32, i32, i32, i32, p]})
        out = (ctypes.c_int * 8)()
        lib.rmsnorm_bwd_constants(out)
        want = (_BWD_LAUNCH.size, ELEMS_PER_THREAD, MAX_D, BWD_WARP_ROWS,
                MAX_D // ELEMS_PER_THREAD, BWD_WARP_BLOCKS, BWD_BLOCK_WARPS,
                BWD_REDUCE_WARPS)
        if tuple(out) != want:
            raise RuntimeError(
                f"rmsnorm_bwd.cu's BwdLaunch size, elements a thread, widest "
                f"D, warps a warp-route block, most threads a block, most "
                f"blocks of a warp-route launch, most warps of a block-route "
                f"launch and warps a dscale block {tuple(out)} do not match "
                f"the wrapper's {want}")
        _BWD_LIB = lib
    return _BWD_LIB


@functools.lru_cache(maxsize=256)
def bwd_plan(dtype: torch.dtype, n: int, d: int, aligned: bool) -> BwdPlan:
    """The backward's plan for ``n`` rows of ``d`` elements of ``dtype``;
    ``aligned``: x, g, dx and the scale all lie on 16-byte boundaries.  The
    route and vector width are the forward's (:func:`_plan`); the grid is
    min(the rows' blocks, ``BWD_WARP_BLOCKS`` or ``BWD_BLOCK_WARPS`` over
    the warps a block), a function of (n, d) alone, so the order of every
    sum, dscale's too, is fixed by (dtype, n, d, aligned)."""
    p = _plan(dtype, d, aligned)
    if p.route == "warp":
        threads = 32 * BWD_WARP_ROWS
        blocks = min(-(-n // BWD_WARP_ROWS), BWD_WARP_BLOCKS)
    else:
        threads = p.threads
        blocks = min(n, BWD_BLOCK_WARPS // (threads // 32))
    return BwdPlan(p.route, p.vec, p.items, threads, blocks, -(-d // 32))


def bwd_resources(dtype: torch.dtype, d: int) -> Dict[str, Dict[str, int]]:
    """{device kernel: {"registers": a thread, "spill_bytes": local memory
    a thread, "shared": static shared memory a block, "blocks_per_sm":
    blocks that one SM of the current card holds at once, "threads": a
    block}} of the backward's two launches for aligned rows of ``d``
    elements of ``dtype``, in launch order."""
    plan = bwd_plan(dtype, 1, d, True)
    out = (ctypes.c_int * 8)()
    rc = _bwd_lib().rmsnorm_bwd_resources(_DTYPES[dtype], plan.vec,
                                          _ROUTE_IDS[plan.route],
                                          plan.threads, out)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_bwd resources: CUDA error {rc}")
    names = (f"rmsnorm_bwd_{plan.route}_kernel", "rmsnorm_bwd_dscale_kernel")
    threads = (plan.threads, 32 * BWD_REDUCE_WARPS)
    return {n: dict(registers=out[4 * i], spill_bytes=out[4 * i + 1],
                    shared=out[4 * i + 2], blocks_per_sm=out[4 * i + 3],
                    threads=threads[i])
            for i, n in enumerate(names)}


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


def _partials(dev: torch.device, stream: int, n: int) -> int:
    """Address of a float32 workspace of at least ``n`` elements for the
    backward's partial sums on (``dev``, ``stream``): the dscale launch
    reads them before the next call on the stream writes them."""
    held = _PARTIALS.get((dev.index, stream))
    if held is None or held[0].numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        held = _PARTIALS[(dev.index, stream)] = (buf, buf.data_ptr())
    return held[1]


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
    dev = x.device
    if g.device != dev or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd takes g of x's shape {tuple(x.shape)} "
                         f"on {dev}, got {tuple(g.shape)} on {g.device}")
    d = x.shape[-1]
    n = x.numel() // d
    lib = _bwd_lib()
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    if g.dtype != x.dtype:
        g = g.to(x.dtype)
    if not g.is_contiguous():
        g = g.contiguous()
    dx = torch.empty_like(x)
    xp, sp, gp, dp = x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr()
    plan = bwd_plan(x.dtype, n, d, not (xp | sp | gp | dp) & 15)
    dscale = torch.empty_like(scale)
    stream = _stream(dev)
    packed = _BWD_LAUNCH.pack(
        xp, sp, gp, dp, _partials(dev, stream, plan.blocks * d),
        dscale.data_ptr(), stream, n, _DTYPES[x.dtype], plan.vec,
        _ROUTE_IDS[plan.route], plan.threads, plan.blocks, d, eps)
    if dev.index == (_GET_DEVICE() if _GET_DEVICE is not None
                     else torch.cuda.current_device()):
        rc = lib.rmsnorm_bwd_launch(packed)
    else:
        with torch.cuda.device(dev):
            rc = lib.rmsnorm_bwd_launch(packed)
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA "
                           f"error {rc}")
    _BWD_LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale
