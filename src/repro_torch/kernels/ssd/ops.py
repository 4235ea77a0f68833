"""Wrapper of the CUDA SSD chunked scan: check, allocate, launch the passes.

``ssd_scan(x, dt, A, b, c)`` takes the JAX wrapper's layout — x
[B, T, H, P], dt [B, T, H], A [H] float32, b and c [B, T, G, N] with G
dividing H — and returns y [B, T, H, P] in x's dtype.  Unlike the JAX
wrapper it repeats no group and pads nothing: the kernels read head h's
group ``h // (H / G)`` through the strides and mask a ragged last chunk.
x, b and c may be strided views (column slices of the model's conv
output) as long as their last axis is contiguous; they are not copied.
dt is float32 or x's dtype (widened to float32 here, a [B, T, H] copy).

On the card one scan call is four device launches of
``src/repro_torch/csrc/ssd.cu``, in order on the current stream: the chunk
state (cum and each chunk's own state S_c), C Bᵀ once per group, the
state pass (the state entering each chunk, S_prev, in x's dtype) and the
chunk scan (y).  This wrapper allocates every intermediate; each pass is
callable alone (``_chunk_state``, ``_cb``, ``_state_pass``,
``_chunk_scan``) so that it can be held against its plain counterpart in
``ref.py``.  On CPU tensors ``ssd_scan`` runs the plain version; on CUDA
tensors it launches the kernels or raises — no fallback.
``launch_counts()["ssd"]`` rises by one per scan call on the card.

The gradient.  Where grad mode is on and an operand requires grad,
``ssd_scan`` goes through :class:`SSDScan`, whose backward is
:func:`ssd_scan_bwd`: on the card it recomputes cum, C Bᵀ and S_prev
(float32) with the forward's passes 1-3 from the saved inputs, then
launches the passes of ``src/repro_torch/csrc/ssd_bwd.cu`` of the route
that x's dtype picks (:func:`_bwd_route`): bfloat16 ``"mma"`` (the tensor
cores; chunk out, state slices, state side, diag, group, reduce slices:
dB and dC once a group) or float32 ``"fma"`` (the CUDA cores; chunk out,
state, state side, diag, reduce), each pass callable alone (``_bwd_*``)
to be held against its plain counterpart in ``ref.py``; on CPU tensors it
runs ``ref.ssd_scan_bwd_ref``.  ``backward_launch_counts()["ssd_bwd"]``
rises by one per backward call on the card, ``backward_route_counts()``
counts the same calls by route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "ssd.cu"
BWD_SOURCE = _build.CSRC / "ssd_bwd.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

#: Largest head width, state width and chunk the kernels take.
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The passes of one scan call, in launch order (``ssd_pass_launch``'s
#: first argument).
PASSES = ("chunk_state", "cb", "state_pass", "chunk_scan")
#: The backward's routes and their passes, in launch order; a pass's
#: index in ``fma`` then ``mma`` is ``ssd_bwd_pass_launch``'s first
#: argument.  Pass ``name``'s device kernel is ``ssd_bwd_<name>_kernel``.
BWD_ROUTES = ("fma", "mma")
BWD_PASSES = {"fma": ("chunk_out", "state", "state_side", "diag", "reduce"),
              "mma": ("chunk_out_mma", "state_slices", "state_side_mma",
                      "diag_mma", "group", "reduce_slices")}
_BWD_PASS_IDS = BWD_PASSES["fma"] + BWD_PASSES["mma"]
#: The pointers ``ssd_bwd_pass_launch`` takes, in order.
BWD_OPERANDS = ("x", "dt", "a", "b", "c", "dy", "cum", "dtc", "prev", "cb",
                "ds", "dcum", "dtot", "du", "dbh", "dch", "dapart", "dx",
                "ddt", "da", "db", "dc", "dcbw", "ptot", "pdb", "pdc")
#: Rows of a tile of the mma route's dCB workspace (64 x 64 fp32).
BWD_TILE = 64

_LIB = None
_BWD_LIB = None
_LAUNCHES: Dict[str, int] = {"ssd": 0}
_BWD_LAUNCHES: Dict[str, int] = {"ssd_bwd": 0}
_BWD_ROUTE_COUNTS: Dict[str, int] = dict.fromkeys(BWD_ROUTES, 0)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def launch_counts() -> Dict[str, int]:
    """Scan calls on the card since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["ssd"] = 0


def backward_launch_counts() -> Dict[str, int]:
    """Backward calls on the card since the last
    :func:`reset_backward_launch_counts`."""
    return dict(_BWD_LAUNCHES)


def reset_backward_launch_counts() -> None:
    _BWD_LAUNCHES["ssd_bwd"] = 0


def backward_route_counts() -> Dict[str, int]:
    """Backward calls on the card by route since the last
    :func:`reset_backward_route_counts` (CPU tensors count on none)."""
    return dict(_BWD_ROUTE_COUNTS)


def reset_backward_route_counts() -> None:
    for r in BWD_ROUTES:
        _BWD_ROUTE_COUNTS[r] = 0


def _bwd_route(dtype: torch.dtype) -> str:
    """The backward's route for x of ``dtype``: ``"mma"`` for bfloat16
    (tensor cores; the products of two bf16 inputs exact, an fp32 operand
    fed as two bf16 terms), ``"fma"`` for float32 (CUDA cores, fp32
    products: its 2e-4 tolerance is held with no bf16 operand)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _lib():
    global _LIB
    if _LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "ssd_pass_launch": [i32, i32, p, p, p, p],
            "ssd_scan_launch": [i32, p, p, p, p, p],
            "ssd_pass_resources": [i32, i32, p]})
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        _BWD_LIB = _build.load(BWD_SOURCE, NVCC_FLAGS, {
            "ssd_bwd_pass_launch": [i32, i32, p, p, p, p],
            "ssd_bwd_launch": [i32, p, p, p, p, p],
            "ssd_bwd_resources": [i32, p]})
    return _BWD_LIB


def bwd_resources(name: str) -> Dict[str, int]:
    """Backward pass ``name``'s dynamic shared memory a block (bytes), the
    blocks one SM of the current card holds at once, and its registers and
    local (spill) bytes a thread (an fma pass as built for float32, an mma
    pass for bfloat16)."""
    out = (ctypes.c_int * 4)()
    rc = _bwd_lib().ssd_bwd_resources(_BWD_PASS_IDS.index(name), out)
    if rc != 0:
        raise RuntimeError(f"ssd backward {name} pass resources: CUDA error "
                           f"{rc}")
    return dict(smem_bytes=out[0], blocks_per_sm=out[1], registers=out[2],
                local_bytes=out[3])


def pass_resources(name: str, dtype: torch.dtype) -> Tuple[int, int]:
    """(dynamic shared memory of one block in bytes, blocks that one SM of
    the current card holds at once) of pass ``name``."""
    out = (ctypes.c_int * 2)()
    rc = _lib().ssd_pass_resources(PASSES.index(name), _DTYPES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"ssd {name} pass resources: CUDA error {rc}")
    return out[0], out[1]


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


def _strides(x=None, dt=None, b=None, c=None):
    """The 12 element strides the C launchers take (0 for an operand a pass
    does not read)."""
    out = [0] * 12
    for i, v in enumerate((x, dt, b, c)):
        if v is not None:
            out[3 * i:3 * i + 3] = v.stride()[:3]
    return out


def _stream(device: torch.device) -> int:
    return (_RAW_STREAM(device.index) if _RAW_STREAM is not None
            else torch.cuda.current_stream(device).cuda_stream)


def _on(device: torch.device, launch):
    """``launch(stream)`` with ``device`` current, entering it only where
    it is not the current device already."""
    if device.index == (_GET_DEVICE() if _GET_DEVICE is not None
                        else torch.cuda.current_device()):
        return launch(_stream(device))
    with torch.cuda.device(device):
        return launch(_stream(device))


def _run(dtype, ptrs, dims, strides, device, index=None) -> None:
    """Launch pass ``PASSES[index]`` — or, with no index, the four passes
    in order, each checked before the next — on the current stream; raises
    on a non-zero CUDA error.  ``ptrs``: the 11 device addresses of
    ``ssd_pass_launch``; ``dims``: (batch, t, h, p, g, n, chunk)."""
    args = ((ctypes.c_void_p * 11)(*ptrs), (ctypes.c_int * 7)(*dims),
            (ctypes.c_int64 * 12)(*strides))
    failed = ctypes.c_int(index or 0)
    lib = _lib()
    if index is None:
        rc = _on(device, lambda st: lib.ssd_scan_launch(
            _DTYPES[dtype], *args, st, ctypes.byref(failed)))
    else:
        rc = _on(device, lambda st: lib.ssd_pass_launch(
            index, _DTYPES[dtype], *args, st))
    if rc != 0:
        raise RuntimeError(f"ssd {PASSES[failed.value]} pass launch failed: "
                           f"CUDA error {rc}")


def _launch(name: str, dtype: torch.dtype, dims, *, x=None, dt=None, A=None,
            b=None, c=None, y=None, cum=None, states=None, cb=None,
            prev=None, dtc=None) -> None:
    """Check the operands of pass ``name`` and launch it alone."""
    operands = (x, dt, A, b, c, y, cum, states, cb, prev, dtc)
    tensors = [v for v in operands if v is not None]
    dev = tensors[0].device
    if dev.type != "cuda" or any(v.device != dev for v in tensors):
        raise ValueError(f"the ssd {name} pass takes operands on one CUDA "
                         f"device, got {[v.device for v in tensors]}")
    for v in (cum, states, cb, dtc):
        if v is not None and (v.dtype != torch.float32
                              or not v.is_contiguous()):
            raise ValueError(f"the ssd {name} pass takes contiguous float32 "
                             f"cum, dt by chunk, states and C Bᵀ")
    for v in (x, b, c):
        if v is not None and v.stride(-1) != 1:
            raise ValueError(f"the ssd {name} pass takes x, b, c with a "
                             f"contiguous last axis")
    if prev is not None and (prev.dtype != dtype or not prev.is_contiguous()):
        raise ValueError(f"the ssd {name} pass takes a contiguous S_prev in "
                         f"{dtype}")
    _run(dtype, [0 if v is None else v.data_ptr() for v in operands], dims,
         _strides(x, dt, b, c), dev, PASSES.index(name))


def _dims(x, b, chunk):
    bsz, t, h, p = x.shape
    return bsz, t, h, p, b.shape[2], b.shape[3], chunk


def _chunk_state(x, dt, A, b, *, chunk):
    """Pass 1 → (cum [B, H, nc, Q], dt in cum's layout (0 past a ragged
    end), each chunk's own state [B, nc, H, P, N]), all float32.  dt
    float32."""
    bsz, t, h, p = x.shape
    nc = -(-t // chunk)
    cum = torch.empty((bsz, h, nc, chunk), dtype=torch.float32,
                      device=x.device)
    dtc = torch.empty_like(cum)
    states = torch.empty((bsz, nc, h, p, b.shape[3]), dtype=torch.float32,
                         device=x.device)
    _launch("chunk_state", x.dtype, _dims(x, b, chunk), x=x, dt=dt, A=A, b=b,
            cum=cum, states=states, dtc=dtc)
    return cum, dtc, states


def _cb(b, c, *, chunk):
    """Pass 2 → C Bᵀ [B, nc, G, Q, Q] float32, once per (batch, chunk,
    group); only k <= q is written."""
    bsz, t, g, n = b.shape
    nc = -(-t // chunk)
    cb = torch.empty((bsz, nc, g, chunk, chunk), dtype=torch.float32,
                     device=b.device)
    # the pass reads no x: one head a group and P 1 stand in for its shape
    _launch("cb", b.dtype, (bsz, t, g, 1, g, n, chunk), b=b, c=c, cb=cb)
    return cb


def _state_pass(states, cum, dtype=torch.float32):
    """Pass 3: each chunk's own states [B, nc, H, P, N] (float32) → the
    states entering each chunk, S_prev, same shape in ``dtype`` (the
    carry itself runs in float32)."""
    bsz, nc, h, p, n = states.shape
    chunk = cum.shape[-1]
    prev = torch.empty(states.shape, dtype=dtype, device=states.device)
    # the pass needs only (B, nc, H, P, N, Q); T = nc·Q and G = 1 stand in
    _launch("state_pass", dtype, (bsz, nc * chunk, h, p, 1, n, chunk),
            cum=cum, states=states, prev=prev)
    return prev


def _chunk_scan(x, dtc, c, cb, cum, prev, *, chunk):
    """Pass 4 → y [B, T, H, P] in x's dtype.  ``dtc``: dt in cum's layout
    (pass 1's second output, or ``ref._dt_chunks``); ``prev`` (S_prev) is
    rounded to x's dtype here if it is not in it already, as the state pass
    would have written it."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch("chunk_scan", x.dtype, _dims(x, c, chunk), x=x, c=c, y=y,
            cum=cum, cb=cb, prev=prev.to(x.dtype).contiguous(), dtc=dtc)
    return y


def _on_card(name, x, b, chunk, *others) -> bool:
    """False where every operand lies on the CPU (the plain version's
    place); True on one CUDA device within the kernels' limits; raises
    otherwise."""
    devs = {v.device for v in (x, b) + others}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"{name} operands must lie together on the CPU or "
                         f"on one CUDA device, got {devs}")
    p, n, q = x.shape[3], b.shape[3], min(chunk, x.shape[1])
    if p > MAX_P or n > MAX_N or q > MAX_CHUNK:
        raise ValueError(f"{name}'s kernel takes P <= {MAX_P}, N <= "
                         f"{MAX_N} and chunk <= {MAX_CHUNK}, got P={p}, "
                         f"N={n}, chunk={q}")
    return True


def _last_contiguous(*xs):
    return tuple(a if a.stride(-1) == 1 else a.contiguous() for a in xs)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256
             ) -> torch.Tensor:
    """x: [B, T, H, P]; dt: [B, T, H]; A: [H] float32 (negative); b, c:
    [B, T, G, N] → y [B, T, H, P] in x's dtype.  Chunks of
    ``min(chunk, T)`` steps.  Where autograd needs a gradient the call
    goes through :class:`SSDScan`."""
    _check(x, dt, A, b, c, chunk)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, dt, A, b, c)):
        return SSDScan.apply(x, dt, A, b, c, chunk)
    return _scan(x, dt, A, b, c, chunk)


def _scan(x, dt, A, b, c, chunk):
    """The forward of checked operands: the plain version on the CPU, the
    four passes on the card."""
    if not _on_card("ssd_scan", x, b, chunk, dt, A, c):
        return ref.ssd_scan_ref(x, dt, A, b, c, chunk=chunk)
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, t)
    x, b, c = _last_contiguous(x, b, c)
    dt = dt.float()
    A = A.contiguous()
    # the float32 intermediates (cum, dt by chunk, S_c, C Bᵀ) in one
    # buffer, each part 256-byte aligned; S_prev in x's dtype; then the
    # four passes in one call
    nc = -(-t // q)
    offs = [0]
    for size in (bsz * h * nc * q,) * 2 + (bsz * nc * h * p * n,
                                           bsz * nc * g * q * q):
        offs.append(offs[-1] + -(-size // 64) * 64)
    ws = torch.empty(offs[-1], dtype=torch.float32, device=x.device)
    cum, dtc, states, cb = (ws.data_ptr() + 4 * o for o in offs[:4])
    prev = torch.empty((bsz, nc, h, p, n), dtype=x.dtype, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(x.dtype, [x.data_ptr(), dt.data_ptr(), A.data_ptr(), b.data_ptr(),
                   c.data_ptr(), y.data_ptr(), cum, states, cb,
                   prev.data_ptr(), dtc],
         (bsz, t, h, p, g, n, q), _strides(x, dt, b, c), x.device)
    _LAUNCHES["ssd"] += 1
    return y


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: the forward is the scan, the backward
    :func:`ssd_scan_bwd`.  Saves the inputs (x, b and c as the views they
    came as); the backward recomputes cum, C Bᵀ and S_prev from them."""

    @staticmethod
    def forward(ctx, x, dt, A, b, c, chunk: int):
        ctx.save_for_backward(x, dt, A, b, c)
        ctx.chunk = chunk
        return _scan(x, dt, A, b, c, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, b, c = ctx.saved_tensors
        return ssd_scan_bwd(x, dt, A, b, c, dy, chunk=ctx.chunk) + (None,)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 256):
    """The gradients (dx, ddt, dA, db, dc), each in its operand's dtype, of
    ``ssd_scan(x, dt, A, b, c)`` for the output gradient ``dy`` (x's
    shape).  On CPU tensors the plain backward of ``ref.py``; on CUDA
    tensors the forward's passes 1-3 (the recompute) and the passes of
    ``ssd_bwd.cu``'s route for x's dtype (:func:`_bwd_route`), or an
    error — no fallback."""
    _check(x, dt, A, b, c, chunk)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"ssd_scan_bwd takes dy of x's shape "
                         f"{tuple(x.shape)}, got {tuple(dy.shape)}")
    if not _on_card("ssd_scan_bwd", x, b, chunk, dt, A, c, dy):
        return ref.ssd_scan_bwd_ref(x, dt, A, b, c, dy, chunk=chunk)
    route = _bwd_route(x.dtype)
    out = _bwd_kernels(x, dt, A, b, c, dy, min(chunk, x.shape[1]), route)
    _BWD_LAUNCHES["ssd_bwd"] += 1
    _BWD_ROUTE_COUNTS[route] += 1
    return out


def _bwd_dims(x, b, q):
    """``ssd_bwd_pass_launch``'s dims: (batch, t, h, p, g, n, chunk, state
    slices, group slices)."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    return (bsz, t, h, p, g, n, q, ref.state_slices(p, n),
            ref.group_slices(h, g))


def bwd_workspace(route: str, bsz: int, t: int, h: int, p: int, g: int,
                  n: int, chunk: int) -> Dict[str, Tuple[int, ...]]:
    """The float32 scratch of one backward call on ``route`` (beyond the
    recompute's cum, dt by chunk, S_c — which dS overwrites — C Bᵀ and
    S_prev): {name in BWD_OPERANDS: shape}.  "mma" has no per-head
    [B, H, nc, Q, N] buffer: its dCB tiles ``dcbw`` [B, H, nc, tiles, 64,
    64] (the lower triangle of 64 x 64 tiles), the state slices' partial
    sums ``ptot`` [B, H, nc, S] and the group slices' partial dB and dC
    [S', B, nc, G, Q, N]."""
    q = min(chunk, t)
    nc = -(-t // q)
    shapes = dict(dcum=(bsz, h, nc, q), dtot=(bsz, h, nc),
                  du=(bsz, h, nc, q, p), dapart=(bsz, h, nc))
    if route == "fma":
        shapes.update(dbh=(bsz, h, nc, q, n), dch=(bsz, h, nc, q, n))
    else:
        ntq = -(-q // BWD_TILE)
        gs = ref.group_slices(h, g)
        shapes.update(
            dcbw=(bsz, h, nc, ntq * (ntq + 1) // 2, BWD_TILE, BWD_TILE),
            ptot=(bsz, h, nc, ref.state_slices(p, n)),
            pdb=(gs, bsz, nc, g, q, n), pdc=(gs, bsz, nc, g, q, n))
    return shapes


def _bwd_kernels(x, dt, A, b, c, dy, q, route):
    """The backward of checked operands on the card, q the chunk (at most
    T): the recompute, then ``route``'s passes in one host call."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    x, b, c = _last_contiguous(x, b, c)
    dtf, A = dt.float(), A.contiguous()
    dy = dy.to(x.dtype).contiguous()
    cum, dtc, states = _chunk_state(x, dtf, A, b, chunk=q)
    cb = _cb(b, c, chunk=q)
    prev = _state_pass(states, cum)
    # float32 scratch in one buffer, each part 256-byte aligned; dS takes
    # the place of S_c, which the state pass has read
    shapes = bwd_workspace(route, bsz, t, h, p, g, n, q)
    offs = [0]
    for shape in shapes.values():
        offs.append(offs[-1] + -(-math.prod(shape) // 64) * 64)
    ws = torch.empty(offs[-1], dtype=torch.float32, device=x.device)
    ptrs = {k: ws.data_ptr() + 4 * o for k, o in zip(shapes, offs)}
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((bsz, t, h), dtype=torch.float32, device=x.device)
    da = torch.empty(h, dtype=torch.float32, device=x.device)
    db = torch.empty((bsz, t, g, n), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    ptrs.update(x=x.data_ptr(), a=A.data_ptr(), b=b.data_ptr(),
                c=c.data_ptr(), dy=dy.data_ptr(), cum=cum.data_ptr(),
                dtc=dtc.data_ptr(), prev=prev.data_ptr(), cb=cb.data_ptr(),
                ds=states.data_ptr(), dx=dx.data_ptr(), ddt=ddt.data_ptr(),
                da=da.data_ptr(), db=db.data_ptr(), dc=dc.data_ptr())
    _bwd_run(x.dtype, ptrs, _bwd_dims(x, b, q), _strides(x, None, b, c),
             x.device)
    return (dx, ddt.to(dt.dtype), da.to(A.dtype), db.to(b.dtype),
            dc.to(c.dtype))


def _bwd_run(dtype, ptrs: Dict[str, int], dims, strides, device,
             index=None) -> None:
    """Launch backward pass ``index`` (into ``fma`` then ``mma`` of
    BWD_PASSES) — or, with no index, the passes of dtype's route in order,
    each checked before the next — on the current stream; raises on a
    non-zero CUDA error.  ``ptrs``: {name in BWD_OPERANDS: device
    address}, 0 where absent; ``dims``: :func:`_bwd_dims`."""
    args = ((ctypes.c_void_p * len(BWD_OPERANDS))(
                *(ptrs.get(k, 0) for k in BWD_OPERANDS)),
            (ctypes.c_int * 9)(*dims), (ctypes.c_int64 * 12)(*strides))
    failed = ctypes.c_int(index or 0)
    lib = _bwd_lib()
    if index is None:
        rc = _on(device, lambda st: lib.ssd_bwd_launch(
            _DTYPES[dtype], *args, st, ctypes.byref(failed)))
    else:
        rc = _on(device, lambda st: lib.ssd_bwd_pass_launch(
            index, _DTYPES[dtype], *args, st))
    if rc != 0:
        raise RuntimeError(f"ssd backward {_BWD_PASS_IDS[failed.value]} "
                           f"pass launch failed: CUDA error {rc}")


def _bwd_pass(name: str, dtype: torch.dtype, dims, inputs: Dict, outputs):
    """Check the operands of backward pass ``name`` and launch it alone:
    ``inputs`` are read (each but x, b and c made contiguous), ``outputs``
    ({name: contiguous tensor}) written or updated in place.  ``dims``:
    :func:`_bwd_dims`.  → the outputs, in order."""
    inputs = {k: v if k in ("x", "b", "c") else v.contiguous()
              for k, v in inputs.items()}
    tensors = dict(inputs, **outputs)
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda" or any(v.device != dev for v in tensors.values()):
        raise ValueError(f"the ssd backward {name} pass takes operands on one "
                         f"CUDA device")
    for k, v in tensors.items():
        if k in ("x", "b", "c"):
            if v.stride(-1) != 1 or v.dtype != dtype:
                raise ValueError(f"the ssd backward {name} pass takes x, b, c "
                                 f"in its dtype with a contiguous last axis")
        elif not v.is_contiguous() or v.dtype != (
                dtype if k in ("dy", "dx", "db", "dc") else torch.float32):
            raise ValueError(f"the ssd backward {name} pass takes a "
                             f"contiguous {k} in its kernel dtype")
    _bwd_run(dtype, {k: v.data_ptr() for k, v in tensors.items()}, dims,
             _strides(tensors.get("x"), None, tensors.get("b"),
                      tensors.get("c")), dev, _BWD_PASS_IDS.index(name))
    return tuple(outputs.values())


def _f32(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _copy(v):
    """A contiguous copy of v, for a pass that updates it in place."""
    return torch.empty(v.shape, dtype=v.dtype, device=v.device).copy_(v)


def _fma_dims(bsz, t, h, p, g, n, chunk):
    return (bsz, t, h, p, g, n, chunk, 0, 0)


# ---- route "fma" (float32), each pass alone ---------------------------------

def _bwd_chunk_out(dy, c, cum, prev, *, chunk):
    """Pass 5 alone → (dS_local [B, nc, H, P, N], dC per head [B, H, nc,
    Q, N], dcum [B, H, nc, Q]), as ``ref._bwd_chunk_out_ref``; ``prev``
    float32."""
    bsz, t, h, p = dy.shape
    g, n = c.shape[2], c.shape[3]
    nc = -(-t // chunk)
    return _bwd_pass("chunk_out", dy.dtype, _fma_dims(bsz, t, h, p, g, n,
                                                      chunk),
                     dict(dy=dy, c=c, cum=cum, prev=prev),
                     dict(ds=_f32(prev.shape, dy.device),
                          dch=_f32((bsz, h, nc, chunk, n), dy.device),
                          dcum=_f32(cum.shape, dy.device)))


def _bwd_state(dsl, prev, cum):
    """Pass 6 alone → (dS, dtot [B, H, nc]), as ``ref._bwd_state_ref``
    (``dsl`` is not changed: the pass runs on a copy)."""
    bsz, nc, h, p, n = dsl.shape
    chunk = cum.shape[-1]
    return _bwd_pass("state", torch.float32,
                     _fma_dims(bsz, nc * chunk, h, p, 1, n, chunk),
                     dict(prev=prev, cum=cum),
                     dict(ds=_copy(dsl), dtot=_f32((bsz, h, nc), dsl.device)))


def _bwd_state_side(x, dtc, b, cum, ds, dcum, dtot, *, chunk):
    """Pass 7 alone → (du, dB per head, dcum, dtot), as
    ``ref._bwd_state_side_ref`` (dcum and dtot updated on copies); ``dtc``
    is dt in cum's layout."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-t // chunk)
    return _bwd_pass("state_side", x.dtype, _fma_dims(bsz, t, h, p, g, n,
                                                      chunk),
                     dict(x=x, b=b, cum=cum, dtc=dtc, ds=ds),
                     dict(du=_f32((bsz, h, nc, chunk, p), x.device),
                          dbh=_f32((bsz, h, nc, chunk, n), x.device),
                          dcum=_copy(dcum), dtot=_copy(dtot)))


def _bwd_diag(x, dtc, A, b, c, dy, cb, cum, du, db, dc, dcum, dtot, *,
              chunk):
    """Pass 8 alone → (dx, ddt, dA's shares [B, H, nc], dB and dC per
    head), as ``ref._bwd_diag_ref`` (du, dB and dC updated on copies)."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-t // chunk)
    dx, ddt, dapart, _, dbh, dch = _bwd_pass(
        "diag", x.dtype, _fma_dims(bsz, t, h, p, g, n, chunk),
        dict(x=x, a=A, b=b, c=c, dy=dy, cb=cb, cum=cum, dtc=dtc, dcum=dcum,
             dtot=dtot),
        dict(dx=torch.empty(x.shape, dtype=x.dtype, device=x.device),
             ddt=_f32((bsz, t, h), x.device),
             dapart=_f32((bsz, h, nc), x.device), du=_copy(du),
             dbh=_copy(db), dch=_copy(dc)))
    return dx, ddt, dapart, dbh, dch


def _bwd_reduce(dbh, dch, dapart, g, t, dtype):
    """Pass 9 alone → (dB, dC [B, T, G, N] in ``dtype``, dA [H]), as
    ``ref._bwd_reduce_ref``."""
    bsz, h, nc, chunk, n = dbh.shape
    db = torch.empty((bsz, t, g, n), dtype=dtype, device=dbh.device)
    return _bwd_pass("reduce", dtype, _fma_dims(bsz, t, h, 1, g, n, chunk),
                     dict(dbh=dbh, dch=dch, dapart=dapart),
                     dict(db=db, dc=torch.empty_like(db),
                          da=_f32((h,), dbh.device)))


# ---- route "mma" (bfloat16), each pass alone --------------------------------

def _tiles(dcb):
    """dCB [B, H, nc, Q, Q] → the workspace's lower-triangle 64 x 64 tiles
    [B, H, nc, tiles, 64, 64] (zero past Q)."""
    bsz, h, nc, q, _ = dcb.shape
    ntq = -(-q // BWD_TILE)
    full = torch.zeros((bsz, h, nc, ntq * BWD_TILE, ntq * BWD_TILE),
                       dtype=torch.float32, device=dcb.device)
    full[..., :q, :q] = dcb
    full = full.reshape(bsz, h, nc, ntq, BWD_TILE, ntq, BWD_TILE)
    return torch.stack([full[:, :, :, qt, :, kt] for qt in range(ntq)
                        for kt in range(qt + 1)], dim=3).contiguous()


def _untiles(tiles, q):
    """The inverse of :func:`_tiles`: tiles → dCB [B, H, nc, Q, Q], zero
    above the diagonal tiles."""
    bsz, h, nc = tiles.shape[:3]
    ntq = -(-q // BWD_TILE)
    full = torch.zeros((bsz, h, nc, ntq, BWD_TILE, ntq, BWD_TILE),
                       dtype=tiles.dtype, device=tiles.device)
    i = 0
    for qt in range(ntq):
        for kt in range(qt + 1):
            full[:, :, :, qt, :, kt] = tiles[:, :, :, i]
            i += 1
    return full.reshape(bsz, h, nc, ntq * BWD_TILE,
                        ntq * BWD_TILE)[..., :q, :q]


def _bwd_chunk_out_mma(dy, c, cum, prev, *, chunk):
    """Pass 5 of "mma" alone → (dS_local [B, nc, H, P, N], dcum [B, H, nc,
    Q]), as ``ref._bwd_chunk_out_mma_ref``; ``prev`` float32."""
    bsz, t, h, p = dy.shape
    return _bwd_pass("chunk_out_mma", dy.dtype, _bwd_dims(dy, c, chunk),
                     dict(dy=dy, c=c, cum=cum, prev=prev),
                     dict(ds=_f32(prev.shape, dy.device),
                          dcum=_f32(cum.shape, dy.device)))


def _bwd_state_slices(dsl, prev, cum):
    """Pass 6 of "mma" alone → (dS, partial sums [B, H, nc, S]), as
    ``ref._bwd_state_slices_ref`` (``dsl`` is not changed)."""
    bsz, nc, h, p, n = dsl.shape
    chunk = cum.shape[-1]
    dims = (bsz, nc * chunk, h, p, 1, n, chunk, ref.state_slices(p, n), 1)
    return _bwd_pass("state_slices", torch.bfloat16, dims,
                     dict(prev=prev, cum=cum),
                     dict(ds=_copy(dsl),
                          ptot=_f32((bsz, h, nc, ref.state_slices(p, n)),
                                    dsl.device)))


def _bwd_state_side_mma(x, dtc, b, cum, ds, dcum, part, *, chunk):
    """Pass 7 of "mma" alone → (du, dcum, dtot), as
    ``ref._bwd_state_side_mma_ref`` (dcum updated on a copy); ``dtc`` is
    dt in cum's layout, ``part`` the state slices' partial sums."""
    bsz, t, h, p = x.shape
    nc = -(-t // chunk)
    return _bwd_pass("state_side_mma", x.dtype, _bwd_dims(x, b, chunk),
                     dict(x=x, b=b, cum=cum, dtc=dtc, ds=ds, ptot=part),
                     dict(du=_f32((bsz, h, nc, chunk, p), x.device),
                          dcum=_copy(dcum),
                          dtot=_f32((bsz, h, nc), x.device)))


def _bwd_diag_mma(x, dtc, A, b, dy, cb, cum, du, dcum, dtot, *, chunk):
    """Pass 8 of "mma" alone → (dx, ddt, dA's shares [B, H, nc], dCB
    [B, H, nc, Q, Q]), as ``ref._bwd_diag_mma_ref`` (``b`` only gives the
    groups)."""
    bsz, t, h, p = x.shape
    nc = -(-t // chunk)
    ws = torch.zeros(bwd_workspace("mma", bsz, t, h, p, b.shape[2],
                                   b.shape[3], chunk)["dcbw"],
                     dtype=torch.float32, device=x.device)
    dx, ddt, dapart, tiles = _bwd_pass(
        "diag_mma", x.dtype, _bwd_dims(x, b, chunk),
        dict(x=x, a=A, dy=dy, cb=cb, cum=cum, dtc=dtc, du=du, dcum=dcum,
             dtot=dtot),
        dict(dx=torch.empty(x.shape, dtype=x.dtype, device=x.device),
             ddt=_f32((bsz, t, h), x.device),
             dapart=_f32((bsz, h, nc), x.device), dcbw=ws))
    return dx, ddt, dapart, _untiles(tiles, chunk)


def _bwd_group(x, dtc, b, c, dy, cum, prev, ds, dcb, *, chunk):
    """Pass 9 of "mma" alone → (partial dB, partial dC), each [S, B, nc,
    G, Q, N], as ``ref._bwd_group_ref``; ``dcb`` [B, H, nc, Q, Q]."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    shape = bwd_workspace("mma", bsz, t, h, p, g, n, chunk)["pdb"]
    return _bwd_pass("group", x.dtype, _bwd_dims(x, b, chunk),
                     dict(x=x, b=b, c=c, dy=dy, cum=cum, dtc=dtc, prev=prev,
                          ds=ds, dcbw=_tiles(dcb)),
                     dict(pdb=_f32(shape, x.device),
                          pdc=_f32(shape, x.device)))


def _bwd_reduce_slices(pdb, pdc, dapart, t, dtype):
    """Pass 10 of "mma" alone → (dB, dC [B, T, G, N] in ``dtype``, dA
    [H]), as ``ref._bwd_reduce_slices_ref``."""
    gs, bsz, nc, g, chunk, n = pdb.shape
    h = dapart.shape[1]
    db = torch.empty((bsz, t, g, n), dtype=dtype, device=pdb.device)
    dims = (bsz, t, h, 1, g, n, chunk, ref.state_slices(1, n), gs)
    return _bwd_pass("reduce_slices", dtype, dims,
                     dict(pdb=pdb, pdc=pdc, dapart=dapart),
                     dict(db=db, dc=torch.empty_like(db),
                          da=_f32((h,), pdb.device)))
