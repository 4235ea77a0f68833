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
launches the five passes of ``src/repro_torch/csrc/ssd_bwd.cu`` (chunk
out, state, state side, diag, reduce), each callable alone (``_bwd_*``)
to be held against its plain counterpart in ``ref.py``; on CPU tensors it
runs ``ref.ssd_scan_bwd_ref``.  ``backward_launch_counts()["ssd_bwd"]``
rises by one per backward call on the card.
"""

from __future__ import annotations

import ctypes
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
#: The backward's passes, in launch order (``ssd_bwd_pass_launch``'s first
#: argument).
BWD_PASSES = ("chunk_out", "state", "state_side", "diag", "reduce")
#: The pointers ``ssd_bwd_pass_launch`` takes, in order.
BWD_OPERANDS = ("x", "dt", "a", "b", "c", "dy", "cum", "dtc", "prev", "cb",
                "ds", "dcum", "dtot", "du", "dbh", "dch", "dapart", "dx",
                "ddt", "da", "db", "dc")

_LIB = None
_BWD_LIB = None
_LAUNCHES: Dict[str, int] = {"ssd": 0}
_BWD_LAUNCHES: Dict[str, int] = {"ssd_bwd": 0}


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
            "ssd_bwd_resources": [i32, i32, p]})
    return _BWD_LIB


def bwd_resources(name: str, dtype: torch.dtype) -> Dict[str, int]:
    """Backward pass ``name``'s dynamic shared memory a block (bytes), the
    blocks one SM of the current card holds at once, and its registers and
    local (spill) bytes a thread."""
    out = (ctypes.c_int * 4)()
    rc = _bwd_lib().ssd_bwd_resources(BWD_PASSES.index(name), _DTYPES[dtype],
                                      out)
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


def _run(dtype, ptrs, dims, strides, device, index=None) -> None:
    """Launch pass ``PASSES[index]`` — or, with no index, the four passes
    in order, each checked before the next — on the current stream; raises
    on a non-zero CUDA error.  ``ptrs``: the 11 device addresses of
    ``ssd_pass_launch``; ``dims``: (batch, t, h, p, g, n, chunk)."""
    args = ((ctypes.c_void_p * 11)(*ptrs), (ctypes.c_int * 7)(*dims),
            (ctypes.c_int64 * 12)(*strides))
    failed = ctypes.c_int(index or 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if index is None:
            rc = _lib().ssd_scan_launch(_DTYPES[dtype], *args, stream,
                                        ctypes.byref(failed))
        else:
            rc = _lib().ssd_pass_launch(index, _DTYPES[dtype], *args, stream)
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
    tensors the forward's passes 1-3 (the recompute) and the five passes of
    ``ssd_bwd.cu``, or an error — no fallback."""
    _check(x, dt, A, b, c, chunk)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"ssd_scan_bwd takes dy of x's shape "
                         f"{tuple(x.shape)}, got {tuple(dy.shape)}")
    if not _on_card("ssd_scan_bwd", x, b, chunk, dt, A, c, dy):
        return ref.ssd_scan_bwd_ref(x, dt, A, b, c, dy, chunk=chunk)
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, t)
    nc = -(-t // q)
    x, b, c = _last_contiguous(x, b, c)
    dtf, A = dt.float(), A.contiguous()
    dy = dy.to(x.dtype).contiguous()
    cum, dtc, states = _chunk_state(x, dtf, A, b, chunk=q)
    cb = _cb(b, c, chunk=q)
    prev = _state_pass(states, cum)
    # float32 scratch in one buffer, each part 256-byte aligned; dS takes
    # the place of S_c, which the state pass has read
    sizes = (bsz * h * nc * q, bsz * h * nc, bsz * h * nc * q * p,
             bsz * h * nc * q * n, bsz * h * nc * q * n, bsz * h * nc)
    offs = [0]
    for size in sizes:
        offs.append(offs[-1] + -(-size // 64) * 64)
    ws = torch.empty(offs[-1], dtype=torch.float32, device=x.device)
    dcum, dtot, du, dbh, dch, dapart = (ws.data_ptr() + 4 * o
                                        for o in offs[:-1])
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((bsz, t, h), dtype=torch.float32, device=x.device)
    da = torch.empty(h, dtype=torch.float32, device=x.device)
    db = torch.empty((bsz, t, g, n), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    ptrs = dict(x=x.data_ptr(), a=A.data_ptr(), b=b.data_ptr(),
                c=c.data_ptr(), dy=dy.data_ptr(), cum=cum.data_ptr(),
                dtc=dtc.data_ptr(), prev=prev.data_ptr(), cb=cb.data_ptr(),
                ds=states.data_ptr(), dcum=dcum, dtot=dtot, du=du, dbh=dbh,
                dch=dch, dapart=dapart, dx=dx.data_ptr(),
                ddt=ddt.data_ptr(), da=da.data_ptr(), db=db.data_ptr(),
                dc=dc.data_ptr())
    _bwd_run(x.dtype, ptrs, (bsz, t, h, p, g, n, q), _strides(x, None, b, c),
             x.device)
    _BWD_LAUNCHES["ssd_bwd"] += 1
    return (dx, ddt.to(dt.dtype), da.to(A.dtype), db.to(b.dtype),
            dc.to(c.dtype))


def _bwd_run(dtype, ptrs: Dict[str, int], dims, strides, device,
             index=None) -> None:
    """Launch backward pass ``BWD_PASSES[index]`` — or, with no index, the
    five in order, each checked before the next — on the current stream;
    raises on a non-zero CUDA error.  ``ptrs``: {name in BWD_OPERANDS:
    device address}, 0 where absent; ``dims``: (batch, t, h, p, g, n,
    chunk)."""
    args = ((ctypes.c_void_p * len(BWD_OPERANDS))(
                *(ptrs.get(k, 0) for k in BWD_OPERANDS)),
            (ctypes.c_int * 7)(*dims), (ctypes.c_int64 * 12)(*strides))
    failed = ctypes.c_int(index or 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if index is None:
            rc = _bwd_lib().ssd_bwd_launch(_DTYPES[dtype], *args, stream,
                                           ctypes.byref(failed))
        else:
            rc = _bwd_lib().ssd_bwd_pass_launch(index, _DTYPES[dtype], *args,
                                                stream)
    if rc != 0:
        raise RuntimeError(f"ssd backward {BWD_PASSES[failed.value]} pass "
                           f"launch failed: CUDA error {rc}")


def _bwd_pass(name: str, dtype: torch.dtype, dims, inputs: Dict, outputs):
    """Check the operands of backward pass ``name`` and launch it alone:
    ``inputs`` are read (each but x, b and c made contiguous), ``outputs``
    ({name: contiguous tensor}) written or updated in place.  → the
    outputs, in order."""
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
                      tensors.get("c")), dev, BWD_PASSES.index(name))
    return tuple(outputs.values())


def _f32(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _copy(v):
    """A contiguous copy of v, for a pass that updates it in place."""
    return torch.empty(v.shape, dtype=v.dtype, device=v.device).copy_(v)


def _bwd_chunk_out(dy, c, cum, prev, *, chunk):
    """Pass 5 alone → (dS_local [B, nc, H, P, N], dC per head [B, H, nc,
    Q, N], dcum [B, H, nc, Q]), as ``ref._bwd_chunk_out_ref``; ``prev``
    float32."""
    bsz, t, h, p = dy.shape
    g, n = c.shape[2], c.shape[3]
    nc = -(-t // chunk)
    return _bwd_pass("chunk_out", dy.dtype, (bsz, t, h, p, g, n, chunk),
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
                     (bsz, nc * chunk, h, p, 1, n, chunk),
                     dict(prev=prev, cum=cum),
                     dict(ds=_copy(dsl), dtot=_f32((bsz, h, nc), dsl.device)))


def _bwd_state_side(x, dtc, b, cum, ds, dcum, dtot, *, chunk):
    """Pass 7 alone → (du, dB per head, dcum, dtot), as
    ``ref._bwd_state_side_ref`` (dcum and dtot updated on copies); ``dtc``
    is dt in cum's layout."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-t // chunk)
    return _bwd_pass("state_side", x.dtype, (bsz, t, h, p, g, n, chunk),
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
        "diag", x.dtype, (bsz, t, h, p, g, n, chunk),
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
    return _bwd_pass("reduce", dtype, (bsz, t, h, 1, g, n, chunk),
                     dict(dbh=dbh, dch=dch, dapart=dapart),
                     dict(db=db, dc=torch.empty_like(db),
                          da=_f32((h,), dbh.device)))
