"""Wrapper of the CUDA flash-attention kernels: check, route, launch.

``flash_attention(q, k, v)`` takes the model's grouped-query layout —
q [B, T, H, D], k and v [B, S, KV, D] with KV dividing H — and returns
[B, T, H, D] in q's dtype.  Unlike the JAX package's wrapper it pads
nothing and repeats no kv head: the kernels mask the ragged tails and
map each query head to its kv head themselves, and k and v may be
strided views (a prefix of the KV cache).  On CPU tensors it runs the
plain version in ``ref.py``; on CUDA tensors it launches a kernel of
``src/repro_torch/csrc/flash_attention.cu`` or raises — no fallback.

Three routes, a pure function of (dtype, T, D) (:func:`_route`): below
``MMA_MIN_ROWS`` query rows (decode, short steps) ``"split"``, float32
or bf16: the keys split over blocks, the splits a pure function of the
shape (:func:`_splits`), combined in index order within the same launch;
bf16 from ``MMA_MIN_ROWS`` rows (prefill) ``"mma"``, the kernel on the
tensor cores; float32 from there ``"fma"``, the kernel on the CUDA
cores.  A failed build or launch raises; no route stands in for
another.  ``launch_counts()`` rises by one a call, whichever route;
``route_counts()`` counts the same calls by route.

The host path of a call is kept short: every size, stride, flag and
address goes to the C launcher as one packed argument (``_LAUNCH``,
the source's ``struct Launch``), the current stream is read as a raw
handle, and the device is switched only when q's is not current.

Gradients.  Where autograd needs one (grad mode on and q, k or v
requiring a gradient) the call goes through :class:`FlashAttention`, an
``autograd.Function``: its forward takes the route that also writes the
per-row log-sum-exp (``"mma"`` for bf16 at a head dim of ``HEAD_DIMS``,
else ``"fma"``, at any T; never ``"split"``), and its backward is
:func:`flash_attention_bwd`, the kernels of
``src/repro_torch/csrc/flash_attention_bwd.cu`` on the card and the
plain backward of ``ref.py`` on the CPU.  The backward has two routes, a
pure function of (dtype, D) (:func:`_bwd_route`): bf16 ``"mma"``, every
product on the tensor cores (four device launches: Delta, dK/dV
partials per query head, their reduce over the heads of each kv head,
dQ); float32 ``"fma"``, the CUDA-core kernels (three: Delta, dK/dV, dQ).
Either is one host call.  A gradient is served for self-attention only
(T == S, q_offset 0: the training path); any other shape raises.  Under
``torch.utils.checkpoint`` the recomputed forward takes the same route
and gives the same bits.  ``backward_launch_counts()`` counts the
backward calls that launched the kernels, ``backward_route_counts()``
the same calls by route.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

SOURCE = _build.CSRC / "flash_attention.cu"
NVCC_FLAGS: Tuple[str, ...] = ()

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SCALE = {d: 1.0 / math.sqrt(d) for d in HEAD_DIMS}

#: Query rows from which bf16 attention takes the tensor-core kernel: one
#: warp's 16-row tile of ``mma.sync``.  Below it every call takes "split".
MMA_MIN_ROWS = 16
ROUTES = ("fma", "mma", "split")
_ROUTE_IDS = {r: i for i, r in enumerate(ROUTES)}

#: Keys a split of the split route, in multiples of which :func:`_splits`
#: cuts the keys (16, 32 and 64 tied in probe runs on the card: PERF.md).
KEYS_PER_SPLIT = 32
#: Blocks past which the split route stops adding splits (long caches).
SPLIT_BLOCKS = 512
#: Query rows of one split-route block, and the most splits: the source's
#: kSplitRows and kMaxSplits (checked when the library loads).
SPLIT_ROWS = 8
MAX_SPLITS = 16

#: The C launcher's one argument: 16 int64 (addresses, the stream, strides),
#: 13 int32 (route, dtype, sizes, flags, splits, keys a split), the scale,
#: the address of the log-sum-exp output (0: not written).
_LAUNCH = struct.Struct("<16q13ifq")

BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
#: The backward launcher's one argument: 13 int64 (addresses of q, k, v, o,
#: dO, lse, the Delta workspace, dq, dk, dv, the mma route's dK and dV
#: partials; the stream), 11 int32 (route, dtype, sizes, flags), the scale.
_BWD_LAUNCH = struct.Struct("<13q11if")
BWD_ROUTES = ("fma", "mma")
_BWD_ROUTE_IDS = {r: i for i, r in enumerate(BWD_ROUTES)}
#: Keys a dK/dV block and query rows a dQ block of each backward route.
BWD_KEYS = {"fma": 32, "mma": 64}
BWD_ROWS = {"fma": 32, "mma": 64}
#: The mma route's query rows a dK/dV step (= keys a dQ step) by head dim:
#: 32 at D 128, so the dK and dV accumulators fit in registers.
BWD_STEP = {64: 64, 128: 32}
#: Threads a block of the mma route's reduce, 4 columns a thread.
BWD_REDUCE_THREADS = 256
#: Device kernels of each backward route, in launch order.
BWD_KERNELS = {"fma": ("delta", "dkdv", "dq"),
               "mma": ("delta", "dkdv", "reduce", "dq")}

_LIB = None
_BWD_LIB = None
_LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_BWD_LAUNCHES: Dict[str, int] = {"flash_attention_bwd": 0}
_ROUTES: Dict[str, int] = dict.fromkeys(ROUTES, 0)
_BWD_ROUTES: Dict[str, int] = dict.fromkeys(BWD_ROUTES, 0)
# the split route's ticket counters by (device index, stream): (tensor,
# address); each call leaves them at 0
_TICKETS: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_counts() -> Dict[str, int]:
    """Kernel calls since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0


def backward_launch_counts() -> Dict[str, int]:
    """Backward calls that launched the kernels since the last
    :func:`reset_backward_launch_counts` (one a call, whichever route)."""
    return dict(_BWD_LAUNCHES)


def reset_backward_launch_counts() -> None:
    _BWD_LAUNCHES["flash_attention_bwd"] = 0


def backward_route_counts() -> Dict[str, int]:
    """Backward kernel calls by route since the last
    :func:`reset_backward_route_counts` (CPU tensors count on none)."""
    return dict(_BWD_ROUTES)


def reset_backward_route_counts() -> None:
    for r in BWD_ROUTES:
        _BWD_ROUTES[r] = 0


def route_counts() -> Dict[str, int]:
    """Kernel calls by route since the last :func:`reset_route_counts`
    (one route a call; CPU tensors count on none)."""
    return dict(_ROUTES)


def reset_route_counts() -> None:
    for r in ROUTES:
        _ROUTES[r] = 0


def _route(dtype: torch.dtype, t: int, d: int) -> str:
    """The kernel that serves q of ``dtype`` with ``t`` rows of head dim
    ``d``: ``"split"`` (below ``MMA_MIN_ROWS`` rows), ``"mma"`` (bf16,
    tensor cores) or ``"fma"`` (float32, CUDA cores)."""
    if t < MMA_MIN_ROWS:
        return "split"
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        return "mma"
    return "fma"


def _grad_route(dtype: torch.dtype, d: int) -> str:
    """The route of a forward whose gradient is needed: one that writes the
    log-sum-exp at any T (``"mma"`` for bf16, ``"fma"`` otherwise)."""
    return "mma" if dtype == torch.bfloat16 and d in HEAD_DIMS else "fma"


def _bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels for q of ``dtype`` at head dim ``d``, by the
    forward's rule (:func:`_grad_route`): ``"mma"`` (bf16, tensor cores)
    or ``"fma"`` (float32, CUDA cores: its 2e-5 tolerance cannot be met
    with bf16 products)."""
    return _grad_route(dtype, d)


def bwd_plan(route: str, b: int, t: int, s: int, h: int, kv: int,
             d: int) -> Dict[str, object]:
    """The device launches of one backward call, as the source computes
    them: ``grids`` {kernel: grid (x, y, z)} in launch order (Delta a warp
    a row, 4 a block; fma: dK/dV (key tiles, KV, B), dQ (row tiles, H, B);
    mma: dK/dV (B H, key tiles), the reduce's blocks, dQ (B H, row
    tiles)), ``keys`` and ``rows`` a dK/dV and a dQ block, ``step`` (mma:
    rows a dK/dV step, keys a dQ step) and ``workspace``, the shape of
    each of the mma route's fp32 dK and dV partials (None on fma)."""
    keys, rows = BWD_KEYS[route], BWD_ROWS[route]
    key_tiles, row_tiles = -(-s // keys), -(-t // rows)
    grids = {"delta": (-(-(b * t * h) // 4), 1, 1)}
    if route == "fma":
        grids["dkdv"] = (key_tiles, kv, b)
        grids["dq"] = (row_tiles, h, b)
        return dict(grids=grids, keys=keys, rows=rows, step=None,
                    workspace=None)
    grids["dkdv"] = (b * h, key_tiles, 1)
    grids["reduce"] = (-(-(b * s * kv * d // 4) // BWD_REDUCE_THREADS), 1, 1)
    grids["dq"] = (b * h, row_tiles, 1)
    return dict(grids=grids, keys=keys, rows=rows, step=BWD_STEP[d],
                workspace=(b, s, h, d))


def _splits(s: int, b: int, kv: int, rows: int) -> Tuple[int, int]:
    """(splits, keys a split) of the split route for S keys, batch B, KV
    kv heads and ``rows`` = T·H/KV query rows a kv head: the keys cut into
    multiples of ``KEYS_PER_SPLIT``, as many splits as there are such
    pieces up to ``MAX_SPLITS`` and ``SPLIT_BLOCKS`` blocks in all.  Split
    i takes keys [i·per, min((i + 1)·per, S)); none is empty."""
    units = b * kv * -(-rows // SPLIT_ROWS)
    pieces = -(-s // KEYS_PER_SPLIT)
    n = max(1, min(pieces, MAX_SPLITS, SPLIT_BLOCKS // units))
    per = -(-pieces // n) * KEYS_PER_SPLIT
    return -(-s // per), per


def _lib():
    global _LIB
    if _LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib = _build.load(SOURCE, NVCC_FLAGS, {
            "flash_attention_launch": [ctypes.c_char_p],
            "flash_attention_constants": [p],
            "flash_attention_mma_resources": [i32, p],
            "flash_attention_split_resources": [i32, i32, p]})
        out = (ctypes.c_int * 3)()
        lib.flash_attention_constants(out)
        if tuple(out) != (_LAUNCH.size, SPLIT_ROWS, MAX_SPLITS):
            raise RuntimeError(
                f"flash_attention.cu's Launch size, rows a split block and "
                f"most splits {tuple(out)} do not match the wrapper's "
                f"{(_LAUNCH.size, SPLIT_ROWS, MAX_SPLITS)}")
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib = _build.load(BWD_SOURCE, NVCC_FLAGS, {
            "flash_attention_bwd_launch": [ctypes.c_char_p],
            "flash_attention_bwd_constants": [p],
            "flash_attention_bwd_resources": [i32, i32, p]})
        out = (ctypes.c_int * 8)()
        lib.flash_attention_bwd_constants(out)
        want = (_BWD_LAUNCH.size, BWD_KEYS["fma"], BWD_ROWS["fma"],
                BWD_KEYS["mma"], BWD_ROWS["mma"], BWD_STEP[64],
                BWD_STEP[128], BWD_REDUCE_THREADS)
        if tuple(out) != want:
            raise RuntimeError(
                f"flash_attention_bwd.cu's BwdLaunch size, keys a dK/dV block "
                f"and rows a dQ block (fma, mma), the mma steps (D 64, 128) "
                f"and reduce threads {tuple(out)} do not match the "
                f"wrapper's {want}")
        _BWD_LIB = lib
    return _BWD_LIB


def bwd_resources(dtype: torch.dtype, d: int
                  ) -> Dict[str, Dict[str, int]]:
    """{kernel: {"shared": dynamic shared memory of a block in bytes,
    "registers": a thread, "spill_bytes": local memory a thread
    (``cudaFuncAttributes.localSizeBytes``)}} of each device kernel of the
    backward route that serves ``dtype`` at head dim ``d``, in launch
    order."""
    route = _bwd_route(dtype, d)
    names = BWD_KERNELS[route]
    out = (ctypes.c_int * (3 * len(names)))()
    rc = _bwd_lib().flash_attention_bwd_resources(_BWD_ROUTE_IDS[route], d,
                                                  out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd resources: CUDA error {rc}")
    return {n: dict(shared=out[3 * i], registers=out[3 * i + 1],
                    spill_bytes=out[3 * i + 2])
            for i, n in enumerate(names)}


def mma_resources(d: int) -> Tuple[int, int]:
    """(dynamic shared memory of one block in bytes, blocks that one SM of
    the current card holds at once) of the mma route's kernel at head dim
    ``d``."""
    out = (ctypes.c_int * 2)()
    rc = _lib().flash_attention_mma_resources(d, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention mma resources: CUDA error {rc}")
    return out[0], out[1]


def split_resources(dtype: torch.dtype, d: int) -> Tuple[int, int, int]:
    """(static shared memory of one block in bytes, registers a thread,
    blocks that one SM of the current card holds at once) of the split
    route's kernel for ``dtype`` at head dim ``d``."""
    out = (ctypes.c_int * 3)()
    rc = _lib().flash_attention_split_resources(_DTYPES[dtype], d, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention split resources: CUDA error {rc}")
    return out[0], out[1], out[2]


def _operand(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...], int]:
    """x with a contiguous last axis and 16-byte aligned rows, as the
    kernels' vector loads need (copied only where it has neither) → (x,
    its strides, its address)."""
    st, ptr = x.stride(), x.data_ptr()
    vec = 16 // x.element_size()
    if st[3] != 1 or ptr % 16 or st[0] % vec or st[1] % vec or st[2] % vec:
        x = x.contiguous() if not x.is_contiguous() else x.clone()
        st, ptr = x.stride(), x.data_ptr()
    return x, st, ptr


def _tickets(dev: torch.device, stream: int, n: int) -> int:
    """Address of at least ``n`` ticket counters of the split route for
    (``dev``, ``stream``), all 0: the kernel's combining block sets each
    back to 0, and calls on one stream run in turn."""
    held = _TICKETS.get((dev.index, stream))
    if held is None or held[0].numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        held = _TICKETS[(dev.index, stream)] = (buf, buf.data_ptr())
    return held[1]


def _check(q, k, v, window) -> None:
    """Device, shape, head-dim and dtype checks of a CUDA call."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention operands must lie together on "
                         f"the CPU or on one CUDA device, got "
                         f"{ {q.device, k.device, v.device} }")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, T, H, D] and k, v "
                         f"[B, S, KV, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    kvh = k.shape[2]
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


def _stream(dev: torch.device) -> int:
    return (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
            else torch.cuda.current_stream(dev).cuda_stream)


def _launch(q, k, v, causal: bool, window: int, q_offset: int, route: str,
            with_lse: bool):
    """One forward launch on CUDA operands already checked → (out, the
    log-sum-exp [B, H, T] float32 where ``with_lse``, else None)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lib = _lib()
    q, qs, qp = _operand(q)
    k, ks, kp = _operand(k)
    v, vs, vp = _operand(v)
    out = q.new_empty((b, t, h, d))
    lse = q.new_empty((b, h, t), dtype=torch.float32) if with_lse else None
    dev = q.device
    stream = _stream(dev)
    splits, kps, ws, tickets = 1, 0, 0, 0
    if route == "split":
        rows = t * (h // kvh)
        splits, kps = _splits(s, b, kvh, rows)
        if splits > 1:
            units = b * kvh * -(-rows // SPLIT_ROWS)
            work = q.new_empty(units * splits * SPLIT_ROWS * (d + 2),
                               dtype=torch.float32)
            ws = work.data_ptr()
            tickets = _tickets(dev, stream, units)
    packed = _LAUNCH.pack(
        qp, kp, vp, out.data_ptr(), ws, tickets, stream, qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], _ROUTE_IDS[route],
        _DTYPES[q.dtype], b, t, s, h, kvh, d, causal, window, q_offset,
        splits, kps, _SCALE[d], 0 if lse is None else lse.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = lib.flash_attention_launch(packed)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_attention_launch(packed)
    if rc != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {rc}")
    _LAUNCHES["flash_attention"] += 1
    _ROUTES[route] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, T, H, D]; k, v: [B, S, KV, D] → [B, T, H, D].

    Query row t sits at position ``q_offset + t``: ``causal`` lets it see
    keys up to that position, ``window`` > 0 only the last ``window`` of
    them.  Every key of k is valid otherwise (pass a prefix view of a
    cache to mask its unwritten tail).  Where autograd needs a gradient
    the call goes through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    if (q.device.type == "cpu" and k.device.type == "cpu"
            and v.device.type == "cpu"):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    _check(q, k, v, window)
    return _launch(q, k, v, causal, window, q_offset,
                   _route(q.dtype, q.shape[1], q.shape[3]), False)[0]


def _check_grad_shape(q, k, q_offset: int) -> None:
    if q.shape[1] != k.shape[1] or q_offset != 0:
        raise NotImplementedError(
            f"flash_attention serves a gradient for self-attention only (T "
            f"== S keys, q_offset 0), got T={q.shape[1]}, S={k.shape[1]}, "
            f"q_offset={q_offset}: no kernel computes the gradient of a "
            f"step against a cache (the split route serves no gradient)")


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward saves O and the per-row
    log-sum-exp, the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        _check_grad_shape(q, k, q_offset)
        if q.device.type == "cpu" and k.device.type == "cpu" \
                and v.device.type == "cpu":
            out, lse = ref.attention_fwd_ref(q, k, v, causal=causal,
                                             window=window, q_offset=q_offset)
        else:
            _check(q, k, v, window)
            out, lse = _launch(q, k, v, causal, window, q_offset,
                               _grad_route(q.dtype, q.shape[3]), True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start (copied only where not)."""
    if not x.is_contiguous():
        return x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """The gradients (dq, dk, dv) of attention for ``dout`` [B, T, H, D],
    from the forward's operands, its output and its log-sum-exp ``lse``
    [B, H, T] float32.  On CPU tensors the plain backward of ``ref.py``;
    on CUDA tensors the kernels of ``flash_attention_bwd.cu`` on the
    route of :func:`_bwd_route`, or an error — no fallback."""
    ops = (q, k, v, out, lse, dout)
    if all(x.device.type == "cpu" for x in ops):
        return ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                     window=window, q_offset=q_offset)
    _check(q, k, v, window)
    _check_grad_shape(q, k, q_offset)
    dev = q.device
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if any(x.device != dev for x in ops):
        raise ValueError("flash_attention_bwd operands must lie on one device")
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd takes out and dout like q "
                         f"{tuple(q.shape)} {q.dtype} and lse [B, H, T] "
                         f"float32, got {tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} {lse.dtype}")
    lib = _bwd_lib()
    route = _bwd_route(q.dtype, d)
    q, k, v, out, dout = (_aligned(x) for x in (q, k, v, out, dout.to(q.dtype)))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    work = bwd_plan(route, b, t, s, h, kvh, d)["workspace"]
    wk = wv = None
    if work is not None:   # each query head's dK and dV partials, fp32
        wk, wv = (torch.empty(work, dtype=torch.float32, device=dev)
                  for _ in range(2))
    packed = _BWD_LAUNCH.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), 0 if wk is None else wk.data_ptr(),
        0 if wv is None else wv.data_ptr(), _stream(dev),
        _BWD_ROUTE_IDS[route], _DTYPES[q.dtype], b, t, s, h, kvh, d, causal,
        window, q_offset, _SCALE[d])
    if dev.index == torch.cuda.current_device():
        rc = lib.flash_attention_bwd_launch(packed)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_attention_bwd_launch(packed)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward {route} kernel launch "
                           f"failed: CUDA error {rc}")
    _BWD_LAUNCHES["flash_attention_bwd"] += 1
    _BWD_ROUTES[route] += 1
    return dq, dk, dv
