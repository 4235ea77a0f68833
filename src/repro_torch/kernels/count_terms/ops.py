"""Wrappers of the CUDA count-terms kernels: build, load, check, launch.

``count_term_sums(segments, cfg_m, cfg_u, lay, inv_m)`` takes what
``energymodel._term_sums_body`` takes — the per-network ``segments``, the
[n_m, 1] mapping-unique and [n_u, 1] count-unique config columns, the
[1, L] stacked layer columns and the count → mapping row index ``inv_m``
[n_u], non-decreasing as ``energymodel._prepare_fields`` makes it — and
returns its 14-tuple of [n_u, n_net] sums.
``count_term_layers(cfg_u, lay)`` returns the [n_u, L] terms per layer.
On CPU tensors they run the plain versions in ``ref.py``; on CUDA tensors
they launch the kernel or raise — no fallback.

The host path of ``count_term_sums`` is one packed argument (``_LAUNCH``,
the source's ``struct Launch``, checked at load) holding the columns'
addresses, so nothing is stacked, and the segments, so no table is copied
to the card; each block finds its mapping row's count rows by a search of
``inv_m``, so nothing is sorted or synchronised before the launch.

The kernels (``src/repro_torch/csrc/count_terms.cu``) are compiled with
``nvcc`` at first use into a shared library with a plain C interface,
loaded with ``ctypes`` (:mod:`repro_torch.kernels._build`).

``launch_counts()`` counts the launches of each kernel: it rises only where
a kernel is launched, never on the plain path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import struct
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from ...core.energymodel import _COUNT_COLUMNS as CFG_COLUMNS
from ...core.energymodel import _MAPPING_COLUMNS as MAP_COLUMNS
from .. import _build
from . import ref

#: Row order of the stacked layer operand (``rs_mapping.layer_struct`` keys).
LAYER_FIELDS = ("c_ch", "m", "ky", "kx", "stride", "ix", "iy", "oy", "ox",
                "macs", "weight_words", "ifmap_words", "ofmap_words",
                "is_acc", "is_dw", "is_pool")

#: Number of count terms (see ``energymodel._count_terms``).
N_TERMS = 14

#: Networks (segments) one ``count_terms`` launch takes; more take more
#: launches.
MAX_NETS = 256

#: ``count_terms``' launch argument: the addresses of the 6 cfg_m and 16
#: layer columns, of gb_psum_words, inv_m and out, and the stream; n_m,
#: n_u, L and n_out (int64); the first network and the networks of this
#: launch (int32) — then ``_SEGMENTS``.
_LAUNCH = struct.Struct("<30q2i")
#: ``MAX_NETS`` (start, stop) pairs (int32), the unused ones 0.
_SEGMENTS = struct.Struct(f"<{2 * MAX_NETS}i")

SOURCE = _build.CSRC / "count_terms.cu"

#: ``--fmad=false``: no multiply-add is contracted, so the kernels round
#: every operation as the plain torch versions do.
NVCC_FLAGS = ("--fmad=false",)

_LIB = None
_LAUNCHES: Dict[str, int] = {"count_terms": 0, "count_layers": 0}
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_GET_DEVICE = getattr(torch._C, "_cuda_getDevice", None)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def build() -> Tuple[Path, str]:
    """Compile the kernels if no library for this source exists yet →
    (library path, compiler log) — see :mod:`repro_torch.kernels._build`."""
    return _build.build(SOURCE, NVCC_FLAGS)


def _lib():
    global _LIB
    if _LIB is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib = _build.load(SOURCE, NVCC_FLAGS, {
            "count_terms_launch": [ctypes.c_char_p],
            "count_terms_constants": [p],
            "count_terms_resources": [ctypes.c_int, p],
            "count_layers_launch": [p, i64, p, i64, p, p]})
        out = (ctypes.c_int * 4)()
        lib.count_terms_constants(out)
        want = (_LAUNCH.size + _SEGMENTS.size, MAX_NETS)
        if (out[0], out[3]) != want:
            raise RuntimeError(
                f"count_terms.cu's Launch size and segments a launch "
                f"{(out[0], out[3])} do not match the wrapper's {want}")
        _LIB = lib
    return _LIB


def resources(kernel: str) -> Tuple[int, int, int]:
    """(registers a thread, local memory bytes a thread, blocks that one SM
    of the current card holds at once) of ``kernel`` ("count_terms" or
    "count_layers") at the block size it launches with."""
    out = (ctypes.c_int * 3)()
    rc = _lib().count_terms_resources(
        ("count_terms", "count_layers").index(kernel), out)
    if rc != 0:
        raise RuntimeError(f"count-terms resources: CUDA error {rc}")
    return out[0], out[1], out[2]


def _device_of(*operands) -> torch.device:
    devs = set()
    for o in operands:
        devs |= ({v.device for v in o.values()} if isinstance(o, dict)
                 else {o.device})
    if len(devs) != 1:
        raise ValueError(f"count-terms operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"count-terms operands must lie on the CPU or a "
                         f"CUDA device, got {dev}")
    return dev


def _checked(cols, names: Sequence[str], shape) -> list:
    """The columns ``names`` of ``cols``, after checking that each is
    float64 of ``shape`` ([n, 1] or [1, n]; ``None``: the first one's,
    which must be [n, 1])."""
    missing = [k for k in names if k not in cols]
    if missing:
        raise ValueError(f"count-terms operands miss columns {missing}")
    vals = [cols[k] for k in names]
    if shape is None:
        shape = (vals[0].shape[0], 1)
    for name, v in zip(names, vals):
        if v.dtype != torch.float64:
            raise ValueError(f"count-terms column {name!r} must be float64, "
                             f"got {v.dtype}")
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"count-terms column {name!r} has shape "
                             f"{tuple(v.shape)}, expected {tuple(shape)}")
    return vals


def _addresses(cols, names: Sequence[str], shape, keep: list) -> list:
    """Device addresses of the checked columns, each made contiguous if
    it is not (the copy is appended to ``keep``, which the caller holds
    until the launch)."""
    out = []
    for v in _checked(cols, names, shape):
        if not v.is_contiguous():
            v = v.contiguous()
            keep.append(v)
        out.append(v.data_ptr())
    return out


@functools.lru_cache(maxsize=64)
def _segment_words(segs: Tuple[Tuple[int, int], ...]) -> bytes:
    """The packed (start, stop) pairs of at most ``MAX_NETS`` segments."""
    flat = [x for ab in segs for x in ab]
    return _SEGMENTS.pack(*flat, *[0] * (_SEGMENTS.size // 4 - len(flat)))


def _stack_columns(cols, names: Sequence[str], shape) -> torch.Tensor:
    """→ contiguous float64 [len(names), n] of the checked columns."""
    return torch.stack([v.reshape(-1) for v in _checked(cols, names, shape)])


def _layer_count(lay) -> int:
    return lay[LAYER_FIELDS[0]].shape[-1] if LAYER_FIELDS[0] in lay else 0


def _stack_operands(cfg_u, lay) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ contiguous float64 cfg [7, n_u] and lay [16, L], after checking
    that every column is float64 and has the engine's shape."""
    return (_stack_columns(cfg_u, CFG_COLUMNS, None),
            _stack_columns(lay, LAYER_FIELDS, (1, _layer_count(lay))))


def _check_segments(segments, n_l: int) -> Tuple[Tuple[int, int], ...]:
    segs = tuple((int(a), int(b)) for a, b in segments)
    if not segs or any(not 0 <= a <= b <= n_l for a, b in segs):
        raise ValueError(f"segments must be non-empty (start, stop) pairs "
                         f"with 0 <= start <= stop <= {n_l}, got {segments}")
    return segs


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def count_term_sums(segments, cfg_m, cfg_u, lay, inv_m):
    """Mapping → 14 count terms → per-network segment sums.

    segments: ((start, stop), ...) on the layer axis; cfg_m: dict of
    [n_m, 1] float64 columns keyed by ``MAP_COLUMNS`` (the mapping-unique
    rows); cfg_u: dict of [n_u, 1] float64 columns with at least
    ``gb_psum_words`` (the count-unique rows); lay: dict of [1, L] float64
    columns keyed by ``LAYER_FIELDS``; inv_m: int64 [n_u], the mapping row
    of each count row, non-decreasing (the count rows grouped by mapping
    row; every mapping row has one).  The kernel finds each group by a
    search of ``inv_m`` and does not read it whole, so the order is checked
    only on CPU tensors (on the card a check would synchronise).  Returns a
    14-tuple of [n_u, n_net] tensors (config-independent terms arrive
    broadcast along the count axis)."""
    dev = _device_of(cfg_m, cfg_u, lay, inv_m)
    if dev.type == "cpu":
        if bool((inv_m[1:] < inv_m[:-1]).any()):
            raise ValueError("inv_m must be non-decreasing: the count rows "
                             "grouped by mapping row")
        return tuple(ref.count_term_sums_ref(
            segments, cfg_m, cfg_u, lay, inv_m).unbind(0))
    lib = _lib()
    keep = []
    n_l = _layer_count(lay)
    lay_ptrs = _addresses(lay, LAYER_FIELDS, (1, n_l), keep)
    cfg_ptrs = _addresses(cfg_m, MAP_COLUMNS, None, keep)
    n_m = cfg_m[MAP_COLUMNS[0]].shape[0]
    (g_ptr,) = _addresses(cfg_u, ("gb_psum_words",), None, keep)
    n_u = cfg_u["gb_psum_words"].shape[0]
    if inv_m.dtype != torch.int64 or tuple(inv_m.shape) != (n_u,):
        raise ValueError(f"inv_m must be int64 [{n_u}], got {inv_m.dtype} "
                         f"{tuple(inv_m.shape)}")
    segs = _check_segments(segments, n_l)
    if not inv_m.is_contiguous():
        inv_m = inv_m.contiguous()
    n_net = len(segs)
    out = torch.empty((N_TERMS, n_u, n_net), dtype=torch.float64, device=dev)
    if n_u == 0:
        return tuple(out.unbind(0))
    stream = (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    head = (*cfg_ptrs, *lay_ptrs, g_ptr, inv_m.data_ptr(), out.data_ptr(),
            stream, n_m, n_u, n_l, n_net)
    current = dev.index == (_GET_DEVICE() if _GET_DEVICE is not None
                            else torch.cuda.current_device())
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        for j0 in range(0, n_net, MAX_NETS):
            part = segs[j0:j0 + MAX_NETS]
            rc = lib.count_terms_launch(
                _LAUNCH.pack(*head, j0, len(part)) + _segment_words(part))
            _check_launch(rc, "count_terms")
            _LAUNCHES["count_terms"] += 1
    return tuple(out.unbind(0))


def count_term_layers(cfg_u, lay):
    """Mapping → 14 per-layer count terms, no segment reduction.

    Same operands as :func:`count_term_sums` minus ``segments``; returns a
    14-tuple of [n_u, L] tensors."""
    dev = _device_of(cfg_u, lay)
    if dev.type == "cpu":
        return tuple(ref.count_term_layers_ref(cfg_u, lay).unbind(0))
    lib = _lib()
    cfg, laym = _stack_operands(cfg_u, lay)
    n_u, n_l = cfg.shape[1], laym.shape[1]
    out = torch.empty((N_TERMS, n_u, n_l), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.count_layers_launch(
            cfg.data_ptr(), n_u, laym.data_ptr(), n_l, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "count_layers")
    _LAUNCHES["count_layers"] += 1
    return tuple(out.unbind(0))
