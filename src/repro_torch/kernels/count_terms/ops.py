"""Wrappers of the CUDA count-terms kernels: build, load, check, launch.

``count_term_sums`` and ``count_term_layers`` take the engine's operands —
the [n_u, 1] count-unique config columns, the [1, L] stacked layer columns
and, for the sums, the per-network ``segments`` — stack them into the
kernels' [7, n_u] and [16, L] float64 layouts, and return a 14-tuple of
[n_u, n_net] (or [n_u, L]) tensors, as ``energymodel._term_sums_body`` and
``_term_layers_body`` do.  On CPU tensors they run the plain versions in
``ref.py``; on CUDA tensors they launch the kernel or raise — no fallback.

The kernels (``src/repro_torch/csrc/count_terms.cu``) are compiled with
``nvcc`` at first use into a shared library with a plain C interface,
loaded with ``ctypes`` (:mod:`repro_torch.kernels._build`).

``launch_counts()`` counts the launches of each kernel: it rises only where
a kernel is launched, never on the plain path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from ...core.energymodel import _COUNT_COLUMNS as CFG_COLUMNS
from .. import _build
from . import ref

#: Row order of the stacked layer operand (``rs_mapping.layer_struct`` keys).
LAYER_FIELDS = ("c_ch", "m", "ky", "kx", "stride", "ix", "iy", "oy", "ox",
                "macs", "weight_words", "ifmap_words", "ofmap_words",
                "is_acc", "is_dw", "is_pool")

#: Number of count terms (see ``energymodel._count_terms``).
N_TERMS = 14

SOURCE = _build.CSRC / "count_terms.cu"

#: ``--fmad=false``: no multiply-add is contracted, so the kernels round
#: every operation as the plain torch versions do.
NVCC_FLAGS = ("--fmad=false",)

_LIB = None
_LAUNCHES: Dict[str, int] = {"count_terms": 0, "count_layers": 0}


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
        _LIB = _build.load(SOURCE, NVCC_FLAGS, {
            "count_terms_launch": [p, i64, p, i64, p, p, i64, p, p],
            "count_layers_launch": [p, i64, p, i64, p, p]})
    return _LIB


def _device_of(cfg_u, lay) -> torch.device:
    devs = {v.device for v in cfg_u.values()} | {v.device for v in lay.values()}
    if len(devs) != 1:
        raise ValueError(f"count-terms operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"count-terms operands must lie on the CPU or a "
                         f"CUDA device, got {dev}")
    return dev


def _stack_operands(cfg_u, lay) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ contiguous float64 cfg [7, n_u] and lay [16, L], after checking
    that every column is float64 and has the engine's shape."""
    missing = [k for k in CFG_COLUMNS if k not in cfg_u] + [
        k for k in LAYER_FIELDS if k not in lay]
    if missing:
        raise ValueError(f"count-terms operands miss columns {missing}")
    cols = [cfg_u[k] for k in CFG_COLUMNS]
    rows = [lay[k] for k in LAYER_FIELDS]
    n_u = cols[0].shape[0]
    n_l = rows[0].shape[-1]
    for name, v, shape in ([(k, c, (n_u, 1)) for k, c in zip(CFG_COLUMNS, cols)]
                           + [(k, r, (1, n_l)) for k, r in zip(LAYER_FIELDS, rows)]):
        if v.dtype != torch.float64:
            raise ValueError(f"count-terms column {name!r} must be float64, "
                             f"got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"count-terms column {name!r} has shape "
                             f"{tuple(v.shape)}, expected {shape}")
    cfg = torch.stack([c.reshape(-1) for c in cols]).contiguous()
    laym = torch.stack([r.reshape(-1) for r in rows]).contiguous()
    return cfg, laym


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def count_term_sums(cfg_u, lay, segments):
    """Mapping → 14 count terms → per-network segment sums.

    cfg_u: dict of [n_u, 1] float64 columns keyed by ``_COUNT_COLUMNS``;
    lay: dict of [1, L] float64 columns keyed by ``LAYER_FIELDS``;
    segments: ((start, stop), ...) on the layer axis.  Returns a 14-tuple
    of [n_u, n_net] tensors (config-independent terms arrive broadcast
    along the unique axis)."""
    dev = _device_of(cfg_u, lay)
    if dev.type == "cpu":
        return tuple(ref.count_term_sums_ref(cfg_u, lay, segments).unbind(0))
    lib = _lib()
    cfg, laym = _stack_operands(cfg_u, lay)
    n_u, n_l = cfg.shape[1], laym.shape[1]
    seg = torch.tensor(segments, dtype=torch.int64).reshape(-1, 2)
    if seg.numel() == 0 or bool(((seg[:, 0] < 0) | (seg[:, 1] < seg[:, 0])
                                 | (seg[:, 1] > n_l)).any()):
        raise ValueError(f"segments must be non-empty (start, stop) pairs "
                         f"with 0 <= start <= stop <= {n_l}, got {segments}")
    n_net = seg.shape[0]
    starts = seg[:, 0].contiguous().to(dev)
    stops = seg[:, 1].contiguous().to(dev)
    out = torch.empty((N_TERMS, n_u, n_net), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.count_terms_launch(
            cfg.data_ptr(), n_u, laym.data_ptr(), n_l, starts.data_ptr(),
            stops.data_ptr(), n_net, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
