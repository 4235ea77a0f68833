"""Row-stationary spatial mapping (Eyeriss-style), on float64 torch tensors.

The PyTorch port of ``repro.core.rs_mapping``; the docstring of
:func:`mapping` there describes the model (PE sets, vertical and horizontal
replication, RF multiplexing, the GB_ifmap gate of Observation 2).  Here the
formulas are written once against torch and broadcast over any leading
axes: ``[n_u, 1]`` config columns against ``[1, L]`` layer columns in the
batched engine, 0-d config values against ``[L]`` layers in the scalar Tool.

Two things differ from the array-module code of the reference:

* the layer-kind flags arrive as float64 (the engine stacks every layer
  field as float64), and ``torch.where`` takes only a boolean condition, so
  every flag is compared against 0 (``is_acc != 0``);
* floor division is ``torch.div(..., rounding_mode="floor")``, which follows
  numpy's ``floor_divide`` on doubles; every operand is an integer below
  2^53, so the quotients are exact and match the reference bit for bit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .topology import KIND_CONV, KIND_DW, KIND_FC, KIND_POOL, KIND_PW, Layer


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _cdiv(a, b):
    return -_fdiv(-a, b)


def mapping(*, rows, cols,                 # physical array [R, C]
            c_ch, m, ky, kx, stride,       # layer loop bounds
            ix, iy, oy, ox,                # ifmap row length/height, output rows/cols
            is_acc, is_dw, is_pool,        # layer-kind flags (0/1 float64)
            gb_ifmap_words=None,
            rf_ifmap_words=12, rf_weight_words=224, rf_psum_words=16):
    """Return the RS mapping quantities for (config × layer) grids.

    All tensor arguments are broadcastable float64 tensors on one device;
    the RF sizes may also be Python numbers.  Output dict values are
    tensors of the broadcast shape.  ``is_dw`` is accepted for parity with
    the reference signature and, as there, enters no quantity.
    """
    acc = is_acc != 0
    one = torch.ones_like(rows * c_ch)

    # A filter row taller than the array folds serially over ky_serial passes.
    ky_serial = _cdiv(ky, rows)
    ky_map = _cdiv(ky, ky_serial)                # PE-set height actually used

    fold = torch.maximum(one, _fdiv(rows, ky_map))    # vertical PE-set slots

    oy_pass = torch.minimum(oy, cols)                 # output rows per pass
    col_rep = torch.maximum(one, _fdiv(cols, oy_pass))  # leftover cols → filters

    # Vertical replication covers the remaining output-row blocks first;
    # multi-channel processing starts only when the array out-sizes the map.
    sets_rows = torch.minimum(_cdiv(oy, oy_pass), fold)
    fold2 = torch.maximum(one, _fdiv(fold, sets_rows))

    # Channel accumulation (conv / pointwise / fc): psums of cap_c channels
    # add in-array.  Depthwise / pool: channels are independent planes.
    cap_c_sp = torch.where(acc, torch.minimum(c_ch, fold2), one)
    fold_m = torch.maximum(one, _fdiv(fold2, cap_c_sp))  # leftover rows → filters

    plane_count = torch.where(acc, m, c_ch)
    cap_m_sp = torch.maximum(
        torch.minimum(plane_count, fold_m * col_rep), one)

    # --- RF temporal multiplexing (filters) ----------------------------------
    q = one
    cap_c = cap_c_sp
    p_rf = torch.maximum(one, torch.minimum(
        rf_psum_words * one, _fdiv(rf_weight_words * one, kx)))
    p = torch.minimum(p_rf, _cdiv(plane_count, cap_m_sp))
    cap_m = torch.maximum(torch.minimum(plane_count, cap_m_sp * p), one)

    # --- GB_ifmap gating of the processing capacity (Observation 2) ---------
    if gb_ifmap_words is not None:
        ch_fit = torch.maximum(one, _fdiv(gb_ifmap_words, ix * iy))
        cap_c = torch.minimum(cap_c, ch_fit)
        cap_m = torch.where(acc, cap_m, torch.minimum(cap_m, ch_fit))
    ifmap_rows = (oy_pass - 1) * stride + ky

    n_c = torch.where(acc, _cdiv(c_ch, cap_c), one)      # channel rounds
    n_m = _cdiv(plane_count, cap_m)                      # filter blocks
    n_oy = _cdiv(oy, oy_pass * sets_rows)                # output-row blocks

    # Per-pass working sets (words).
    ch_in_flight = torch.where(acc, cap_c, cap_m)
    w_ifmap = ch_in_flight * ix * ifmap_rows
    w_psum = cap_m * ox * oy
    w_weight = cap_m * torch.where(acc, cap_c, one) * kx * ky

    # GB-gated capacity below the spatial capacity idles PEs (Obs. 2).
    cap_c_sp_eff = torch.minimum(cap_c_sp, cap_c)
    cap_m_sp_eff = torch.minimum(cap_m_sp, cap_m)
    active_pes = ky_map * oy_pass * sets_rows * torch.where(
        acc, cap_c_sp_eff * cap_m_sp_eff, cap_m_sp_eff)
    active_pes = torch.minimum(active_pes, rows * cols)

    return dict(
        ky_serial=ky_serial, ky_map=ky_map, fold=fold, cap_c=cap_c,
        fold_m=fold_m, oy_pass=oy_pass, col_rep=col_rep, cap_m=cap_m,
        n_c=n_c, n_m=n_m, n_oy=n_oy, w_ifmap=w_ifmap, w_psum=w_psum,
        w_weight=w_weight, active_pes=active_pes,
        ch_in_flight=ch_in_flight, q=q, p=p,
    )


def layer_struct(layers: Sequence[Layer], *,
                 device) -> Dict[str, torch.Tensor]:
    """Struct-of-arrays view of a ``List[Layer]``: float64 ``[n_layers]``
    tensors on ``device`` (the flags as 0.0 / 1.0)."""

    def arr(fn):
        return torch.tensor([float(fn(l)) for l in layers],
                            dtype=torch.float64, device=device)

    return dict(
        c_ch=arr(lambda l: l.c_in),
        m=arr(lambda l: l.c_out),
        ky=arr(lambda l: l.k),
        kx=arr(lambda l: l.k),
        stride=arr(lambda l: l.stride),
        ix=arr(lambda l: l.w_in),
        iy=arr(lambda l: l.h_in),
        oy=arr(lambda l: l.h_out),
        ox=arr(lambda l: l.w_out),
        macs=arr(lambda l: l.macs),
        weight_words=arr(lambda l: l.weight_words),
        ifmap_words=arr(lambda l: l.ifmap_words),
        ofmap_words=arr(lambda l: l.ofmap_words),
        is_acc=arr(lambda l: l.kind in (KIND_CONV, KIND_PW, KIND_FC)),
        is_dw=arr(lambda l: l.kind == KIND_DW),
        is_pool=arr(lambda l: l.kind == KIND_POOL),
    )
