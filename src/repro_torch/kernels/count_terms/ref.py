"""Plain torch versions of the two count-terms kernels.

They repeat the kernels' arithmetic as torch operations.  The sums are
the engine's plain heavy stage, ``energymodel._term_sums_body``: the RS
mapping on the mapping-unique rows, gathered to the count-unique rows, the
counts there and per-network segment slices summed — what ``count_terms``
in ``src/repro_torch/csrc/count_terms.cu`` fuses, with the same operands.
The per-layer terms run the mapping directly on the count-unique rows, as
``count_layers`` does.  The wrappers in ``ops.py`` use them for tensors on
the CPU; ``chip_smoke.py`` holds the kernels against them on the card.

:func:`count_term_sums_split` is ``count_terms``' own decomposition written
as torch operations (the program whose operations ``chip_smoke.py`` counts
for the kernel's bound); no wrapper runs it.
"""

from __future__ import annotations

import torch

from ...core import energymodel
from ...core.rs_mapping import _cdiv, _fdiv


def count_term_sums_ref(segments, cfg_m, cfg_u, lay, inv_m) -> torch.Tensor:
    """The stacked ``energymodel._term_sums_body``: segments ((start, stop),
    ...) per network; cfg_m / cfg_u dicts of [n_m, 1] mapping-unique and
    [n_u, 1] count-unique columns; lay a dict of [1, L] layer columns;
    inv_m [n_u] the mapping row of each count row.  Returns the
    [N_TERMS, n_u, n_net] segment sums (config-independent terms broadcast
    along the count axis)."""
    sums = energymodel._term_sums_body(segments, cfg_m, cfg_u, lay, inv_m)
    return torch.stack([s.expand(inv_m.shape[0], len(segments))
                        for s in sums])


def count_term_layers_ref(cfg_u, lay) -> torch.Tensor:
    """The raw [N_TERMS, n_u, L] term stack (config-independent terms
    broadcast along the unique axis): the segment-sum-free twin of
    :func:`count_term_sums_ref`, with the mapping on the count-unique rows."""
    terms = energymodel._count_terms(cfg_u, lay)
    n_u = cfg_u[next(iter(cfg_u))].shape[0]
    l_tot = lay[next(iter(lay))].shape[-1]
    return torch.stack([t.expand(n_u, l_tot) for t in terms])


def _kernel_mapping(cfg_m, lay):
    """What ``count_terms_kernel``'s ``map_at`` computes of the RS mapping,
    op for op, on [n_m, 1] mapping-unique columns and [1, L] layers →
    (ky_serial, n_c, n_m, w_psum, active PEs)."""
    rows, cols = cfg_m["rows"], cfg_m["cols"]
    acc = lay["is_acc"] != 0
    ky, oy, c_ch = lay["ky"], lay["oy"], lay["c_ch"]
    ky_serial = _cdiv(ky, rows)
    ky_map = _cdiv(ky, ky_serial)
    fold = torch.clamp(_fdiv(rows, ky_map), min=1.0)
    oy_pass = torch.minimum(oy, cols)
    col_rep = torch.clamp(_fdiv(cols, oy_pass), min=1.0)
    sets_rows = torch.minimum(_cdiv(oy, oy_pass), fold)
    fold2 = torch.clamp(_fdiv(fold, sets_rows), min=1.0)
    cap_c_sp = torch.where(acc, torch.minimum(c_ch, fold2), 1.0)
    fold_m = torch.clamp(_fdiv(fold2, cap_c_sp), min=1.0)
    plane = torch.where(acc, lay["m"], c_ch)
    cap_m_sp = torch.clamp(torch.minimum(plane, fold_m * col_rep), min=1.0)
    p_rf = torch.clamp(torch.minimum(
        cfg_m["rf_psum_words"], _fdiv(cfg_m["rf_weight_words"], lay["kx"])),
        min=1.0)
    p = torch.minimum(p_rf, _cdiv(plane, cap_m_sp))
    cap_m = torch.clamp(torch.minimum(plane, cap_m_sp * p), min=1.0)
    ch_fit = torch.clamp(
        _fdiv(cfg_m["gb_ifmap_words"], lay["ix"] * lay["iy"]), min=1.0)
    cap_c = torch.minimum(cap_c_sp, ch_fit)
    cap_m = torch.where(acc, cap_m, torch.minimum(cap_m, ch_fit))
    n_c = torch.where(acc, _cdiv(c_ch, cap_c), 1.0)
    n_m = _cdiv(plane, cap_m)
    w_psum = cap_m * lay["ox"] * oy
    cap_c_sp_eff = torch.minimum(cap_c_sp, cap_c)
    cap_m_sp_eff = torch.minimum(cap_m_sp, cap_m)
    active = ky_map * oy_pass * sets_rows * torch.where(
        acc, cap_c_sp_eff * cap_m_sp_eff, cap_m_sp_eff)
    return ky_serial, n_c, n_m, w_psum, torch.minimum(active, rows * cols)


def count_term_sums_split(segments, cfg_m, cfg_u, lay, inv_m) -> torch.Tensor:
    """``count_terms``' decomposition as torch operations, on
    :func:`count_term_sums_ref`'s operands: the mapping and the terms that
    do not depend on GB_psum once per (mapping row, layer), then per (count
    row, layer) only A = inter_rounds · max(w_psum − GB_psum, 0) and
    B = inter_rounds · min(w_psum, GB_psum); terms 0, 1, 3 and 11 are
    layer-only sums plus the sums of A and B.  Returns [N_TERMS, n_u,
    n_net]; on the 12 integer terms it equals :func:`count_term_sums_ref`
    bit for bit (every value is an integer below 2^53 at the engine's
    grids)."""
    ky_serial, n_c, n_m, w_psum, active = _kernel_mapping(cfg_m, lay)
    acc, pool = lay["is_acc"] != 0, lay["is_pool"] != 0
    ifmap, weights = lay["ifmap_words"], lay["weight_words"]
    ofmap, macs = lay["ofmap_words"], lay["macs"]
    pool_ops = lay["c_ch"] * lay["ox"] * lay["oy"] * lay["kx"] * lay["ky"]
    ops = torch.where(pool, pool_ops, macs)
    gb_if = ifmap * torch.where(acc, n_m, 1.0)
    gb_wt = weights * ky_serial
    inter = torch.clamp(n_c * ky_serial - 1.0, min=0.0)
    irw = inter * w_psum                             # A + B
    gb_reads = gb_if + gb_wt
    noc = (gb_reads + irw) + (irw + ofmap)
    g = cfg_u["gb_psum_words"]
    a = inter[inv_m] * torch.clamp(w_psum[inv_m] - g, min=0.0)
    b = inter[inv_m] * torch.minimum(w_psum[inv_m], g)

    n_u, n_m_rows = inv_m.shape[0], cfg_m["rows"].shape[0]

    def seg_sum(t, n):
        return torch.stack([t[..., x:y].sum(-1) for x, y in segments],
                           -1).expand(n, len(segments))

    def per_mapping_row(t):
        return seg_sum(t, n_m_rows)[inv_m]

    sum_a, sum_b = seg_sum(a, n_u), seg_sum(b, n_u)
    m0 = seg_sum(ifmap + weights, n_u)
    m1 = seg_sum(ofmap, n_u)
    terms = (
        m0 + sum_a,                                             # 0
        m1 + sum_a,                                             # 1
        per_mapping_row(gb_if + ifmap),                         # 2
        2.0 * (sum_b + m1),                                     # 3
        per_mapping_row(gb_wt + weights),                       # 4
        per_mapping_row((4.0 * ops) + noc),                     # 5
        seg_sum(torch.where(pool, 0.0, macs), n_u),             # 6
        seg_sum(torch.where(pool, pool_ops, 0.0), n_u),         # 7
        per_mapping_row(
            (cfg_m["rows"] * cfg_m["cols"] - active) * ops / active),  # 8
        per_mapping_row(noc),                                   # 9
        per_mapping_row(gb_reads),                              # 10
        sum_b + m1,                                             # 11
        per_mapping_row(irw + ofmap),                           # 12
        per_mapping_row(ops / active),                          # 13
    )
    return torch.stack(terms)
