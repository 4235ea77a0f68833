"""Plain torch versions of the two count-terms kernels.

They repeat the kernels' arithmetic as torch operations, with no
mapping-level dedup: the RS mapping runs directly on the count-unique rows
and the layer axis is summed with per-network segment slices — what the
kernels in ``src/repro_torch/csrc/count_terms.cu`` fuse.  The wrappers in
``ops.py`` use them for tensors on the CPU; ``chip_smoke.py`` holds the
kernels against them on the card.
"""

from __future__ import annotations

import torch

from ...core import energymodel


def count_term_sums_ref(cfg_u, lay, segments) -> torch.Tensor:
    """cfg_u: dict of [n_u, 1] count columns; lay: dict of [1, L] layer
    columns; segments: ((start, stop), ...) per network.  Returns the
    stacked [N_TERMS, n_u, n_net] segment sums (config-independent terms
    broadcast along the unique axis)."""
    terms = energymodel._count_terms(cfg_u, lay)
    n_u = cfg_u[next(iter(cfg_u))].shape[0]
    return torch.stack([
        torch.stack([t[..., a:b].sum(-1) for a, b in segments],
                    dim=-1).expand(n_u, len(segments))
        for t in terms])


def count_term_layers_ref(cfg_u, lay) -> torch.Tensor:
    """The raw [N_TERMS, n_u, L] term stack (config-independent terms
    broadcast along the unique axis): the segment-sum-free twin of
    :func:`count_term_sums_ref`."""
    terms = energymodel._count_terms(cfg_u, lay)
    n_u = cfg_u[next(iter(cfg_u))].shape[0]
    l_tot = lay[next(iter(lay))].shape[-1]
    return torch.stack([t.expand(n_u, l_tot) for t in terms])
