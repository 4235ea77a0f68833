"""Plain torch version of the SSD chunked-scan kernel.

The same function as the JAX package's Pallas ``ssd_scan`` (and its
sequential oracle ``ssd_ref``): the Mamba-2 recurrence
``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t B_tᵀ``, ``y_t = h_t C_t``, computed
chunk by chunk as ``ssd_chunked`` in ``models/mamba2.py`` computes it —
vectorised over chunks, with only the short inter-chunk state recurrence
as a loop — but all in float32 and cast once to x's dtype, as the kernel
is.  Head h reads group ``h // (H / G)`` of b and c.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256
                 ) -> torch.Tensor:
    """x: [B, T, H, P]; dt: [B, T, H]; A: [H] (negative); b, c:
    [B, T, G, N] with G dividing H → y [B, T, H, P] in x's dtype.

    A ragged last chunk is padded with dt = 0, an exact no-op."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    r = h // g
    q = min(chunk, t)
    nc = -(-t // q)
    pad = nc * q - t

    def chunks(a):
        a = a.float()
        if pad:
            a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(bsz, nc, q, *a.shape[2:])

    xc = chunks(x).reshape(bsz, nc, q, g, r, p)
    dtc = chunks(dt)                                      # [B, nc, Q, H]
    bc, cc = chunks(b), chunks(c)                         # [B, nc, Q, G, N]

    cum = torch.cumsum(dtc * A.float(), dim=2)            # [B, nc, Q, H]
    total = cum[:, :, -1]                                 # [B, nc, H]
    xdt = xc * dtc.reshape(bsz, nc, q, g, r, 1)

    # intra-chunk: (C Bᵀ ⊙ L)·(dt·X), L[q, k] = exp(cum_q - cum_k) for
    # k <= q; above the diagonal the exponent is -inf, so exp gives 0
    # and no positive exponent is ever evaluated
    cum_h = cum.permute(0, 1, 3, 2)                       # [B, nc, H, Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~keep, float("-inf")))
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)       # [B, nc, G, Q, Q]
    w = cb[:, :, :, None] * lmat.reshape(bsz, nc, g, r, q, q)
    y = torch.einsum("bcgrqk,bckgrp->bcqgrp", w, xdt)

    # each chunk's own contribution to the state at its end
    decay_out = torch.exp(total[:, :, None] - cum)        # [B, nc, Q, H]
    xo = xdt * decay_out.reshape(bsz, nc, q, g, r, 1)
    states = torch.einsum("bcqgrp,bcqgn->bcgrpn", xo, bc)  # [B, nc, G, R, P, N]

    # inter-chunk recurrence (float32 carry) and its output
    decay = torch.exp(total).reshape(bsz, nc, g, r, 1, 1)
    s = torch.zeros_like(states[:, 0])
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * decay[:, ci] + states[:, ci]
    prev = torch.stack(prev, dim=1)                       # [B, nc, G, R, P, N]
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cc, prev)
    y = y + y_off * torch.exp(cum).reshape(bsz, nc, q, g, r, 1)
    return y.reshape(bsz, nc * q, h, p)[:, :t].to(x.dtype)
