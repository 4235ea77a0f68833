"""Plain torch version of the SSD chunked-scan kernel.

The same function as the JAX package's Pallas ``ssd_scan`` (and its
sequential oracle ``ssd_ref``): the Mamba-2 recurrence
``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t B_tᵀ``, ``y_t = h_t C_t``, computed
chunk by chunk as ``ssd_chunked`` in ``models/mamba2.py`` computes it —
vectorised over chunks, with only the short inter-chunk state recurrence
as a loop — but all in float32 and cast once to x's dtype, as the kernel
is.  Head h reads group ``h // (H / G)`` of b and c.

It is cut into the CUDA kernel's four passes, each with the kernel's
layout of what it hands on, so that the card can hold each pass against
its plain counterpart:

1. :func:`_chunk_state_ref` — ``cum`` [B, H, nc, Q] and each chunk's own
   state ``S_c`` [B, nc, H, P, N];
2. :func:`_cb_ref` — ``C Bᵀ`` [B, nc, G, Q, Q], once per group;
3. :func:`_state_pass_ref` — the state entering each chunk, ``S_prev``;
4. :func:`_chunk_scan_ref` — y from the three.

:func:`ssd_scan_ref` is their composition.
"""

from __future__ import annotations

import torch


def _chunks(a: torch.Tensor, q: int) -> torch.Tensor:
    """[B, T, ...] → float32 [B, nc, Q, ...]; a ragged last chunk is
    padded with zeros (dt = 0 there, an exact no-op)."""
    bsz, t = a.shape[:2]
    nc = -(-t // q)
    a = a.float()
    if nc * q != t:
        a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2)
                                    + (0, nc * q - t))
    return a.reshape(bsz, nc, q, *a.shape[2:])


def _xdt(x: torch.Tensor, dt: torch.Tensor, g: int, q: int):
    """(dt·x [B, nc, Q, G, R, P], dt [B, nc, Q, H]) in float32."""
    bsz, _, h, p = x.shape
    xc = _chunks(x, q)
    nc = xc.shape[1]
    dtc = _chunks(dt, q)
    return (xc.reshape(bsz, nc, q, g, h // g, p)
            * dtc.reshape(bsz, nc, q, g, h // g, 1)), dtc


def _dt_chunks(dt: torch.Tensor, chunk: int) -> torch.Tensor:
    """dt [B, T, H] → float32 [B, H, nc, Q], zero past a ragged end: the
    layout of ``cum``, in which the kernel's pass 1 hands dt on."""
    return _chunks(dt, chunk).permute(0, 3, 1, 2).contiguous()


def _chunk_state_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     b: torch.Tensor, *, chunk: int):
    """Pass 1 → (cum [B, H, nc, Q], states [B, nc, H, P, N]).  ``cum`` is
    the cumulative sum of dt·A inside each chunk; ``states[:, c]`` is the
    chunk's own contribution to the state at its end,
    ``(dt·x ⊙ exp(total - cum))ᵀ B``."""
    bsz, _, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = chunk
    xdt, dtc = _xdt(x, dt, g, q)
    nc = dtc.shape[1]
    bc = _chunks(b, q)                                    # [B, nc, Q, G, N]
    cum = torch.cumsum(dtc * A.float(), dim=2)            # [B, nc, Q, H]
    total = cum[:, :, -1]                                 # [B, nc, H]
    decay_out = torch.exp(total[:, :, None] - cum)        # [B, nc, Q, H]
    xo = xdt * decay_out.reshape(bsz, nc, q, g, h // g, 1)
    states = torch.einsum("bcqgrp,bcqgn->bcgrpn", xo, bc)
    return (cum.permute(0, 3, 1, 2).contiguous(),
            states.reshape(bsz, nc, h, p, n).contiguous())


def _cb_ref(b: torch.Tensor, c: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Pass 2 → C Bᵀ [B, nc, G, Q, Q] of each chunk, once per group (the
    kernel writes only the lower triangle, k <= q)."""
    return torch.einsum("bcqgn,bckgn->bcgqk", _chunks(c, chunk),
                        _chunks(b, chunk))


def _state_pass_ref(states: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Pass 3: each chunk's own states [B, nc, H, P, N] and cum
    [B, H, nc, Q] → the state entering each chunk, S_prev, same shape:
    ``S_prev[c] = S``, then ``S = exp(total_c)·S + S_c[c]`` in float32."""
    decay = torch.exp(cum[..., -1]).permute(0, 2, 1)[..., None, None]
    s = torch.zeros_like(states[:, 0])
    prev = []
    for ci in range(states.shape[1]):
        prev.append(s)
        s = s * decay[:, ci] + states[:, ci]
    return torch.stack(prev, dim=1)


def _chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, c: torch.Tensor,
                    cb: torch.Tensor, cum: torch.Tensor, prev: torch.Tensor,
                    *, chunk: int) -> torch.Tensor:
    """Pass 4 → y [B, T, H, P] in x's dtype:
    ``(C Bᵀ ⊙ L)·(dt·X) + exp(cum)·(C S_prevᵀ)``."""
    bsz, t, h, p = x.shape
    g, n = c.shape[2], c.shape[3]
    r, q = h // g, chunk
    xdt, _ = _xdt(x, dt, g, q)
    nc = xdt.shape[1]
    cc = _chunks(c, q)

    # intra-chunk: (C Bᵀ ⊙ L)·(dt·X), L[q, k] = exp(cum_q - cum_k) for
    # k <= q; above the diagonal the exponent is -inf, so exp gives 0
    # and no positive exponent is ever evaluated
    cum_h = cum.permute(0, 2, 1, 3)                       # [B, nc, H, Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~keep, float("-inf")))
    w = cb[:, :, :, None] * lmat.reshape(bsz, nc, g, r, q, q)
    y = torch.einsum("bcgrqk,bckgrp->bcqgrp", w, xdt)

    # inter-chunk: the state entering the chunk, decayed to each step
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cc,
                         prev.float().reshape(bsz, nc, g, r, p, n))
    decay_in = torch.exp(cum_h.permute(0, 1, 3, 2))       # [B, nc, Q, H]
    y = y + y_off * decay_in.reshape(bsz, nc, q, g, r, 1)
    return y.reshape(bsz, nc * q, h, p)[:, :t].to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256
                 ) -> torch.Tensor:
    """x: [B, T, H, P]; dt: [B, T, H]; A: [H] (negative); b, c:
    [B, T, G, N] with G dividing H → y [B, T, H, P] in x's dtype, in
    chunks of ``min(chunk, T)`` steps: the four passes in order."""
    q = min(chunk, x.shape[1])
    cum, states = _chunk_state_ref(x, dt, A, b, chunk=q)
    cb = _cb_ref(b, c, chunk=q)
    prev = _state_pass_ref(states, cum)
    return _chunk_scan_ref(x, dt, c, cb, cum, prev, chunk=q)
