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

:func:`ssd_scan_ref` is their composition.  Its gradient,
:func:`ssd_scan_bwd_ref`, recomputes cum, C Bᵀ and S_prev (the state
pass in float32) and runs the CUDA backward's five passes, each with the
kernel's layout of what it hands on:

5. :func:`_bwd_chunk_out_ref` — each chunk's own share of the gradient
   of the state entering it, the inter-chunk term's dC and dcum;
6. :func:`_bwd_state_ref` — the reverse state pass: dS_c of each chunk's
   own state and the carry's share of d total;
7. :func:`_bwd_state_side_ref` — S_c's terms: du, dB, dcum, d total;
8. :func:`_bwd_diag_ref` — the intra-chunk terms, then dx, ddt and
   each chunk's share of dA;
9. :func:`_bwd_reduce_ref` — dB and dC summed over each group's heads,
   dA over batch and chunks.

Those are the "fma" route's passes (float32 operands).  The "mma" route
(bfloat16 operands, the tensor cores) forms dB and dC once a group, never
a head, in six passes of its own; :func:`ssd_scan_bwd_mma_ref` composes
their plain versions:

5. :func:`_bwd_chunk_out_mma_ref` — dS_local and the inter-chunk term's
   dcum, from dY against C S_prevᵀ (no dC);
6. :func:`_bwd_state_slices_ref` — the reverse state pass, Σ G ⊙ S_prev
   in slices of ``STATE_SLICE`` elements;
7. :func:`_bwd_state_side_mma_ref` — du, dcum and d total of S_c, with
   B_k · dB_k taken as u_k · du_k (no dB);
8. :func:`_bwd_diag_mma_ref` — the intra-chunk term, dx, ddt, dA's share
   and dCB per head (no dB or dC);
9. :func:`_bwd_group_ref` — dB and dC of each group, in ``GROUP_SLICES``
   slices of its heads;
10. :func:`_bwd_reduce_slices_ref` — the slices summed, dA over batch and
    chunks.

Each takes ``rounding``: how a product's float32 operand (the operands
that are not bf16 inputs) is fed — ``"exact"``, ``"split"`` (hi + lo, as
the kernel feeds it) or ``"single"`` (rounded once to bf16); see
:func:`_operand`.

Float32 and bfloat16 operands compute in float32; float64 ones in
float64 (the tests hold the backward against autograd there).
"""

from __future__ import annotations

import torch


def _wide(a: torch.Tensor) -> torch.Tensor:
    """a in float32, or in float64 where it is float64."""
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _chunks(a: torch.Tensor, q: int) -> torch.Tensor:
    """[B, T, ...] → float32 (float64 stays) [B, nc, Q, ...]; a ragged last
    chunk is padded with zeros (dt = 0 there, an exact no-op)."""
    bsz, t = a.shape[:2]
    nc = -(-t // q)
    a = _wide(a)
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
    cum = torch.cumsum(dtc * _wide(A), dim=2)            # [B, nc, Q, H]
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
                         _wide(prev).reshape(bsz, nc, g, r, p, n))
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


# ---------------------------------------------------------------------------
# The backward: the gradient of ssd_scan_ref, in the CUDA backward's passes
# ---------------------------------------------------------------------------
#
# Per (batch, head, chunk), with u_k = dt_k x_k, L_qk = exp(cum_q - cum_k)
# for k <= q, w_k = exp(total - cum_k) and dY the output's gradient:
#
#   y_q   = sum_{k<=q} CB_qk L_qk u_k + exp(cum_q) C_q . S_prev
#   S_c   = sum_k w_k u_k B_k^T,   S_prev[c+1] = exp(total_c) S_prev[c] + S_c
#
# Layouts handed from pass to pass: dS [B, nc, H, P, N] (as S_c), dcum
# [B, H, nc, Q] (as cum), dtot [B, H, nc], du [B, H, nc, Q, P], the
# per-head dB and dC [B, H, nc, Q, N] and dA's per-chunk shares
# [B, H, nc]; all float32 (float64 for float64 operands).


def _per_head(a: torch.Tensor, h: int) -> torch.Tensor:
    """Chunks [B, nc, Q, G, N] → each head's group [B, nc, Q, H, N]."""
    return a.repeat_interleave(h // a.shape[3], dim=3)


def _bwd_chunk_out_ref(dy: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                       prev: torch.Tensor, *, chunk: int):
    """Pass 5: the inter-chunk term y_off = exp(cum) C S_prevᵀ →
    (dS_local [B, nc, H, P, N], the chunk's own share of the gradient of
    the state entering it, (exp(cum) ⊙ dY)ᵀ C; dC [B, H, nc, Q, N],
    exp(cum_q) dY_q S_prev, per head; dcum [B, H, nc, Q], C_q · dC_q)."""
    h = dy.shape[2]
    ey = _chunks(dy, chunk) * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    ch = _per_head(_chunks(c, chunk), h)                  # [B, nc, Q, H, N]
    dsl = torch.einsum("bcqhp,bcqhn->bchpn", ey, ch)
    dc = torch.einsum("bcqhp,bchpn->bhcqn", ey, _wide(prev))
    dcum = torch.einsum("bhcqn,bcqhn->bhcq", dc, ch)
    return dsl, dc, dcum


def _bwd_state_ref(dsl: torch.Tensor, prev: torch.Tensor, cum: torch.Tensor):
    """Pass 6, the reverse state pass: G = 0, then from the last chunk to
    the first dS[c] = G, dtot[c] = exp(total_c) Σ G ⊙ S_prev[c], G =
    dS_local[c] + exp(total_c) G → (dS [B, nc, H, P, N], the gradient of
    each chunk's own state S_c; dtot [B, H, nc])."""
    decay = torch.exp(cum[..., -1])                       # [B, H, nc]
    g = torch.zeros_like(dsl[:, 0])
    ds, dtot = [None] * dsl.shape[1], [None] * dsl.shape[1]
    for ci in reversed(range(dsl.shape[1])):
        ds[ci] = g
        dtot[ci] = decay[:, :, ci] * (g * _wide(prev[:, ci])).sum((-2, -1))
        g = dsl[:, ci] + decay[:, :, ci, None, None] * g
    return torch.stack(ds, dim=1), torch.stack(dtot, dim=-1)


def _bwd_state_side_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                        cum: torch.Tensor, ds: torch.Tensor,
                        dcum: torch.Tensor, dtot: torch.Tensor, *,
                        chunk: int):
    """Pass 7: S_c = Σ_k w_k u_k B_kᵀ → (du [B, H, nc, Q, P] = w_k dS B_k,
    dB [B, H, nc, Q, N] = w_k dSᵀ u_k per head, dcum - w_k dw_k, dtot +
    Σ_k w_k dw_k), with w_k dw_k = B_k · dB_k."""
    h = x.shape[2]
    u = _chunks(x, chunk) * _chunks(dt, chunk)[..., None]  # [B, nc, Q, H, P]
    bh = _per_head(_chunks(b, chunk), h)
    w = torch.exp(cum[..., -1:] - cum)                    # [B, H, nc, Q]
    du = w[..., None] * torch.einsum("bchpn,bcqhn->bhcqp", ds, bh)
    db = w[..., None] * torch.einsum("bchpn,bcqhp->bhcqn", ds, u)
    dw = torch.einsum("bhcqn,bcqhn->bhcq", db, bh)
    return du, db, dcum - dw, dtot + dw.sum(-1)


def _bwd_diag_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                  cb: torch.Tensor, cum: torch.Tensor, du: torch.Tensor,
                  db: torch.Tensor, dc: torch.Tensor, dcum: torch.Tensor,
                  dtot: torch.Tensor, *, chunk: int):
    """Pass 8: the intra-chunk term y = (C Bᵀ ⊙ L) u, then the gradients
    of dt·x and of cum = cumsum(dt·A) → (dx [B, T, H, P] in x's dtype,
    ddt [B, T, H], dA's share of each chunk [B, H, nc], dB and dC per head
    [B, H, nc, Q, N] with this pass's terms added).

    dM = dY uᵀ on k <= q, dCB = dM ⊙ L; du += (C Bᵀ ⊙ L)ᵀ dY, dC += dCB
    B, dB += dCBᵀ C; dcum_q += Σ_k dCB ⊙ C Bᵀ, dcum_k -= Σ_q of it.  With
    R_j = Σ_{q>=j} dcum_q + dtot (total is cum's last entry, which every
    dt of the chunk feeds): ddt = A R + u's share Σ_p du x, dx = dt du,
    dA = Σ_j dt_j R_j."""
    bsz, t, h, p = x.shape
    q = chunk
    xc = _chunks(x, q)                                    # [B, nc, Q, H, P]
    dtc = _chunks(dt, q)                                  # [B, nc, Q, H]
    u = xc * dtc[..., None]
    dyc = _chunks(dy, q)
    bh, ch = (_per_head(_chunks(a, q), h) for a in (b, c))
    cbh = _wide(cb).repeat_interleave(h // cb.shape[2], dim=2)
    cum_h = cum.permute(0, 2, 1, 3)                       # [B, nc, H, Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~keep, float("-inf")))
    dm = torch.einsum("bcqhp,bckhp->bchqk", dyc, u)
    dcb = dm * lmat
    dll = dcb * cbh
    dcum = dcum + (dll.sum(-1) - dll.sum(-2)).permute(0, 2, 1, 3)
    du = du + torch.einsum("bchqk,bcqhp->bhckp", cbh * lmat, dyc)
    dc = dc + torch.einsum("bchqk,bckhn->bhcqn", dcb, bh)
    db = db + torch.einsum("bchqk,bcqhn->bhckn", dcb, ch)
    r = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,)) \
        + dtot[..., None]                                 # [B, H, nc, Q]
    dtc_h = dtc.permute(0, 3, 1, 2)                       # [B, H, nc, Q]
    ddt = _wide(A)[None, :, None, None] * r \
        + (du * xc.permute(0, 3, 1, 2, 4)).sum(-1)
    dx = du * dtc_h[..., None]                            # [B, H, nc, Q, P]
    nc = dx.shape[2]
    dx = dx.permute(0, 2, 3, 1, 4).reshape(bsz, nc * q, h, p)[:, :t]
    ddt = ddt.permute(0, 2, 3, 1).reshape(bsz, nc * q, h)[:, :t]
    return dx.to(x.dtype), ddt, (dtc_h * r).sum(-1), db, dc


def _bwd_reduce_ref(db: torch.Tensor, dc: torch.Tensor, da: torch.Tensor,
                    g: int, t: int):
    """Pass 9: dB, dC per head [B, H, nc, Q, N] → [B, T, G, N] summed over
    each group's heads; dA's shares [B, H, nc] → dA [H]."""
    bsz, h, nc, q, n = db.shape

    def group(a):
        a = a.reshape(bsz, g, h // g, nc, q, n).sum(2)
        return a.permute(0, 2, 3, 1, 4).reshape(bsz, nc * q, g, n)[:, :t]

    return group(db), group(dc), da.sum((0, 2))


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                     chunk: int = 256):
    """The gradient of :func:`ssd_scan_ref` for the output gradient ``dy``
    (x's shape) → (dx, ddt, dA, db, dc), each in its operand's dtype.
    Recomputes cum, C Bᵀ and S_prev (float32), then the five backward
    passes in order."""
    q = min(chunk, x.shape[1])
    g, t = b.shape[2], x.shape[1]
    cum, states = _chunk_state_ref(x, dt, A, b, chunk=q)
    cb = _cb_ref(b, c, chunk=q)
    prev = _state_pass_ref(states, cum)
    dsl, dc, dcum = _bwd_chunk_out_ref(dy, c, cum, prev, chunk=q)
    ds, dtot = _bwd_state_ref(dsl, prev, cum)
    du, db, dcum, dtot = _bwd_state_side_ref(x, dt, b, cum, ds, dcum, dtot,
                                             chunk=q)
    dx, ddt, da, db, dc = _bwd_diag_ref(x, dt, A, b, c, dy, cb, cum, du, db,
                                        dc, dcum, dtot, chunk=q)
    db, dc, da = _bwd_reduce_ref(db, dc, da, g, t)
    return dx, ddt.to(dt.dtype), da.to(A.dtype), db.to(b.dtype), \
        dc.to(c.dtype)


# ---------------------------------------------------------------------------
# The "mma" route's passes: dB and dC once a group
# ---------------------------------------------------------------------------
#
# Two identities drop the per-head dB and dC that the passes above read:
# the inter-chunk term's dcum_q = C_q · dC_q = exp(cum_q) dY_q · (S_prev C_q)
# (dY against y_off), and the chunk state's B_k · dB_k = u_k · du_k with
# du_k = w_k dS B_k.  dB and dC are then sums over a group's heads that
# run inside one product each.

#: (P, N) elements of one block of the "mma" state pass.
STATE_SLICE = 1024
#: Head slices of a group in the "mma" group pass (fewer where a group has
#: fewer heads); their partial dB and dC are summed in slice order.
GROUP_SLICES = 8


def state_slices(p: int, n: int) -> int:
    """Slices of the "mma" state pass for a [P, N] state."""
    return -(-p * n // STATE_SLICE)


def group_slices(h: int, g: int) -> int:
    """Head slices of the "mma" group pass."""
    return min(GROUP_SLICES, h // g)


def _slice_heads(r: int, slices: int, s: int):
    """The heads (within a group of ``r``) of slice ``s``: [s r / S,
    (s + 1) r / S)."""
    return s * r // slices, (s + 1) * r // slices


def _operand(a: torch.Tensor, rounding: str) -> torch.Tensor:
    """A product's float32 operand as the kernel feeds it to the tensor
    cores: ``"exact"`` as it is; ``"split"`` as hi + lo with hi = bf16(a)
    and lo = bf16(a - hi), two bf16 terms (about 16 significant bits);
    ``"single"`` rounded once to bf16."""
    if rounding == "exact":
        return a
    hi = a.to(torch.bfloat16).to(a.dtype)
    if rounding == "single":
        return hi
    if rounding != "split":
        raise ValueError(f"rounding is exact, split or single, got "
                         f"{rounding!r}")
    return hi + (a - hi).to(torch.bfloat16).to(a.dtype)


def _bwd_chunk_out_mma_ref(dy: torch.Tensor, c: torch.Tensor,
                           cum: torch.Tensor, prev: torch.Tensor, *,
                           chunk: int, rounding: str = "exact"):
    """Pass 5 of the "mma" route → (dS_local [B, nc, H, P, N] =
    (exp(cum) ⊙ dY)ᵀ C, dcum [B, H, nc, Q] = exp(cum_q) dY_q · (C_q
    S_prevᵀ)): the inter-chunk term's dcum from dY against y_off, with no
    dC."""
    h = dy.shape[2]
    e = torch.exp(cum).permute(0, 2, 3, 1)[..., None]     # [B, nc, Q, H, 1]
    dyc = _chunks(dy, chunk)                              # [B, nc, Q, H, P]
    ch = _per_head(_chunks(c, chunk), h)                  # [B, nc, Q, H, N]
    dsl = torch.einsum("bcqhp,bcqhn->bchpn", _operand(dyc * e, rounding), ch)
    z = torch.einsum("bcqhn,bchpn->bcqhp", ch,
                     _operand(_wide(prev), rounding))
    dcum = (dyc * z).sum(-1) * e[..., 0]
    return dsl, dcum.permute(0, 3, 1, 2).contiguous()


def _bwd_state_slices_ref(dsl: torch.Tensor, prev: torch.Tensor,
                          cum: torch.Tensor):
    """Pass 6 of the "mma" route: the reverse state pass of
    :func:`_bwd_state_ref`, with Σ G ⊙ S_prev[c] kept in slices of
    ``STATE_SLICE`` (P, N) elements → (dS [B, nc, H, P, N], partial sums
    [B, H, nc, S]; d total's carry share is exp(total_c) times their
    sum)."""
    bsz, nc, h, p, n = dsl.shape
    s = state_slices(p, n)
    decay = torch.exp(cum[..., -1])                       # [B, H, nc]
    g = torch.zeros_like(dsl[:, 0])
    ds, part = [None] * nc, [None] * nc
    for ci in reversed(range(nc)):
        ds[ci] = g
        prod = (g * _wide(prev[:, ci])).reshape(bsz, h, p * n)
        prod = torch.nn.functional.pad(prod, (0, s * STATE_SLICE - p * n))
        part[ci] = prod.reshape(bsz, h, s, STATE_SLICE).sum(-1)
        g = dsl[:, ci] + decay[:, :, ci, None, None] * g
    return torch.stack(ds, dim=1), torch.stack(part, dim=2)


def _bwd_state_side_mma_ref(x: torch.Tensor, dt: torch.Tensor,
                            b: torch.Tensor, cum: torch.Tensor,
                            ds: torch.Tensor, dcum: torch.Tensor,
                            part: torch.Tensor, *, chunk: int,
                            rounding: str = "exact"):
    """Pass 7 of the "mma" route: S_c = Σ_k w_k u_k B_kᵀ → (du [B, H, nc,
    Q, P] = w_k dS B_k, dcum - u_k · du_k, d total = exp(total) Σ part +
    Σ_k u_k · du_k), with u_k · du_k = B_k · dB_k, so no dB."""
    h = x.shape[2]
    xc = _chunks(x, chunk)                                # [B, nc, Q, H, P]
    dtc = _chunks(dt, chunk)                              # [B, nc, Q, H]
    bh = _per_head(_chunks(b, chunk), h)
    w = torch.exp(cum[..., -1:] - cum)                    # [B, H, nc, Q]
    du = w[..., None] * torch.einsum("bchpn,bcqhn->bhcqp",
                                     _operand(ds, rounding), bh)
    dw = dtc.permute(0, 3, 1, 2) * (xc.permute(0, 3, 1, 2, 4) * du).sum(-1)
    dtot = torch.exp(cum[..., -1]) * part.sum(-1) + dw.sum(-1)
    return du, dcum - dw, dtot


def _bwd_diag_mma_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      dy: torch.Tensor, cb: torch.Tensor, cum: torch.Tensor,
                      du: torch.Tensor, dcum: torch.Tensor,
                      dtot: torch.Tensor, *, chunk: int,
                      rounding: str = "exact"):
    """Pass 8 of the "mma" route: the intra-chunk term as in
    :func:`_bwd_diag_ref` with no dB or dC → (dx [B, T, H, P] in x's
    dtype, ddt [B, T, H], dA's share of each chunk [B, H, nc], dCB
    [B, H, nc, Q, Q] = dt_k (dY xᵀ)_qk L_qk, zero above the diagonal)."""
    bsz, t, h, p = x.shape
    q = chunk
    xc = _chunks(x, q)                                    # [B, nc, Q, H, P]
    dtc = _chunks(dt, q)                                  # [B, nc, Q, H]
    dyc = _chunks(dy, q)
    cbh = _wide(cb).repeat_interleave(h // cb.shape[2], dim=2)
    cum_h = cum.permute(0, 2, 1, 3)                       # [B, nc, H, Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~keep, float("-inf")))
    dm = torch.einsum("bcqhp,bckhp->bchqk", dyc, xc) \
        * dtc.permute(0, 1, 3, 2)[..., None, :]
    dcb = dm * lmat
    dll = dcb * cbh
    dcum = dcum + (dll.sum(-1) - dll.sum(-2)).permute(0, 2, 1, 3)
    du = du + torch.einsum("bchqk,bcqhp->bhckp",
                           _operand(cbh * lmat, rounding), dyc)
    r = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,)) \
        + dtot[..., None]                                 # [B, H, nc, Q]
    dtc_h = dtc.permute(0, 3, 1, 2)                       # [B, H, nc, Q]
    ddt = _wide(A)[None, :, None, None] * r \
        + (du * xc.permute(0, 3, 1, 2, 4)).sum(-1)
    dx = du * dtc_h[..., None]                            # [B, H, nc, Q, P]
    nc = dx.shape[2]
    dx = dx.permute(0, 2, 3, 1, 4).reshape(bsz, nc * q, h, p)[:, :t]
    ddt = ddt.permute(0, 2, 3, 1).reshape(bsz, nc * q, h)[:, :t]
    return (dx.to(x.dtype), ddt, (dtc_h * r).sum(-1),
            dcb.permute(0, 2, 1, 3, 4).contiguous())


def _bwd_group_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, dy: torch.Tensor, cum: torch.Tensor,
                   prev: torch.Tensor, ds: torch.Tensor, dcb: torch.Tensor,
                   *, chunk: int, rounding: str = "exact"):
    """Pass 9 of the "mma" route: dB and dC of each group in head slices
    (:func:`group_slices`) → (partial dB, partial dC), each [S, B, nc, G,
    Q, N].  Slice s of group g sums its heads (in order) in

        dC[q] = Σ_h exp(cum_h,q) dY_h,q S_prev,h + (Σ_h dCB_h) B
        dB[k] = Σ_h w_h,k dt_h,k dS_hᵀ x_h,k + (Σ_h dCB_h)ᵀ C."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    r, q = h // g, chunk
    xc, dyc = _chunks(x, q), _chunks(dy, q)               # [B, nc, Q, H, P]
    dtc = _chunks(dt, q)                                  # [B, nc, Q, H]
    bc, cc = _chunks(b, q), _chunks(c, q)                 # [B, nc, Q, G, N]
    nc = xc.shape[1]
    e = torch.exp(cum).permute(0, 2, 3, 1)                # [B, nc, Q, H]
    w = torch.exp(cum[..., -1:] - cum).permute(0, 2, 3, 1)
    dc_h = torch.einsum("bcqhp,bchpn->bcqhn", dyc,
                        _operand(_wide(prev), rounding)) * e[..., None]
    db_h = torch.einsum("bcqhp,bchpn->bcqhn", xc,
                        _operand(ds, rounding)) * (w * dtc)[..., None]
    dc_h = dc_h.reshape(bsz, nc, q, g, r, n)
    db_h = db_h.reshape(bsz, nc, q, g, r, n)
    dcb = dcb.reshape(bsz, g, r, nc, q, q)
    pdb, pdc = [], []
    for s in range(group_slices(h, g)):
        j0, j1 = _slice_heads(r, group_slices(h, g), s)
        dcb_s = _operand(dcb[:, :, j0:j1].sum(2), rounding)  # [B, G, nc, Q, Q]
        pdc.append(dc_h[..., j0:j1, :].sum(4).permute(0, 1, 3, 2, 4)
                   + torch.einsum("bgcqk,bckgn->bcgqn", dcb_s, bc))
        pdb.append(db_h[..., j0:j1, :].sum(4).permute(0, 1, 3, 2, 4)
                   + torch.einsum("bgcqk,bcqgn->bcgkn", dcb_s, cc))
    return torch.stack(pdb), torch.stack(pdc)


def _bwd_reduce_slices_ref(pdb: torch.Tensor, pdc: torch.Tensor,
                           da: torch.Tensor, t: int):
    """Pass 10 of the "mma" route: partial dB, dC [S, B, nc, G, Q, N] →
    [B, T, G, N] summed over the slices; dA's shares [B, H, nc] → dA
    [H]."""
    _, bsz, nc, g, q, n = pdb.shape

    def fold(a):
        a = a.sum(0).permute(0, 1, 3, 2, 4)
        return a.reshape(bsz, nc * q, g, n)[:, :t]

    return fold(pdb), fold(pdc), da.sum((0, 2))


def ssd_scan_bwd_mma_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                         *, chunk: int = 256, rounding: str = "exact"):
    """The gradient of :func:`ssd_scan_ref` by the "mma" route's plain
    passes → (dx, ddt, dA, db, dc), as :func:`ssd_scan_bwd_ref`; with
    ``rounding="split"`` each float32 operand of a product is fed as the
    kernel feeds it."""
    q = min(chunk, x.shape[1])
    t = x.shape[1]
    cum, states = _chunk_state_ref(x, dt, A, b, chunk=q)
    cb = _cb_ref(b, c, chunk=q)
    prev = _state_pass_ref(states, cum)
    dsl, dcum = _bwd_chunk_out_mma_ref(dy, c, cum, prev, chunk=q,
                                       rounding=rounding)
    ds, part = _bwd_state_slices_ref(dsl, prev, cum)
    du, dcum, dtot = _bwd_state_side_mma_ref(x, dt, b, cum, ds, dcum, part,
                                             chunk=q, rounding=rounding)
    dx, ddt, da, dcb = _bwd_diag_mma_ref(x, dt, A, dy, cb, cum, du, dcum,
                                         dtot, chunk=q, rounding=rounding)
    pdb, pdc = _bwd_group_ref(x, dt, b, c, dy, cum, prev, ds, dcb, chunk=q,
                              rounding=rounding)
    db, dc, da = _bwd_reduce_slices_ref(pdb, pdc, da, t)
    return dx, ddt.to(dt.dtype), da.to(A.dtype), db.to(b.dtype), \
        dc.to(c.dtype)
