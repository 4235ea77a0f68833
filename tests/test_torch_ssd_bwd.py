"""The backward of the port's SSD chunked scan: the plain backward
(``ref.ssd_scan_bwd_ref`` and its five passes, the "fma" route's; the
"mma" route's six in ``ref.ssd_scan_bwd_mma_ref``) against torch autograd
of the plain forward ``ref.ssd_scan_ref``, the wrapper's ``SSDScan`` on
CPU tensors, and — on a card only — the CUDA backward (``ssd_bwd.cu``)
and each pass of both routes against the plain versions.

Tolerances:

* plain backward against autograd, float64: 1e-10 (the same function, its
  sums in another order); the "mma" decomposition against the "fma" one
  and its two dcum identities, float64: 1e-10.
* the "mma" route's operands emulated in float32 (each float32 operand of
  a product fed as hi + lo bf16 terms) against the exact backward
  (float64) on the same bf16 inputs: 1e-5 x max|g| (two bf16 terms keep
  ~16 significant bits).
* ``SSDScan`` on CPU tensors against autograd of the plain forward,
  float32: rtol/atol 1e-5.
* the kernel against the plain backward on the card: the scan's own, f32
  2e-4 and bf16 6e-2, as tol x max|g| + tol x |g| (the form of the other
  backward kernels' checks).

The card tests carry the ``cuda`` marker and skip elsewhere; this file
imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ssd import ops, ref

#: (b, t, h, p, g, n, chunk): one group, two groups, a ragged last chunk,
#: chunks of one step, a chunk longer than T, ragged with two groups.
CASES = [(2, 24, 4, 8, 1, 16, 8), (1, 32, 4, 8, 2, 16, 8),
         (2, 20, 4, 8, 1, 16, 8), (2, 7, 4, 8, 2, 16, 1),
         (1, 5, 2, 3, 1, 5, 16), (1, 30, 6, 4, 3, 8, 16)]
IDS = ["g1", "g2", "ragged", "q1", "chunk_past_t", "ragged_g3"]


def _operands(case, dtype, seed=0):
    """x, dt, A, b, c and the output gradient dy, drawn in numpy: dt in
    Mamba-2's initial range [0.001, 0.1] so the carried state matters."""
    b, t, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)

    x = mk(b, t, h, p, scale=0.5)
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, t, h))).to(dtype)
    a = -torch.exp(mk(h, scale=0.5))
    if dtype != torch.float64:
        dt, a = dt.float(), a.float()
    return x, dt, a, mk(b, t, g, n, scale=0.3), mk(b, t, g, n, scale=0.3), \
        mk(b, t, h, p)


def _autograd(fn, operands, dy):
    leaves = [v.clone().requires_grad_() for v in operands]
    fn(*leaves).backward(dy)
    return [v.grad for v in leaves]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_is_the_gradient(case):
    *operands, dy = _operands(case, torch.float64)
    chunk = case[-1]
    want = _autograd(lambda *a: ref.ssd_scan_ref(*a, chunk=chunk), operands,
                     dy)
    got = ref.ssd_scan_bwd_ref(*operands, dy, chunk=chunk)
    for g, w, v in zip(got, want, operands):
        assert g.dtype == v.dtype and g.shape == v.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


def test_plain_backward_sees_the_carry():
    """The case above with the carry: dropping the state that crosses
    chunk boundaries from the forward moves every gradient far beyond the
    1e-10 the test holds them to."""
    case = (2, 24, 4, 8, 1, 16, 8)
    *operands, dy = _operands(case, torch.float64)

    def no_carry(x, dt, a, b, c):
        return torch.cat([ref.ssd_scan_ref(x[:, i:i + 8], dt[:, i:i + 8], a,
                                           b[:, i:i + 8], c[:, i:i + 8],
                                           chunk=8)
                          for i in range(0, 24, 8)], dim=1)

    got = ref.ssd_scan_bwd_ref(*operands, dy, chunk=8)
    alone = _autograd(no_carry, operands, dy)
    for g, w in zip(got, alone):
        assert float((g - w).abs().max()) > 1e-4 * float(g.abs().max())


@pytest.mark.parametrize(
    "case,route", [(c, "fma") for c in CASES[:4]]
    + [(c, "mma") for c in CASES],
    ids=IDS[:4] + [f"{i}-mma" for i in IDS])
def test_plain_passes_compose_to_the_backward(case, route):
    """fma: the five plain passes, each fed the last one's outputs in the
    kernel's layouts, give ``ssd_scan_bwd_ref``'s gradients bit for bit;
    dS of the last chunk and dtot's carry share there are zero.  mma: the
    route's six plain passes, in float64, give them within 1e-10."""
    if route == "mma":
        *operands, dy = _operands(case, torch.float64)
        q = case[-1]
        x, dt, a, b, c = operands
        cum, states = ref._chunk_state_ref(x, dt, a, b, chunk=q)
        prev = ref._state_pass_ref(states, cum)
        dsl, dcum = ref._bwd_chunk_out_mma_ref(dy, c, cum, prev, chunk=q)
        ds, part = ref._bwd_state_slices_ref(dsl, prev, cum)
        assert part.shape[-1] == ref.state_slices(case[3], case[5])
        assert not ds[:, -1].any() and not part[:, :, -1].any()
        du, dcum, dtot = ref._bwd_state_side_mma_ref(x, dt, b, cum, ds,
                                                     dcum, part, chunk=q)
        dx, ddt, da, dcb = ref._bwd_diag_mma_ref(
            x, dt, a, dy, ref._cb_ref(b, c, chunk=q), cum, du, dcum, dtot,
            chunk=q)
        assert not dcb.triu(1).any()
        pdb, pdc = ref._bwd_group_ref(x, dt, b, c, dy, cum, prev, ds, dcb,
                                      chunk=q)
        assert pdb.shape[0] == ref.group_slices(case[2], case[4])
        db, dc, da = ref._bwd_reduce_slices_ref(pdb, pdc, da, case[1])
        for got, want in zip((dx, ddt, da, db, dc),
                             ref.ssd_scan_bwd_ref(*operands, dy, chunk=q)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
        return
    x, dt, a, b, c, dy = _operands(case, torch.float32)
    q = case[-1]
    cum, states = ref._chunk_state_ref(x, dt, a, b, chunk=q)
    prev = ref._state_pass_ref(states, cum)
    dsl, dc, dcum = ref._bwd_chunk_out_ref(dy, c, cum, prev, chunk=q)
    ds, dtot = ref._bwd_state_ref(dsl, prev, cum)
    assert not ds[:, -1].any() and not dtot[..., -1].any()
    du, db, dcum, dtot = ref._bwd_state_side_ref(x, dt, b, cum, ds, dcum,
                                                 dtot, chunk=q)
    dx, ddt, da, db, dc = ref._bwd_diag_ref(
        x, dt, a, b, c, dy, ref._cb_ref(b, c, chunk=q), cum, du, db, dc, dcum,
        dtot, chunk=q)
    db, dc, da = ref._bwd_reduce_ref(db, dc, da, case[4], case[1])
    for got, want in zip((dx, ddt, da, db, dc),
                         ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, chunk=q)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dcum_identities(case):
    """The two identities by which the "mma" route drops the per-head dB
    and dC, in float64 within 1e-10: the inter-chunk term's dcum_q = C_q ·
    dC_q equals exp(cum_q) dY_q · (C_q S_prevᵀ) (dY against y_off), and the
    chunk state's B_k · dB_k equals u_k · du_k."""
    x, dt, a, b, c, dy = _operands(case, torch.float64)
    q = case[-1]
    cum, states = ref._chunk_state_ref(x, dt, a, b, chunk=q)
    prev = ref._state_pass_ref(states, cum)
    dsl, dc, dcum = ref._bwd_chunk_out_ref(dy, c, cum, prev, chunk=q)
    dsl_m, dcum_m = ref._bwd_chunk_out_mma_ref(dy, c, cum, prev, chunk=q)
    torch.testing.assert_close(dsl_m, dsl, rtol=0, atol=1e-10)
    torch.testing.assert_close(dcum_m, dcum, rtol=0, atol=1e-10)
    if case[1] > q:   # a state enters a later chunk
        assert float(dcum.abs().max()) > 1e-3
    ds, _ = ref._bwd_state_ref(dsl, prev, cum)
    zero = torch.zeros_like(dcum)
    du, db, _, _ = ref._bwd_state_side_ref(x, dt, b, cum, ds, zero,
                                           zero[..., 0], chunk=q)
    h = x.shape[2]
    b_dot_db = torch.einsum("bhcqn,bcqhn->bhcq", db, ref._per_head(
        ref._chunks(b, q), h))
    u = (ref._chunks(x, q) * ref._chunks(dt, q)[..., None]).permute(
        0, 3, 1, 2, 4)
    torch.testing.assert_close((u * du).sum(-1), b_dot_db, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_operands_hold_the_backward(case):
    """The "mma" route's numbers emulated in float32: bf16 inputs (x, b, c,
    dy), each product's float32 operand fed as hi + lo (hi = bf16(v), lo =
    bf16(v - hi)), sums in float32 → within 1e-5 x max|g| of the exact
    backward on the same inputs (float64)."""
    x, dt, a, b, c, dy = _operands(case, torch.float32, seed=3)
    x, b, c, dy = (v.bfloat16().float() for v in (x, b, c, dy))
    q = case[-1]
    want = ref.ssd_scan_bwd_ref(*(v.double() for v in (x, dt, a, b, c, dy)),
                                chunk=q)
    got = ref.ssd_scan_bwd_mma_ref(x, dt, a, b, c, dy, chunk=q,
                                   rounding="split")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


def test_operand_rounding():
    """hi + lo keeps a float32 value within 2^-16 of itself; one bf16
    rounding within 2^-8; an unknown rounding raises."""
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(4096)
                         ).float()
    split = ref._operand(v, "split")
    single = ref._operand(v, "single")
    assert torch.equal(ref._operand(v, "exact"), v)
    assert float(((split - v) / v).abs().max()) <= 2.0 ** -16
    assert float(((single - v) / v).abs().max()) <= 2.0 ** -8
    assert float((single - v).abs().max()) > 100 * float(
        (split - v).abs().max())
    with pytest.raises(ValueError, match="exact, split or single"):
        ref._operand(v, "half")


@pytest.mark.parametrize("h,g,want", [(80, 1, 8), (4, 1, 4), (6, 3, 2),
                                      (80, 2, 8), (12, 1, 8)])
def test_group_slices_cover_each_head_once(h, g, want):
    """The group pass's head slices of a group: at most ``GROUP_SLICES``,
    each non-empty, together every head of the group once and in order."""
    r = h // g
    s = ref.group_slices(h, g)
    assert s == want
    heads = [j for k in range(s) for j in range(*ref._slice_heads(r, s, k))]
    assert heads == list(range(r))
    assert all(ref._slice_heads(r, s, k)[1] > ref._slice_heads(r, s, k)[0]
               for k in range(s))


def test_routes_and_workspaces():
    """bf16 takes "mma", float32 "fma"; the mma route's scratch has no
    per-head [B, H, nc, Q, N] buffer (the fma route's dB and dC per head),
    and its dCB tiles are 104,857,600 bytes at mamba2-2.7b's training
    shape; the tiles round-trip to dCB's lower triangle."""
    assert ops._bwd_route(torch.bfloat16) == "mma"
    assert ops._bwd_route(torch.float32) == "fma"
    shape = (2, 1024, 80, 64, 1, 128, 256)
    mma = ops.bwd_workspace("mma", *shape)
    fma = ops.bwd_workspace("fma", *shape)
    per_head = (2, 80, 4, 256, 128)
    assert per_head not in mma.values()
    assert fma["dbh"] == fma["dch"] == per_head
    assert 4 * np.prod(mma["dcbw"]) == 104_857_600
    assert mma["ptot"] == (2, 80, 4, 8) and mma["pdb"] == (8, 2, 4, 1, 256,
                                                            128)
    dcb = torch.randn(1, 2, 3, 130, 130).tril()
    tiles = ops._tiles(dcb)
    assert tiles.shape == (1, 2, 3, 6, 64, 64)
    assert torch.equal(ops._untiles(tiles, 130), dcb)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_on_cpu_matches_autograd(case):
    """``ssd_scan`` with operands that require grad goes through
    ``SSDScan`` (plain forward, plain backward) and gives autograd's
    gradients of the plain forward in float32; under
    ``torch.utils.checkpoint`` the same bits; no launch counted."""
    *operands, dy = _operands(case, torch.float32, seed=1)
    chunk = case[-1]
    ops.reset_launch_counts()
    ops.reset_backward_launch_counts()
    want = _autograd(lambda *a: ref.ssd_scan_ref(*a, chunk=chunk), operands,
                     dy)
    got = _autograd(lambda *a: ops.ssd_scan(*a, chunk=chunk), operands, dy)
    again = _autograd(lambda *a: checkpoint(
        lambda *v: ops.ssd_scan(*v, chunk=chunk), *a, use_reentrant=False),
        operands, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    assert ops.launch_counts() == {"ssd": 0}
    assert ops.backward_launch_counts() == {"ssd_bwd": 0}
    assert ops.backward_route_counts() == {"fma": 0, "mma": 0}


def test_function_only_where_a_gradient_is_needed():
    *operands, _ = _operands(CASES[0], torch.float32)
    assert ops.ssd_scan(*operands, chunk=8).grad_fn is None
    with torch.no_grad():
        x = operands[0].clone().requires_grad_()
        assert ops.ssd_scan(x, *operands[1:], chunk=8).grad_fn is None
    b = operands[3].clone().requires_grad_()
    y = ops.ssd_scan(*operands[:3], b, operands[4], chunk=8)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"


def test_bf16_gradients_keep_their_dtypes():
    """bf16 x, b and c (and dt) get gradients in their own dtypes, within
    bf16 rounding of the float32 gradients."""
    x, dt, a, b, c, dy = _operands(CASES[2], torch.float32, seed=2)
    want = ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, chunk=8)
    low = [v.bfloat16() for v in (x, dt, b, c, dy)]
    got = ops.ssd_scan_bwd(low[0], low[1], a, low[2], low[3], low[4], chunk=8)
    for g, w, v in zip(got, want, (low[0], low[1], a, low[2], low[3])):
        assert g.dtype == v.dtype
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= 6e-2 * scale


def _bad(case):
    """Backward operands with one thing wrong (``case``)."""
    x = torch.zeros(2, 16, 4, 8)
    dt, a = torch.zeros(2, 16, 4), torch.zeros(4)
    b = c = torch.zeros(2, 16, 2, 8)
    dy = torch.zeros(2, 16, 4, 8)
    if case == "dy_shape":
        dy = dy[:, :8]
    elif case == "x_dtype":
        x = x.half()
    elif case == "groups":
        b = c = torch.zeros(2, 16, 3, 8)
    elif case == "devices":
        dy = dy.to("meta")
    elif case == "a_shape":
        a = torch.zeros(3)
    return (x, dt, a, b, c, dy), 0 if case == "chunk" else 8


@pytest.mark.parametrize("case,match", [
    ("dy_shape", "dy of x's shape"), ("x_dtype", "float32 or bfloat16"),
    ("groups", "3 groups do not divide 4 heads"), ("a_shape", "do not fit"),
    ("devices", "lie together"), ("chunk", "chunk >= 1")])
def test_backward_rejects_bad_operands(case, match):
    operands, chunk = _bad(case)
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan_bwd(*operands, chunk=chunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only there")
    return torch.device("cuda")


def _on_card(case, dtype, dev, seed=0):
    """Operands on the card, x, b and c as column slices of one buffer as
    the model passes them, dt and A in float32."""
    x, dt, a, b, c, dy = _operands(case, torch.float32, seed)
    bsz, t, h, p, g, n, _ = case
    buf = torch.cat([x.reshape(bsz, t, h * p), b.reshape(bsz, t, g * n),
                     c.reshape(bsz, t, g * n)], dim=-1).to(dev, dtype)
    return (buf[..., :h * p].reshape(bsz, t, h, p), dt.to(dev), a.to(dev),
            buf[..., h * p:h * p + g * n].reshape(bsz, t, g, n),
            buf[..., h * p + g * n:].reshape(bsz, t, g, n),
            dy.to(dev, dtype))


def _held(got, want, tol):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert float(((g - w).abs() - tol * w.abs().amax()
                  - tol * w.abs()).max()) <= 0


CARD_CASES = CASES + [(2, 1024, 80, 64, 1, 128, 256),   # the training shape
                      (2, 1000, 80, 64, 1, 128, 256),   # ragged T
                      (2, 512, 80, 64, 2, 128, 256)]    # two groups


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_kernel_matches_plain_on_card(cuda_device, case, name):
    dtype = torch.float32 if name == "f32" else torch.bfloat16
    tol = 2e-4 if name == "f32" else 6e-2
    operands = _on_card(case, dtype, cuda_device)
    ops.reset_backward_launch_counts()
    ops.reset_backward_route_counts()
    got = ops.ssd_scan_bwd(*operands, chunk=case[-1])
    torch.cuda.synchronize()
    assert ops.backward_launch_counts() == {"ssd_bwd": 1}
    route = "fma" if name == "f32" else "mma"
    assert ops.backward_route_counts() == {"fma": int(route == "fma"),
                                           "mma": int(route == "mma")}
    want = ref.ssd_scan_bwd_ref(*operands, chunk=case[-1])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _held(g, w, tol)
    again = ops.ssd_scan_bwd(*operands, chunk=case[-1])
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES[-3:] + [CASES[2], CASES[5]])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_passes_match_plain_on_card(cuda_device, case, name):
    """Each backward pass of the dtype's route (f32 "fma", bf16 "mma")
    against its plain pass, fed the plain passes' outputs, and the same
    bits on a second run."""
    dtype = torch.float32 if name == "f32" else torch.bfloat16
    tol = 2e-4 if name == "f32" else 6e-2
    x, dt, a, b, c, dy = _on_card(case, dtype, cuda_device)
    q = min(case[-1], case[1])
    cum, states = ref._chunk_state_ref(x, dt, a, b, chunk=q)
    cb = ref._cb_ref(b, c, chunk=q)
    prev = ref._state_pass_ref(states, cum)
    dtc = ref._dt_chunks(dt, q)

    def same(run, want):
        got = run()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _held(g, w, tol)
        assert all(torch.equal(u, v) for u, v in zip(got, run()))

    if name == "bf16":
        want = ref._bwd_chunk_out_mma_ref(dy, c, cum, prev, chunk=q)
        same(lambda: ops._bwd_chunk_out_mma(dy, c, cum, prev, chunk=q), want)
        dsl, dcum = want
        want = ref._bwd_state_slices_ref(dsl, prev, cum)
        same(lambda: ops._bwd_state_slices(dsl, prev, cum), want)
        ds, part = want
        want = ref._bwd_state_side_mma_ref(x, dt, b, cum, ds, dcum, part,
                                           chunk=q)
        same(lambda: ops._bwd_state_side_mma(x, dtc, b, cum, ds, dcum, part,
                                             chunk=q), want)
        du, dcum, dtot = want
        want = ref._bwd_diag_mma_ref(x, dt, a, dy, cb, cum, du, dcum, dtot,
                                     chunk=q)
        same(lambda: ops._bwd_diag_mma(x, dtc, a, b, dy, cb, cum, du, dcum,
                                       dtot, chunk=q), want)
        _, _, da, dcb = want
        want = ref._bwd_group_ref(x, dt, b, c, dy, cum, prev, ds, dcb,
                                  chunk=q)
        same(lambda: ops._bwd_group(x, dtc, b, c, dy, cum, prev, ds, dcb,
                                    chunk=q), want)
        pdb, pdc = want
        same(lambda: ops._bwd_reduce_slices(pdb, pdc, da, case[1], dtype),
             ref._bwd_reduce_slices_ref(pdb, pdc, da, case[1]))
        return
    want = ref._bwd_chunk_out_ref(dy, c, cum, prev, chunk=q)
    same(lambda: ops._bwd_chunk_out(dy, c, cum, prev, chunk=q), want)
    dsl, dc, dcum = want
    want = ref._bwd_state_ref(dsl, prev, cum)
    same(lambda: ops._bwd_state(dsl, prev, cum), want)
    ds, dtot = want
    want = ref._bwd_state_side_ref(x, dt, b, cum, ds, dcum, dtot, chunk=q)
    same(lambda: ops._bwd_state_side(x, dtc, b, cum, ds, dcum, dtot,
                                     chunk=q), want)
    du, db, dcum, dtot = want
    want = ref._bwd_diag_ref(x, dt, a, b, c, dy, cb, cum, du, db, dc, dcum,
                             dtot, chunk=q)
    same(lambda: ops._bwd_diag(x, dtc, a, b, c, dy, cb, cum, du, db, dc,
                               dcum, dtot, chunk=q), want)
    _, _, da, db, dc = want
    same(lambda: ops._bwd_reduce(db, dc, da, case[4], case[1], dtype),
         ref._bwd_reduce_ref(db, dc, da, case[4], case[1]))


@pytest.mark.cuda
def test_mamba2_step_on_card(cuda_device):
    """Two layers of mamba2-2.7b at full width, B 4, T 300 (a ragged last
    chunk), 2 microbatches: the kernels' loss and gradient leaves against
    the plain versions within max(2e-2, 2 x the floor of the plain bf16
    step against its float32 twin), with exact launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.launch import steps as ST
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = P.init_tree(Z.spec(cfg), gen, cuda_device)
    batch = Z.make_batch(cfg, seq_len=300, global_batch=4, generator=gen,
                         device=cuda_device)
    for mod in (ops, rms):
        mod.reset_launch_counts()
        mod.reset_backward_launch_counts()
    loss_k, g_k = ST.loss_and_grads(params, cfg, batch, microbatches=2,
                                    backend="cuda")
    torch.cuda.synchronize()
    m, n_layers = 2, cfg.n_layers
    assert ops.launch_counts() == {"ssd": 2 * n_layers * m}
    assert ops.backward_launch_counts() == {"ssd_bwd": n_layers * m}
    assert rms.launch_counts() == {"rmsnorm": (4 * n_layers + 1) * m}
    assert rms.backward_launch_counts() == {"rmsnorm_bwd":
                                            (2 * n_layers + 1) * m}
    loss_t, g_t = ST.loss_and_grads(params, cfg, batch, microbatches=2,
                                    backend="torch")
    loss_f, g_f = ST.loss_and_grads(tree_map(lambda p: p.float(), params),
                                    cfg, batch, microbatches=2,
                                    backend="torch")

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))

    floor = abs(float(loss_t) - float(loss_f)) / abs(float(loss_f))
    assert rel(loss_k, loss_t) <= max(2e-2, 2 * floor)
    for k, t, f in zip(leaves(g_k), leaves(g_t), leaves(g_f)):
        assert torch.isfinite(k).all()
        assert rel(k, t) <= max(2e-2, 2 * rel(t, f))
