"""The port's SSD chunked scan (plain version, and the wrapper on CPU
tensors) held against the JAX package's Pallas ``ssd_scan`` (interpret
mode) and its sequential oracle ``ssd_ref``, on identical numpy inputs.

Tolerances: f32 2e-4, bf16 6e-2 — the reference's own SSD kernel
tolerance (``tests/test_kernels.py:74-75``).  The CUDA kernel runs only
on a card: its tests carry the ``cuda`` marker and skip elsewhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_scan as ref_ssd_scan
from repro.kernels.ssd.ref import ssd_ref as ref_oracle
from repro_torch.kernels.ssd import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

#: The reference's ``test_ssd_sweep`` shapes (b, t, h, p, g, n, chunk):
#: two groups, one group, and a ragged tail (T 100, chunk 32) with G = H.
SHAPES = [(1, 64, 4, 16, 2, 32, 16), (2, 48, 2, 8, 1, 16, 16),
          (1, 100, 4, 16, 4, 32, 32)]

# One compile per shape, at XLA's lowest backend optimisation level
# (as in test_torch_rmsnorm.py).
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_ref_scan = _jit(ref_ssd_scan, static_argnames=("chunk", "interpret"))
_ref_oracle = _jit(ref_oracle)


def _tol(name):
    return dict(rtol=6e-2, atol=6e-2) if name == "bf16" \
        else dict(rtol=2e-4, atol=2e-4)


def _inputs(shape, name, seed=0, dt_range=None):
    """(numpy operands for the reference, torch operands for the port),
    the same values: drawn in numpy, rounded once to the working dtype in
    numpy and carried over bit for bit.  dt is softplus of a normal draw,
    as the reference's test draws it, or uniform in ``dt_range``."""
    b, t, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[name]
    x = rng.standard_normal((b, t, h, p)) * 0.5
    dt = (rng.uniform(*dt_range, (b, t, h)) if dt_range
          else np.logaddexp(0.0, rng.standard_normal((b, t, h))))
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb = rng.standard_normal((b, t, g, n)) * 0.3
    cc = rng.standard_normal((b, t, g, n)) * 0.3
    arrs = [v.astype(np.float32).astype(jdt) for v in (x, dt, bb, cc)]
    ts = [torch.from_numpy(v.astype(np.float32)).to(tdt) for v in arrs]
    return ((arrs[0], arrs[1], a, arrs[2], arrs[3]),
            (ts[0], ts[1], torch.from_numpy(a), ts[2], ts[3]))


def _references(jops, shape):
    x, dt, a, bb, cc = jops
    rep = shape[2] // shape[4]
    pallas = _ref_scan(x, dt, a, bb, cc, chunk=shape[-1])
    oracle = _ref_oracle(x, dt, a, np.repeat(bb, rep, axis=2),
                         np.repeat(cc, rep, axis=2))
    return np.asarray(pallas, np.float32), np.asarray(oracle, np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["g2", "g1", "ragged_g4"])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_ssd_matches_reference(shape, name):
    jops, tops = _inputs(shape, name)
    pallas, oracle = _references(jops, shape)
    ops.reset_launch_counts()
    out = ops.ssd_scan(*tops, chunk=shape[-1])
    assert out.dtype == tops[0].dtype and out.shape == tops[0].shape
    assert ops.launch_counts() == {"ssd": 0}        # CPU: plain version
    got = out.float().numpy()
    np.testing.assert_allclose(got, pallas, **_tol(name))
    np.testing.assert_allclose(got, oracle, **_tol(name))
    np.testing.assert_array_equal(
        got, ref.ssd_scan_ref(*tops, chunk=shape[-1]).float().numpy())


def _no_carry(tops, chunk):
    """The scan run on each chunk alone: what y would be if no state
    crossed a chunk boundary."""
    x, dt, a, bb, cc = tops
    return torch.cat([ref.ssd_scan_ref(x[:, i:i + chunk], dt[:, i:i + chunk],
                                       a, bb[:, i:i + chunk],
                                       cc[:, i:i + chunk], chunk=chunk)
                      for i in range(0, x.shape[1], chunk)], dim=1)


def test_carry_across_chunks_matches_reference():
    """dt in Mamba-2's initial range [0.001, 0.1], so the state carried
    from chunk to chunk is a large part of y (softplus of a normal draw
    gives dt near 0.7, and the carry decays to nothing within a chunk)."""
    shape = (1, 100, 4, 16, 2, 32, 32)
    jops, tops = _inputs(shape, "f32", seed=1, dt_range=(1e-3, 0.1))
    pallas, oracle = _references(jops, shape)
    got = ops.ssd_scan(*tops, chunk=32)
    np.testing.assert_allclose(got.numpy(), pallas, **_tol("f32"))
    np.testing.assert_allclose(got.numpy(), oracle, **_tol("f32"))
    carried = (got - _no_carry(tops, 32)).abs().max() / got.abs().max()
    assert carried > 0.2, float(carried)


def _single_pass(x, dt, A, b, c, *, chunk):
    """The plain version as one function, as it stood before it was cut
    into the kernel's passes: the yardstick of the test below."""
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
    dtc = chunks(dt)
    bc, cc = chunks(b), chunks(c)
    cum = torch.cumsum(dtc * A.float(), dim=2)
    total = cum[:, :, -1]
    xdt = xc * dtc.reshape(bsz, nc, q, g, r, 1)
    cum_h = cum.permute(0, 1, 3, 2)
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    keep = torch.ones(q, q, dtype=torch.bool).tril()
    lmat = torch.exp(seg.masked_fill(~keep, float("-inf")))
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    w = cb[:, :, :, None] * lmat.reshape(bsz, nc, g, r, q, q)
    y = torch.einsum("bcgrqk,bckgrp->bcqgrp", w, xdt)
    decay_out = torch.exp(total[:, :, None] - cum)
    xo = xdt * decay_out.reshape(bsz, nc, q, g, r, 1)
    states = torch.einsum("bcqgrp,bcqgn->bcgrpn", xo, bc)
    decay = torch.exp(total).reshape(bsz, nc, g, r, 1, 1)
    s = torch.zeros_like(states[:, 0])
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * decay[:, ci] + states[:, ci]
    prev = torch.stack(prev, dim=1)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cc, prev)
    y = y + y_off * torch.exp(cum).reshape(bsz, nc, q, g, r, 1)
    return y.reshape(bsz, nc * q, h, p)[:, :t].to(x.dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=["g2", "g1", "ragged_g4"])
def test_passes_compose_to_single_pass(shape):
    """The plain passes the card holds each kernel pass against compose to
    the single-pass plain version, in float32 within 1e-6."""
    _, tops = _inputs(shape, "f32", dt_range=(1e-3, 0.1))
    chunk = shape[-1]
    want = _single_pass(*tops, chunk=chunk)
    x, dt, a, bb, cc = tops
    cum, states = ref._chunk_state_ref(x, dt, a, bb, chunk=chunk)
    prev = ref._state_pass_ref(states, cum)
    got = ref._chunk_scan_ref(x, dt, cc, ref._cb_ref(bb, cc, chunk=chunk),
                              cum, prev, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ref.ssd_scan_ref(*tops, chunk=chunk), want,
                               rtol=1e-6, atol=1e-6)


def _bad(case):
    """Operands for the wrapper with one thing wrong (``case``)."""
    x = torch.zeros(2, 16, 4, 8)
    dt, a = torch.zeros(2, 16, 4), torch.zeros(4)
    b = c = torch.zeros(2, 16, 2, 8)
    if case == "x_dtype":
        x = x.half()
    elif case == "bc_dtype":
        b = b.bfloat16()
    elif case == "dt_dtype":
        dt = dt.long()
    elif case == "a_dtype":
        a = a.double()
    elif case == "dt_shape":
        dt = dt[:, :8]
    elif case == "a_shape":
        a = torch.zeros(3)
    elif case == "bc_shape":
        c = torch.zeros(2, 16, 2, 4)
    elif case == "x_rank":
        x = x[0]
    elif case == "groups":
        b = c = torch.zeros(2, 16, 3, 8)
    elif case == "devices":
        x = x.to("meta")
    return (x, dt, a, b, c), 0 if case == "chunk" else 8


@pytest.mark.parametrize("case,match", [
    ("x_dtype", "float32 or bfloat16"), ("bc_dtype", "of one dtype"),
    ("dt_dtype", "dt in float32"), ("a_dtype", "A in float32"),
    ("dt_shape", "do not fit"), ("a_shape", "do not fit"),
    ("bc_shape", r"b, c \[B, T, G, N\]"), ("x_rank", r"x \[B, T, H, P\]"),
    ("groups", "3 groups do not divide 4 heads"),
    ("devices", "lie together"), ("chunk", "chunk >= 1")])
def test_wrapper_rejects_bad_operands(case, match):
    operands, chunk = _bad(case)
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan(*operands, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [
    (2, 1000, 80, 64, 1, 128, 256),       # ragged T at the model's widths
    (2, 512, 80, 64, 2, 128, 256),        # two groups
    (1, 4096, 80, 64, 1, 128, 256)])      # the forward's length
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_kernel_matches_plain_on_card(cuda_device, shape, name):
    """The CUDA kernel against its plain version on the card, with dt in
    [0.001, 0.1] and x, b, c as column slices of one buffer, as the model
    passes them."""
    _, tops = _inputs(shape, name, dt_range=(1e-3, 0.1))
    x, dt, a, bb, cc = (t.to(cuda_device) for t in tops)
    b_, t_, h, p, g, n, chunk = shape
    buf = torch.cat([x.reshape(b_, t_, h * p), bb.reshape(b_, t_, g * n),
                     cc.reshape(b_, t_, g * n)], dim=-1)
    xs = buf[..., :h * p].reshape(b_, t_, h, p)
    bs = buf[..., h * p:h * p + g * n].reshape(b_, t_, g, n)
    cs = buf[..., h * p + g * n:].reshape(b_, t_, g, n)
    ops.reset_launch_counts()
    got = ops.ssd_scan(xs, dt, a, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"ssd": 1}
    want = ref.ssd_scan_ref(x, dt, a, bb, cc, chunk=chunk)
    tol = _tol(name)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, ops.ssd_scan(xs, dt, a, bs, cs, chunk=chunk))


def _sliced(tops, shape, dev):
    """The operands on the card, x, b and c as column slices of one buffer
    as the model passes them, dt in float32."""
    x, dt, a, bb, cc = (t.to(dev) for t in tops)
    b_, t_, h, p, g, n, _ = shape
    buf = torch.cat([x.reshape(b_, t_, h * p), bb.reshape(b_, t_, g * n),
                     cc.reshape(b_, t_, g * n)], dim=-1)
    return (buf[..., :h * p].reshape(b_, t_, h, p), dt.float(), a,
            buf[..., h * p:h * p + g * n].reshape(b_, t_, g, n),
            buf[..., h * p + g * n:].reshape(b_, t_, g, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 4096, 80, 64, 1, 128, 256),       # the forward's shape
    (2, 1000, 80, 64, 1, 128, 256)],      # ragged T
    ids=["forward", "ragged"])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_passes_match_plain_on_card(cuda_device, shape, name):
    """Each of the kernel's four passes against its plain pass on the same
    inputs (the plain passes' outputs feed the next kernel pass), within
    the scan's tolerance — cum and dt by chunk, which are float32 whatever
    x is, within f32's — and the same bits on a second run."""
    _, tops = _inputs(shape, name, dt_range=(1e-3, 0.1))
    x, dt, a, bb, cc = _sliced(tops, shape, cuda_device)
    chunk, tol = shape[-1], _tol(name)

    def same(run, want, **kw):
        got = run()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **kw)
        assert torch.equal(got, run())

    cum, states = ref._chunk_state_ref(x, dt, a, bb, chunk=chunk)
    same(lambda: ops._chunk_state(x, dt, a, bb, chunk=chunk)[0], cum,
         **_tol("f32"))
    dtc = ref._dt_chunks(dt, chunk)
    same(lambda: ops._chunk_state(x, dt, a, bb, chunk=chunk)[1], dtc,
         **_tol("f32"))
    same(lambda: ops._chunk_state(x, dt, a, bb, chunk=chunk)[2], states,
         **tol)
    cb = ref._cb_ref(bb, cc, chunk=chunk)
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=cuda_device).tril()
    same(lambda: ops._cb(bb, cc, chunk=chunk).masked_fill(~keep, 0),
         cb.masked_fill(~keep, 0), **tol)
    prev = ref._state_pass_ref(states, cum)
    same(lambda: ops._state_pass(states, cum, x.dtype), prev, **tol)
    same(lambda: ops._chunk_scan(x, dtc, cc, cb, cum, prev, chunk=chunk),
         ref._chunk_scan_ref(x, dt, cc, cb, cum, prev, chunk=chunk), **tol)
