"""The port's flash attention (plain version and wrapper on CPU tensors)
held against the JAX package's Pallas ``flash_attention`` (interpret
mode), its ``attention_ref``, the model's ``_sdpa`` decode mask and the
blockwise XLA attention ``_sdpa_blockwise``.

Tolerances: f32 2e-5, bf16 2e-2 — the reference's own kernel tolerance
(``tests/test_kernels.py:18-20``).  The CUDA kernel runs only on a card:
its tests carry the ``cuda`` marker and skip elsewhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro.models import layers as ref_layers
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(b, t, s, h, kv, d, name, seed=3):
    """Same values for both packages: numpy draws, rounded once to the
    working dtype in numpy and carried over bit for bit."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[name]
    arrs = [rng.standard_normal(shape, np.float32).astype(jdt)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d))]
    ts = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]
    return arrs, ts


# The reference's functions run jitted (one compile per shape, where eager
# dispatch would compile each of their operations on its own), at XLA's
# lowest backend optimisation level, which compiles them several times
# faster; the results agree within the tolerances above all the same.
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_ref_flash = _jit(ref_flash, static_argnames=("causal", "window"))


@functools.partial(_jit, static_argnums=(3, 4))
def _oracle(q, k, v, causal, window):
    """The reference's attention_ref on [B, H, T, D] with repeated kv."""
    g = q.shape[2] // k.shape[2]
    kr = jnp.repeat(k.transpose(0, 2, 1, 3), g, axis=1)
    vr = jnp.repeat(v.transpose(0, 2, 1, 3), g, axis=1)
    return ref_oracle(q.transpose(0, 2, 1, 3), kr, vr, causal=causal,
                      window=window).transpose(0, 2, 1, 3)


@_jit
def _ref_sdpa(q, k, v, mask):
    return ref_layers._sdpa(None, q, k, v, mask)


@_jit
def _ref_blockwise(q, k, v):
    return ref_layers._sdpa_blockwise(None, q, k, v, causal=True, bq=128,
                                      bkv=128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,h,kv,d,name,causal,window", [
    (2, 256, 4, 2, 64, "f32", True, 0),
    (1, 384, 8, 1, 128, "bf16", True, 96),
    (2, 200, 4, 4, 64, "f32", False, 0),                # padded tail
])
def test_flash_matches_reference(b, t, h, kv, d, name, causal, window):
    (qj, kj, vj), (q, k, v) = _qkv(b, t, t, h, kv, d, name)
    want = np.asarray(_ref_flash(qj, kj, vj, causal=causal, window=window),
                      np.float32)
    oracle = np.asarray(_oracle(qj, kj, vj, causal, window), np.float32)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert ops.launch_counts() == {"flash_attention": 0}   # CPU: plain
    np.testing.assert_allclose(out.float().numpy(), want, **_tol(name))
    np.testing.assert_allclose(out.float().numpy(), oracle, **_tol(name))


@pytest.mark.parametrize("length", [0, 5, 40, 63])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_over_cache_prefix_matches_sdpa_mask(length, window):
    """One query token at position ``length`` over the cache prefix
    [0, length] equals the reference model's ``_sdpa`` with its decode
    mask ``kpos <= length`` (and ``kpos > length - window``) over the
    whole cache."""
    b, h, kv, d, s = 4, 14, 2, 64, 64
    (qj, kj, vj), (q, k, v) = _qkv(b, 1, s, h, kv, d, "f32", seed=4)
    kpos = np.arange(s)
    valid = kpos[None, :] <= length
    if window:
        valid = valid & (kpos[None, :] > length - window)
    want = np.asarray(_ref_sdpa(qj, kj, vj, valid[None, None, None]),
                      np.float32)
    n = min(length + 1, s)
    got = ops.flash_attention(q, k[:, :n], v[:, :n], causal=False,
                              window=window, q_offset=length)
    np.testing.assert_allclose(got.numpy(), want, **_tol("f32"))


def test_flash_matches_model_blockwise_path():
    """The reference's blockwise XLA attention (the T ≥ 1024 prefill path
    of its model) and the port's attention agree."""
    (qj, kj, vj), (q, k, v) = _qkv(1, 256, 256, 4, 2, 64, "f32", seed=5)
    blk = _ref_blockwise(qj, kj, vj)
    got = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(blk), **_tol("f32"))


@pytest.mark.parametrize("window", [0, 24])
def test_port_sdpa_matches_reference_and_flash(window):
    """The port's plain ``_sdpa`` with ``causal_mask`` equals the
    reference's, and the flash path computes the same attention."""
    (qj, kj, vj), (q, k, v) = _qkv(2, 40, 40, 4, 2, 64, "f32", seed=6)
    want = np.asarray(_ref_sdpa(qj, kj, vj,
                                ref_layers.causal_mask(40, 40, window)))
    got = layers._sdpa(None, q, k, v, layers.causal_mask(40, 40, window))
    np.testing.assert_allclose(got.numpy(), want, **_tol("f32"))
    flash = ops.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(flash.numpy(), got.numpy(), **_tol("f32"))


def test_flash_wrapper_rejects_bad_operands():
    meta = torch.ones(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.flash_attention(meta, meta, meta)
    cpu = torch.ones(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.flash_attention(cpu, meta, meta)


def test_route_is_a_function_of_dtype_rows_and_head_dim():
    """Below ``MMA_MIN_ROWS`` query rows (decode, short steps) float32 and
    bf16 take the split-over-keys kernel; from there bf16 takes the
    tensor-core kernel and float32 the CUDA-core one.  On CPU tensors no
    kernel runs."""
    bf16, f32 = torch.bfloat16, torch.float32
    for d in ops.HEAD_DIMS:
        for dtype in (bf16, f32):
            for t in (1, 8, ops.MMA_MIN_ROWS - 1):
                assert ops._route(dtype, t, d) == "split"
        for t in (ops.MMA_MIN_ROWS, 64, 2048):
            assert ops._route(bf16, t, d) == "mma"
            assert ops._route(f32, t, d) == "fma"
    ops.reset_route_counts()
    for t in (1, 32):
        q = torch.zeros(1, t, 2, 64, dtype=bf16)
        ops.flash_attention(q, q, q)
    assert ops.route_counts() == {"fma": 0, "mma": 0, "split": 0}


@pytest.mark.parametrize("s", [1, 2, 31, 32, 33, 405, 1024, 2049, 65536])
@pytest.mark.parametrize("b,kv,rows", [(1, 1, 1), (4, 2, 7), (4, 2, 56),
                                       (64, 8, 16), (2, 2, 105)])
def test_splits_tile_the_keys(s, b, kv, rows):
    """The split route's splits cover keys [0, S) with no gap, overlap or
    empty split, stay within the kernel's limits, and depend on the shape
    alone: one split at S = 1, 13 of 32 keys at the serve shape (S 405,
    B 4, KV 2, 7 rows), 16 of 64 at S 1,024."""
    n, per = ops._splits(s, b, kv, rows)
    assert (n, per) == ops._splits(s, b, kv, rows)
    assert 1 <= n <= ops.MAX_SPLITS and per % ops.KEYS_PER_SPLIT == 0
    bounds = [(i * per, min(s, (i + 1) * per)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    units = b * kv * -(-rows // ops.SPLIT_ROWS)
    assert n == 1 or n * units <= ops.SPLIT_BLOCKS
    if s == 1:
        assert n == 1
    if (b, kv, rows) == (4, 2, 7) and s in (405, 1024):
        assert (n, per) == ((13, 32) if s == 405 else (16, 64))


def test_backward_route_is_a_function_of_dtype_and_head_dim():
    """bf16 at a head dim of ``HEAD_DIMS`` takes the tensor-core backward,
    float32 the CUDA-core one; on CPU tensors no kernel runs and no route
    counts."""
    for d in ops.HEAD_DIMS:
        assert ops._bwd_route(torch.bfloat16, d) == "mma"
        assert ops._bwd_route(torch.float32, d) == "fma"
        assert ops.BWD_KERNELS[ops._bwd_route(torch.bfloat16, d)] == (
            "delta", "dkdv", "reduce", "dq")
    ops.reset_backward_route_counts()
    q = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    assert ops.backward_route_counts() == {"fma": 0, "mma": 0}


def _walk_pairs(route, t, d, causal, window):
    """[key, row] masks of the pairs the plan's dK/dV blocks and dQ blocks
    visit, by the kernels' own walk: a dK/dV block of ``keys`` keys takes
    the rows from its first key's diagonal (rounded down to its step) to
    the last row its last key's window reaches; a dQ block of ``rows``
    rows the keys from its first row's window start (rounded down to its
    step) to its last row's diagonal (T == S, q_offset 0)."""
    plan = ops.bwd_plan(route, 1, t, t, 2, 1, d)
    keys, rows = plan["keys"], plan["rows"]
    step = plan["step"] or rows
    kstep = plan["step"] or keys
    dkdv = np.zeros((t, t), bool)
    dq = np.zeros((t, t), bool)
    for k0 in range(0, t, keys):
        k_last = min(t, k0 + keys) - 1
        t_begin = (k0 if causal else 0) // step * step
        t_end = min(t, k_last + window) if window else t
        if t_end > t_begin:
            t_end = t_begin + -(-(t_end - t_begin) // step) * step
            dkdv[k0:k_last + 1, t_begin:t_end] = True
    for t0 in range(0, t, rows):
        last = min(t, t0 + rows) - 1
        k_end = last + 1 if causal else t
        k_begin = max(0, t0 - window + 1) // kstep * kstep if window else 0
        if k_end > k_begin:
            k_end = k_begin + -(-(k_end - k_begin) // kstep) * kstep
            dq[k_begin:k_end, t0:last + 1] = True
    return plan, dkdv, dq


@pytest.mark.parametrize("t", [1000, 80, 16, 1024])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
@pytest.mark.parametrize("route", ops.BWD_ROUTES)
def test_backward_plan_covers_every_key_and_row(route, d, t):
    """The backward's grids cover every key (dK/dV), row (dQ, Delta) and
    reduced column once at ragged T, and the blocks' walks visit every
    pair the causal or windowed mask lets through."""
    b, h, kv = 2, 14, 2
    plan = ops.bwd_plan(route, b, t, t, h, kv, d)
    g = plan["grids"]
    assert tuple(g) == tuple(ops.BWD_KERNELS[route])
    keys, rows = plan["keys"], plan["rows"]
    key_tiles = g["dkdv"][1] if route == "mma" else g["dkdv"][0]
    row_tiles = g["dq"][1] if route == "mma" else g["dq"][0]
    assert (key_tiles - 1) * keys < t <= key_tiles * keys
    assert (row_tiles - 1) * rows < t <= row_tiles * rows
    assert (g["delta"][0] - 1) * 4 < b * t * h <= g["delta"][0] * 4
    if route == "mma":
        assert g["dkdv"][0] == g["dq"][0] == b * h
        assert plan["workspace"] == (b, t, h, d)
        n = b * t * kv * d // 4
        blocks = g["reduce"][0]
        assert (blocks - 1) * ops.BWD_REDUCE_THREADS < n \
            <= blocks * ops.BWD_REDUCE_THREADS
        assert keys % plan["step"] == 0 and rows % plan["step"] == 0
    else:
        assert g["dkdv"][1:] == (kv, b) and g["dq"][1:] == (h, b)
        assert plan["workspace"] is None
    for causal, window in ((True, 0), (True, 40), (False, 0)):
        _, dkdv, dq = _walk_pairs(route, t, d, causal, window)
        key, row = np.arange(t)[:, None], np.arange(t)[None, :]
        seen = np.ones((t, t), bool)
        if causal:
            seen &= key <= row
        if window:
            seen &= key > row - window
        assert not (seen & ~dkdv).any() and not (seen & ~dq).any()


CARD_CASES = [
    # (b, t, s, h, kv, d, causal, window, q_offset, cache_len)
    (4, 1, 1, 14, 2, 64, False, 0, 0, 0),           # decode prefixes
    (4, 1, 129, 14, 2, 64, False, 0, 128, 0),
    (4, 1, 1024, 14, 2, 64, False, 0, 1023, 0),
    (4, 1, 405, 14, 2, 64, False, 0, 404, 1024),    # strided cache view
    (4, 1, 1024, 14, 2, 64, False, 16, 1023, 0),    # window within a split
    (4, 1, ops.KEYS_PER_SPLIT + 1, 14, 2, 64, False, 0,
     ops.KEYS_PER_SPLIT, 0),                        # a last split of 1 key
    (4, 8, 508, 14, 2, 64, True, 0, 500, 1024),     # 8 causal rows, a view
    (4, 1, 1024, 16, 2, 128, False, 0, 1023, 2048),  # D 128 decode, a view
    (4, 8, 508, 16, 2, 128, True, 0, 500, 1024),    # D 128, 8 causal rows
    (4, 1, ops.KEYS_PER_SPLIT + 1, 14, 2, 128, False, 16,
     ops.KEYS_PER_SPLIT, 0),                        # D 128, window, 1 key
    (2, 512, 512, 14, 2, 64, True, 0, 0, 0),        # prefill
    (1, 512, 512, 14, 2, 64, True, 96, 0, 0),       # window
    (2, 200, 200, 8, 2, 128, True, 0, 0, 0),        # D 128 GQA, ragged
    (2, 2048, 2048, 14, 2, 64, True, 0, 0, 0),      # qwen2-0.5b's forward
    (2, 1000, 1000, 14, 2, 64, True, 0, 0, 0),      # ragged rows and keys
    (2, 64, 1024, 14, 2, 64, True, 0, 960, 2048),   # rows at an offset, view
    (2, 512, 512, 16, 2, 128, True, 0, 0, 0),       # D 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_flash_kernel_matches_plain_on_card(case, name, cuda_device):
    """With ``cache_len`` > 0, k and v are the prefix views
    ``cache[:, :s]`` of [b, cache_len, kv, d] buffers, the layout the
    decode step hands the kernel.  Each case takes the route of
    ``ops._route`` (below 16 rows the split route, f32 and bf16 alike); a
    second call gives the same bits."""
    b, t, s, h, kv, d, causal, window, q_offset, cache_len = case
    _, ts = _qkv(b, t, cache_len or s, h, kv, d, name)
    q, k, v = (x.to(cuda_device) for x in ts)
    k, v = k[:, :s], v[:, :s]
    before = ops.launch_counts()["flash_attention"]
    ops.reset_route_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    route = ops._route(q.dtype, t, d)
    assert ops.route_counts() == {"fma": 0, "mma": 0, "split": 0, route: 1}
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(name))
    assert torch.equal(out, ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset))
