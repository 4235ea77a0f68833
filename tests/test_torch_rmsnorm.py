"""The port's RMSNorm (plain version and wrapper on CPU tensors) held
against the JAX package's Pallas ``rmsnorm`` (interpret mode) and its
``rmsnorm_ref``, and the port's ``apply_norm`` against the reference's.

Tolerances: f32 2e-5, bf16 2e-2 — the reference's own kernel tolerance
(``tests/test_kernels.py:18-20``).  The CUDA kernel runs only on a card:
its test carries the ``cuda`` marker and skips elsewhere.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.rmsnorm import rmsnorm as ref_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as ref_rmsnorm_ref
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.kernels.rmsnorm import ops, ref
from repro_torch.models import layers

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(shape, name, seed=0):
    """Same values for both packages: drawn in numpy, rounded once to the
    working dtype in numpy and carried over bit for bit."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[name]
    xj = rng.standard_normal(shape, np.float32).astype(jdt)
    sj = rng.standard_normal(shape[-1:], np.float32)
    xt = torch.from_numpy(xj.astype(np.float32)).to(tdt)
    return xj, sj, xt, torch.from_numpy(sj)


# The reference's functions run jitted (one compile per shape, where eager
# dispatch would compile each of their operations on its own), at XLA's
# lowest backend optimisation level, which compiles them several times
# faster; the results agree within the tolerances above all the same.
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_ref_rmsnorm = _jit(ref_rmsnorm)
_ref_rmsnorm_ref = _jit(ref_rmsnorm_ref)
_ref_apply_norm = _jit(ref_layers.apply_norm, static_argnums=1)
_ref_rmsnorm_vjp = _jit(
    lambda x, s, g: jax.vjp(ref_rmsnorm_ref, x, s)[1](g))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 256), (1, 37, 512)])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rmsnorm_matches_reference(shape, name):
    xj, sj, xt, st = _inputs(shape, name)
    pallas = np.asarray(_ref_rmsnorm(xj, sj), np.float32)
    oracle = np.asarray(_ref_rmsnorm_ref(xj, sj), np.float32)
    ops.reset_launch_counts()
    out = ops.rmsnorm(xt, st)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    assert ops.launch_counts() == {"rmsnorm": 0}      # CPU: plain version
    got = out.float().numpy()
    np.testing.assert_allclose(got, pallas, **_tol(name))
    np.testing.assert_allclose(got, oracle, **_tol(name))
    np.testing.assert_array_equal(got, ref.rmsnorm_ref(xt, st).float().numpy())


@pytest.mark.parametrize("norm", ["rms", "ln"])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_apply_norm_matches_reference(norm, name):
    rcfg = ref_get_config("qwen2-0.5b").smoke()
    cfg = get_config("qwen2-0.5b").smoke()
    if norm == "ln":
        rcfg = dataclasses.replace(rcfg, norm="ln")
        cfg = dataclasses.replace(cfg, norm="ln")
    xj, sj, xt, st = _inputs((2, 5, cfg.d_model), name, seed=1)
    rng = np.random.default_rng(2)
    bias = rng.standard_normal(cfg.d_model, np.float32)
    pj = {"scale": sj, "bias": bias}
    pt = {"scale": st, "bias": torch.from_numpy(bias)}
    want = np.asarray(_ref_apply_norm(pj, rcfg, xj), np.float32)
    got = layers.apply_norm(pt, cfg, xt, backend="torch")
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(name))


def test_rmsnorm_wrapper_rejects_bad_operands():
    meta = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.rmsnorm(meta, torch.ones(8, device="meta"))


PLAN_DIMS = (1, 7, 8, 100, 896, 1000, 1001, 2560, 5120, 8192)


def _row_slots(plan, d):
    """The vector index that each (thread, item) of one row loads, as the
    kernel computes it: thread t of the row, item i → t + i·threads_a_row;
    slots past the row's vectors load nothing."""
    per_row = plan.threads // plan.rows
    t = np.arange(per_row)[:, None]
    i = np.arange(plan.items)[None, :]
    slots = (t + i * per_row).ravel()
    return slots[slots < d // plan.vec]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("d", PLAN_DIMS)
def test_plan_covers_each_element_once(d, name, aligned):
    dtype = DTYPES[name][1]
    plan = ops._plan(dtype, d, aligned)
    assert plan == ops._plan(dtype, d, aligned)
    assert plan.route in ops.ROUTES
    assert d % plan.vec == 0 and plan.vec * plan.items == ops.ELEMS_PER_THREAD
    assert plan.vec * torch.empty(0, dtype=dtype).element_size() in (2, 4, 16)
    per_row = plan.threads // plan.rows
    assert per_row % 32 == 0 and plan.threads <= 256
    # every vector of the row once, so every element once
    np.testing.assert_array_equal(np.sort(_row_slots(plan, d)),
                                  np.arange(d // plan.vec))
    assert per_row * plan.items * plan.vec >= d
    if plan.route == "warp":
        assert d <= ops.WARP_MAX_D and per_row == 32
        assert plan.rows == ops.WARP_ROWS
    else:
        assert d > ops.WARP_MAX_D and plan.rows == 1
        assert per_row == 32 * -(-d // ops.WARP_MAX_D)    # sized from D
    if not aligned:
        assert plan.vec == 1


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("d, route", [(896, "warp"), (2560, "block"),
                                      (5120, "block")])
def test_plan_routes_main_path_rows_in_vectors(d, route, name):
    dtype = DTYPES[name][1]
    plan = ops._plan(dtype, d, True)
    assert plan.route == route
    assert plan.vec == (8 if name == "bf16" else 4)       # 16 bytes
    assert ops._plan(dtype, d, False).vec == 1            # unaligned
    assert ops._plan(dtype, d, False).route == route


@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 256), (2, 1001)])
def test_plain_backward_matches_jax_vjp(shape):
    """The plain backward (and the wrapper on CPU tensors, which takes it)
    against ``jax.vjp`` of the reference's ``rmsnorm_ref``, float32, rtol
    1e-5 (atol 1e-6 for the dx entries that cancel to near zero)."""
    rng = np.random.default_rng(5)
    x, g = (rng.standard_normal(shape, np.float32) for _ in range(2))
    s = rng.standard_normal(shape[-1:], np.float32)
    wdx, wds = (np.asarray(a) for a in _ref_rmsnorm_vjp(x, s, g))
    xt, st, gt = (torch.from_numpy(a) for a in (x, s, g))
    ops.reset_backward_launch_counts()
    for dx, ds in (ref.rmsnorm_bwd_ref(xt, st, gt), ops.rmsnorm_bwd(xt, st, gt)):
        assert dx.dtype == ds.dtype == torch.float32
        np.testing.assert_allclose(dx.numpy(), wdx, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ds.numpy(), wds, rtol=1e-5, atol=1e-6)
    assert ops.backward_launch_counts() == {"rmsnorm_bwd": 0}


def _bwd_rows(plan, n):
    """The row that each (block, warp, pass) of the backward serves, as the
    kernels compute it: warp route row b·8 + w + k·8·blocks, block route
    row b + k·blocks; rows past n are none."""
    warps = ops.BWD_WARP_ROWS if plan.route == "warp" else 1
    stride = plan.blocks * warps
    first = np.arange(stride)                      # b·warps + w
    rows = (first[:, None] + stride * np.arange(-(-n // stride))).ravel()
    return rows[rows < n]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("d", [896, 1001, 2560, 5120])
def test_bwd_plan_covers_each_element_once(d, name, aligned):
    """Every element of every row once over (block, warp, lane, vector);
    the partial rows of dscale, their number and the order in which each
    row is given to them a function of the shape alone, capped by a
    constant; the dscale launch over each column and each partial row
    once."""
    dtype = DTYPES[name][1]
    for n in (1, 5, 4095, 4096, 20000):
        plan = ops.bwd_plan(dtype, n, d, aligned)
        fwd = ops._plan(dtype, d, aligned)
        assert (plan.route, plan.vec, plan.items) == (fwd.route, fwd.vec,
                                                      fwd.items)
        assert {ops.bwd_plan(dt, n, d, al).blocks
                for dt in (torch.float32, torch.bfloat16)
                for al in (True, False)} == {plan.blocks}
        np.testing.assert_array_equal(np.sort(_bwd_rows(plan, n)),
                                      np.arange(n))
        if plan.route == "warp":
            assert plan.threads == 32 * ops.BWD_WARP_ROWS
            cap, want = ops.BWD_WARP_BLOCKS, -(-n // ops.BWD_WARP_ROWS)
            per_row = 32
        else:
            assert plan.threads == fwd.threads
            cap, want = ops.BWD_BLOCK_WARPS // (plan.threads // 32), n
            per_row = plan.threads
        assert plan.blocks == min(want, cap)
        # each element of a row: thread t, item i, element e of vector
        # t + i·per_row
        t, i, e = np.meshgrid(np.arange(per_row), np.arange(plan.items),
                              np.arange(plan.vec), indexing="ij")
        vec = t + i * per_row
        elems = (vec * plan.vec + e)[vec < d // plan.vec]
        np.testing.assert_array_equal(np.sort(elems), np.arange(d))
        # dscale: block c of 32 columns, warp w adding partial rows w, w +
        # BWD_REDUCE_WARPS, ...
        cols = np.arange(plan.reduce_blocks * 32)
        assert plan.reduce_blocks == -(-d // 32) and (cols < d).sum() == d
        w = ops.BWD_REDUCE_WARPS
        parts = (np.arange(w)[:, None] + w * np.arange(-(-plan.blocks // w))
                 ).ravel()
        np.testing.assert_array_equal(np.sort(parts[parts < plan.blocks]),
                                      np.arange(plan.blocks))
    if not aligned:
        assert plan.vec == 1
    assert plan == ops.bwd_plan(dtype, n, d, aligned)


# (shape, storage offset in elements): every route, width and instance
CARD_CASES = [
    ((4, 896), 0),        # warp route, vectors (qwen2 decode)
    ((4096, 896), 0),     # warp route, vectors (qwen2 forward)
    ((4097, 896), 0),     # rows not a multiple of the rows a block
    ((1, 896), 0),        # one row
    ((5, 1001), 0),       # warp route, one element an access
    ((64, 896), 1),       # x misaligned by one element: one element
    ((4, 5120), 0),       # block route, vectors (mamba2 gated decode)
    ((8192, 2560), 0),    # block route, vectors (mamba2 forward)
    ((3, 5121), 0),       # block route, one element an access
    ((3, 8192), 0),       # the widest row
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, offset", CARD_CASES)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rmsnorm_kernel_matches_plain_on_card(shape, offset, name,
                                              cuda_device):
    _, _, xt, st = _inputs(shape, name)
    s = st.to(cuda_device)
    x = xt.to(cuda_device)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=x.dtype,
                          device=cuda_device)
        x = buf[offset:].view(shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    before = ops.launch_counts()["rmsnorm"]
    out = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.rmsnorm_ref(x, s).float().cpu().numpy(),
                               **_tol(name))
    again = ops.rmsnorm(x, s)
    assert torch.equal(out, again)          # fixed reduction order
