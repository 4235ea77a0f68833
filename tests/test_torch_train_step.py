"""The port's training path — the loss, every gradient leaf, the
microbatched train step, remat — held against the JAX package at
``get_config("qwen2-0.5b").smoke()`` on the CPU (plain versions of the
kernels, through their ``autograd.Function``s), with the weights carried
across; and each plain backward formula against torch autograd of the
plain forward in float64.

Tolerances:

* float32 parameters: loss rtol 1e-5, each gradient leaf within 1e-4 of
  its largest |g| (float32 sums in another order, over 2 layers).
* bfloat16 parameters: each quantity within max(2e-2, 2 x its rounding
  floor), the floor being how far the reference's own bf16 result lies
  from its float32 twin (the two packages round to bf16 at other places:
  the port's RMSNorm once in float32, its attention probabilities kept in
  float32).
* the train step (float32): loss and grad norm rtol 1e-5; the optimizer's
  first moment (0.1 x the clipped gradient) and second moment within 1e-4
  of the leaf's largest; the updated master weights within 1e-6 where the
  gradient is clearly away from 0 (the first AdamW step moves each weight
  by lr x sign(g), so a gradient within rounding of 0 may step either
  way).
* plain backward formulas against autograd, float64: 1e-10.
* remat on and off: the same bits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as ref_get_config
from repro.launch import steps as RST
from repro.models import model_zoo as RZ
from repro.models import params as RP
from repro_torch.configs import get_config
from repro_torch.core import convert
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rms
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.launch import steps as ST
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P
from repro_torch.tree import flatten

T, B = 32, 4

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_ref_value_and_grad = _jit(jax.value_and_grad(RZ.loss_fn, has_aux=True),
                           static_argnums=1)


@pytest.fixture(scope="module")
def cfgs():
    return (ref_get_config("qwen2-0.5b").smoke(),
            get_config("qwen2-0.5b").smoke())


@pytest.fixture(scope="module")
def ref_params(cfgs):
    return _jit(RZ.init, static_argnums=0)(cfgs[0], jax.random.key(0))


@pytest.fixture(scope="module")
def tokens(cfgs):
    return np.random.default_rng(0).integers(
        0, cfgs[0].vocab, (B, T)).astype(np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_loss_grads(cfg, arrays, tokens, microbatches=1):
    params = convert.tree_from_arrays(arrays, cfg, "cpu")
    loss, grads = ST.loss_and_grads(
        params, cfg, {"tokens": torch.from_numpy(tokens)},
        microbatches=microbatches)
    return float(loss), convert.tree_to_arrays(grads)


def _leaf_rel(got, want):
    """{path: max |got - want| / max |want|} over the reference's tree."""
    out = {}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(np.asarray(g, np.float32) - w).max()
            / max(np.abs(w).max(), 1e-30))
    return out


def test_loss_and_grads_match_reference_f32(cfgs, ref_params, tokens):
    rcfg, cfg = cfgs
    p32 = RP.cast_tree(ref_params, jnp.float32)
    (want_loss, _), want_g = _ref_value_and_grad(
        p32, rcfg, {"tokens": jnp.asarray(tokens)})
    loss, grads = _port_loss_grads(cfg, _np_tree(p32), tokens)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    assert jax.tree.structure(grads) == jax.tree.structure(
        _np_tree(want_g))
    rel = _leaf_rel(grads, want_g)
    assert max(rel.values()) < 1e-4, rel


def test_loss_and_grads_match_reference_bf16(cfgs, ref_params, tokens):
    rcfg, cfg = cfgs
    batch = {"tokens": jnp.asarray(tokens)}
    (want_loss, _), want_g = _ref_value_and_grad(ref_params, rcfg, batch)
    (twin_loss, _), twin_g = _ref_value_and_grad(
        RP.cast_tree(ref_params, jnp.float32), rcfg, batch)
    loss, grads = _port_loss_grads(cfg, _np_tree(ref_params), tokens)
    floor_loss = abs(float(want_loss) - float(twin_loss)) / abs(
        float(twin_loss))
    assert abs(loss - float(want_loss)) / abs(float(want_loss)) <= max(
        2e-2, 2 * floor_loss)
    rel = _leaf_rel(grads, want_g)
    floor = _leaf_rel(jax.tree.map(np.asarray, want_g), twin_g)
    over = {k: (rel[k], floor[k]) for k in rel
            if rel[k] > max(2e-2, 2 * floor[k])}
    assert not over, over


def test_train_step_matches_reference(cfgs, ref_params, tokens):
    """One microbatched (2) step of both packages' ``build_train_step``,
    float32; the reference's on a 1x1 mesh with Auto axes (its debug mesh's
    Explicit axes do not run its sharding constraints on this jax)."""
    rcfg, cfg = cfgs
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    step, (ins, outs), _, ropt = RST.build_train_step(
        rcfg, mesh, seq_len=T, global_batch=B, lr=3e-3, microbatches=2)
    p32 = RP.cast_tree(ref_params, jnp.float32)
    rstate = ropt.init(p32)
    arrays, state_arrays = _np_tree(p32), _np_tree(rstate)
    new_p, new_s, metrics = jax.jit(step, in_shardings=ins,
                                    out_shardings=outs)(
        p32, rstate, {"tokens": jnp.asarray(tokens)})

    step_fn, opt = ST.build_train_step(cfg, seq_len=T, global_batch=B,
                                       lr=3e-3, microbatches=2, device="cpu")
    params = convert.tree_from_arrays(arrays, cfg, "cpu")
    state = convert.opt_state_from_arrays(state_arrays, cfg, "cpu")
    params, state, ours = step_fn(params, state,
                                  {"tokens": torch.from_numpy(tokens)})
    assert float(ours["loss"]) == pytest.approx(float(metrics["loss"]),
                                                rel=1e-5)
    assert float(ours["grad_norm"]) == pytest.approx(
        float(metrics["grad_norm"]), rel=1e-5)
    assert int(state["step"]) == int(new_s["step"]) == 1
    for key in ("m", "v"):
        rel = _leaf_rel(convert.tree_to_arrays(state[key]), new_s[key])
        assert max(rel.values()) < 1e-4, (key, rel)
    got_master = jax.tree.leaves(convert.tree_to_arrays(state["master"]))
    got_p = jax.tree.leaves(convert.tree_to_arrays(params))
    for gm, gp, wm, wp, m in zip(got_master, got_p,
                                 jax.tree.leaves(new_s["master"]),
                                 jax.tree.leaves(new_p),
                                 jax.tree.leaves(new_s["m"])):
        m = np.abs(np.asarray(m))
        clear = m > 1e-2 * m.max()
        np.testing.assert_allclose(gm[clear], np.asarray(wm)[clear],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gp[clear], np.asarray(wp)[clear],
                                   rtol=1e-6, atol=1e-6)


def test_remat_changes_no_bit(cfgs, ref_params, tokens):
    _, cfg = cfgs
    arrays = _np_tree(ref_params)
    assert cfg.remat
    on = _port_loss_grads(cfg, arrays, tokens, microbatches=2)
    off = _port_loss_grads(dataclasses.replace(cfg, remat=False), arrays,
                           tokens, microbatches=2)
    assert on[0] == off[0]
    for a, b in zip(jax.tree.leaves(on[1]), jax.tree.leaves(off[1])):
        np.testing.assert_array_equal(a, b)


def test_frozen_forward_takes_no_remat(cfgs, monkeypatch):
    """Frozen parameters under grad mode: no layer goes through
    ``torch.utils.checkpoint`` and nothing is recorded, the same bits as
    under ``torch.no_grad()`` (the serve and prefill callers)."""
    from repro_torch.models import transformer

    _, cfg = cfgs
    assert cfg.remat
    model = Z.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    calls = []
    plain_checkpoint = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1)
                        or plain_checkpoint(*a, **k))
    with torch.no_grad():
        want = Z.forward(model, cfg, batch)
    got = Z.forward(model, cfg, batch)
    assert not calls and got.grad_fn is None
    assert torch.equal(got, want)
    trainable = Z.build(cfg, P.init_tree(Z.spec(cfg),
                                         torch.Generator().manual_seed(0),
                                         "cpu"), trainable=True)
    assert Z.forward(trainable, cfg, batch).grad_fn is not None
    assert len(calls) == cfg.n_layers


def test_tied_embedding_gets_both_gradients(cfgs, ref_params, tokens):
    """The table's gradient holds the lookup's rows and the unembedding's
    product: tokens the batch never reads still get a gradient."""
    _, cfg = cfgs
    _, grads = _port_loss_grads(cfg, _np_tree(ref_params), tokens)
    g = grads["embed"]["tok"]
    unused = np.setdiff1d(np.arange(cfg.vocab), tokens)
    assert unused.size and np.abs(g[unused]).max() > 0


# ---------------------------------------------------------------------------
# the plain backward formulas and the autograd Functions
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (b, t, h, kv, d, causal, window)
    (2, 9, 4, 2, 8, True, 0), (2, 9, 4, 2, 8, False, 0),
    (1, 13, 6, 3, 16, True, 4), (2, 7, 2, 2, 8, True, 0)]


def _qkv(b, t, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)  # noqa
    return mk(b, t, h, d), mk(b, t, kv, d), mk(b, t, kv, d), mk(b, t, h, d)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_backward_is_the_gradient(case):
    b, t, h, kv, d, causal, window = case
    q, k, v, dout = _qkv(b, t, h, kv, d, torch.float64)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    fa_ref.attention_ref(qa, ka, va, causal=causal, window=window) \
        .backward(dout)
    out, lse = fa_ref.attention_fwd_ref(q, k, v, causal=causal,
                                        window=window)
    scores = torch.einsum("bthd,bshd->bhts", q,
                          k.repeat_interleave(h // kv, 2)) / d ** 0.5
    qpos, kpos = torch.arange(t)[:, None], torch.arange(t)[None, :]
    mask = torch.ones(t, t, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    want_lse = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), -1)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-10)
    got = fa_ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    for g, w in zip(got, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", [(5, 16), (2, 3, 33)])
def test_rmsnorm_plain_backward_is_the_gradient(shape):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape))
    s = torch.from_numpy(rng.standard_normal(shape[-1]))
    g = torch.from_numpy(rng.standard_normal(shape))
    xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
    rms_ref.rmsnorm_ref(xa, sa).backward(g)
    dx, ds = rms_ref.rmsnorm_bwd_ref(x, s, g)
    torch.testing.assert_close(dx, xa.grad, rtol=0, atol=1e-10)
    torch.testing.assert_close(ds, sa.grad, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_function_on_cpu_matches_autograd(case):
    """The wrapper's autograd.Function (plain forward with its log-sum-exp,
    plain backward) against autograd of the plain forward, float32; and
    the same bits when its forward is recomputed under checkpoint."""
    b, t, h, kv, d, causal, window = case
    q, k, v, dout = _qkv(b, t, h, kv, d, torch.float32, seed=2)
    grads = []
    for fn in (lambda *a: fa_ref.attention_ref(*a, causal=causal,
                                               window=window),
               lambda *a: fa.flash_attention(*a, causal=causal,
                                             window=window),
               lambda *a: torch.utils.checkpoint.checkpoint(
                   lambda *x: fa.flash_attention(*x, causal=causal,
                                                 window=window),
                   *a, use_reentrant=False)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(dout)
        grads.append([x.grad for x in xs])
    for g, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads[2], grads[1]):
        assert torch.equal(g, w)
    assert fa.backward_launch_counts() == {"flash_attention_bwd": 0}


def test_rmsnorm_function_on_cpu_matches_autograd():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    got, want = [], []
    for fn, out in ((rms.rmsnorm, got), (rms_ref.rmsnorm_ref, want)):
        xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
        fn(xa, sa).backward(g)
        out += [xa.grad, sa.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert rms.backward_launch_counts() == {"rmsnorm_bwd": 0}


def test_gradient_of_a_step_against_a_cache_raises():
    q, k, v, _ = _qkv(1, 4, 2, 2, 8, torch.float32)
    kk, vv = (torch.cat([x, x], 1) for x in (k, v))
    with pytest.raises(NotImplementedError, match="self-attention only"):
        fa.flash_attention(q.requires_grad_(), kk, vv, causal=True,
                           q_offset=4)
    with pytest.raises(NotImplementedError, match="split route"):
        fa.flash_attention(q, kk, vv, causal=False)
    with torch.no_grad():       # without a gradient the call is served
        assert fa.flash_attention(q, kk, vv, causal=True,
                                  q_offset=4).shape == q.shape


def test_ssm_family_builds_trainable():
    """mamba2 builds trainable (its SSD scan has a backward) with every
    parameter sharing the tree's storage; a family the port does not run
    still raises."""
    cfg = get_config("mamba2-2.7b").smoke()
    tree = P.init_tree(Z.spec(cfg), torch.Generator().manual_seed(0), "cpu")
    Z.check_trainable(cfg)
    frozen = Z.build(cfg, tree)
    assert not any(p.requires_grad for p in frozen.parameters())
    model = Z.build(cfg, tree, trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    flat, _ = flatten(tree)
    assert {p.data_ptr() for p in model.parameters()} == \
        {t.data_ptr() for t in flat}
    moe = dataclasses.replace(cfg, family="moe")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Z.check_trainable(moe)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ST.build_train_step(moe, seq_len=8, global_batch=2, device="cpu")


def test_params_are_frozen_unless_trainable(cfgs):
    _, cfg = cfgs
    frozen = Z.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    tree = convert.tree_from_arrays(convert.tree_to_arrays(frozen), cfg)
    model = Z.build(cfg, tree, trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    # the model's parameters share the tree's storage
    flat, _ = flatten(tree)
    assert {p.data_ptr() for p in model.parameters()} == \
        {t.data_ptr() for t in flat}
