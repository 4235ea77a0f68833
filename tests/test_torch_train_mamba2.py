"""The port's mamba2 training path — the loss, every gradient leaf, the
microbatched train step, remat, the trainer — held against the JAX
package at ``get_config("mamba2-2.7b").smoke()`` on the CPU (the plain
versions of the kernels), with the weights carried across.  The SSM's
leaves are redrawn as in ``test_torch_mamba2.py`` so that the scan and
its carry move the loss (the reference's init makes them vanish).  The
smoke config has one SSM group, where the two packages' readings of B
agree (ROADMAP.md, Queue C).

Tolerances:

* float32 parameters: loss rtol 1e-5, each gradient leaf within 1e-4 of
  its largest |g| (float32 sums in another order, over 2 layers).
* bfloat16 parameters: the loss within max(2e-2, 2 x its rounding floor)
  of the reference's bf16 loss, the floor being how far the reference's
  own bf16 result lies from its float32 twin; each gradient leaf within
  max(2e-2, 2 x its floor) of the float32 twin's leaf — the port's bf16
  rounding at most twice the reference's.  Beyond that, each leaf within
  max(2e-2, 3 x its floor) of the reference's bf16 leaf (the triangle
  inequality's bound): the two packages round at other places, so their
  bf16 errors add — ``dt_bias``'s leaf lies 2.2e-2 from the reference's
  bf16 leaf, 1.6e-2 from the float32 twin, the reference's own 0.8e-2.
  The reference's pre-norm rounds its inverse to bf16 before it scales x
  where the port's RMSNorm casts once; with that rounding mirrored in the
  port, every leaf lies within max(2e-2, 2 x its floor) of the
  reference's bf16 leaf (``dt_bias`` 1.2e-2), which is held too.
* the train step (float32): loss and grad norm rtol 1e-5; the optimizer's
  moments within 1e-4 of the leaf's largest; the updated master weights
  within 1e-6 where the gradient is clearly away from 0 (the first AdamW
  step moves each weight by lr x sign(g)).
* remat on and off, and a replay after a failure: the same bits.
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
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P
from test_torch_mamba2 import _live
from test_torch_train_step import _leaf_rel, _np_tree

T, B = 24, 4       # three chunks of the smoke config's 8

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
_ref_value_and_grad = _jit(jax.value_and_grad(RZ.loss_fn, has_aux=True),
                           static_argnums=1)


@pytest.fixture(scope="module")
def cfgs():
    return (ref_get_config("mamba2-2.7b").smoke(),
            get_config("mamba2-2.7b").smoke())


@pytest.fixture(scope="module")
def ref_params(cfgs):
    return _live(_jit(RZ.init, static_argnums=0)(cfgs[0], jax.random.key(0)),
                 cfgs[0])


@pytest.fixture(scope="module")
def tokens(cfgs):
    return np.random.default_rng(0).integers(
        0, cfgs[0].vocab, (B, T)).astype(np.int32)


def _port_loss_grads(cfg, arrays, tokens, microbatches=1):
    params = convert.tree_from_arrays(arrays, cfg, "cpu")
    loss, grads = ST.loss_and_grads(
        params, cfg, {"tokens": torch.from_numpy(tokens)},
        microbatches=microbatches)
    return float(loss), convert.tree_to_arrays(grads)


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
    # every SSM leaf takes a gradient
    for key in ("A_log", "D", "dt_bias", "conv_w", "in_proj", "gate_norm"):
        assert np.abs(grads["layers"][key]).max() > 0, key


@pytest.fixture(scope="module")
def ref_bf16(cfgs, ref_params, tokens):
    """The reference's bf16 loss and gradients and its float32 twin's."""
    rcfg, _ = cfgs
    batch = {"tokens": jnp.asarray(tokens)}
    (want_loss, _), want_g = _ref_value_and_grad(ref_params, rcfg, batch)
    (twin_loss, _), twin_g = _ref_value_and_grad(
        RP.cast_tree(ref_params, jnp.float32), rcfg, batch)
    return (float(want_loss), jax.tree.map(np.asarray, want_g),
            float(twin_loss), twin_g)


def test_loss_and_grads_match_reference_bf16(cfgs, ref_params, tokens,
                                             ref_bf16):
    _, cfg = cfgs
    want_loss, want_g, twin_loss, twin_g = ref_bf16
    loss, grads = _port_loss_grads(cfg, _np_tree(ref_params), tokens)
    floor_loss = abs(want_loss - twin_loss) / abs(twin_loss)
    assert abs(loss - want_loss) / abs(want_loss) <= max(
        2e-2, 2 * floor_loss)
    floor = _leaf_rel(want_g, twin_g)
    to_twin = _leaf_rel(grads, twin_g)
    over = {k: (to_twin[k], floor[k]) for k in to_twin
            if to_twin[k] > max(2e-2, 2 * floor[k])}
    assert not over, over
    # beyond the criterion: the triangle inequality's bound on the
    # distance to the reference's own bf16 leaves
    to_ref = _leaf_rel(grads, want_g)
    over = {k: (to_ref[k], floor[k]) for k in to_ref
            if to_ref[k] > max(2e-2, 3 * floor[k])}
    assert not over, over


def _ref_rounded_norm(p, cfg, x, *, backend):
    """The reference's pre-norm (``repro.models.layers.apply_norm``): the
    inverse rounded to x's dtype before it scales x."""
    inv = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6)
    return x * inv.to(x.dtype) * p["scale"].to(x.dtype)


def test_bf16_grads_match_reference_with_its_norm_rounding(
        cfgs, ref_params, tokens, ref_bf16, monkeypatch):
    """With the pre-norms rounded as the reference rounds them, the port's
    bf16 loss and every bf16 gradient leaf lie within max(2e-2, 2 x floor)
    of the reference's own bf16 results: the rest of the bf16 gap between
    the two packages is that rounding."""
    _, cfg = cfgs
    want_loss, want_g, twin_loss, twin_g = ref_bf16
    monkeypatch.setattr(L, "apply_norm", _ref_rounded_norm)
    loss, grads = _port_loss_grads(cfg, _np_tree(ref_params), tokens)
    floor_loss = abs(want_loss - twin_loss) / abs(twin_loss)
    assert abs(loss - want_loss) / abs(want_loss) <= max(
        2e-2, 2 * floor_loss)
    floor = _leaf_rel(want_g, twin_g)
    to_ref = _leaf_rel(grads, want_g)
    over = {k: (to_ref[k], floor[k]) for k in to_ref
            if to_ref[k] > max(2e-2, 2 * floor[k])}
    assert not over, over


def test_scan_moves_the_gradients(cfgs, ref_params, tokens, monkeypatch):
    """With these weights the comparisons above see the scan: dropping its
    inter-chunk carry moves the in-projection's gradient far beyond the
    float32 tolerance."""
    _, cfg = cfgs
    arrays = _np_tree(RP.cast_tree(ref_params, jnp.float32))
    _, base = _port_loss_grads(cfg, arrays, tokens)
    plain = mamba2._SSD["torch"]

    def no_carry(x, dt, A, b, c, *, chunk):
        return torch.cat([plain(*(a[:, i:i + chunk] for a in (x, dt)), A,
                                *(a[:, i:i + chunk] for a in (b, c)),
                                chunk=chunk)
                          for i in range(0, x.shape[1], chunk)], dim=1)

    monkeypatch.setitem(mamba2._SSD, "torch", no_carry)
    _, moved = _port_loss_grads(cfg, arrays, tokens)
    rel = _leaf_rel(moved, base)
    assert rel["['layers']['in_proj']"] > 100 * 1e-4, rel


def test_train_step_matches_reference(cfgs, ref_params, tokens):
    """One microbatched (2) step of both packages' ``build_train_step``,
    float32; the reference's on a 1x1 mesh with Auto axes."""
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
    under ``torch.no_grad()``; trainable ones take one remat a layer."""
    _, cfg = cfgs
    assert cfg.remat
    tree = P.init_tree(Z.spec(cfg), torch.Generator().manual_seed(0), "cpu")
    model = Z.build(cfg, tree)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    calls = []
    plain_checkpoint = mamba2.checkpoint
    monkeypatch.setattr(mamba2, "checkpoint",
                        lambda *a, **k: calls.append(1)
                        or plain_checkpoint(*a, **k))
    with torch.no_grad():
        want = Z.forward(model, cfg, batch)
    got = Z.forward(model, cfg, batch)
    assert not calls and got.grad_fn is None
    assert torch.equal(got, want)
    trainable = Z.build(cfg, tree, trainable=True)
    assert Z.forward(trainable, cfg, batch).grad_fn is not None
    assert len(calls) == cfg.n_layers


def test_trainer_replays_a_failure_bit_for_bit(tmp_path):
    """``launch.train --arch mamba2-2.7b`` on the CPU: the loss falls over
    8 steps, and a run with a checkpoint every 4 and a failure at step 5
    ends on the same bits."""
    common = ["--arch", "mamba2-2.7b", "--device", "cpu", "--steps", "8",
              "--seq-len", "32", "--global-batch", "4"]
    clean = train.main(common)
    failed = train.main(common + ["--ckpt-every", "4", "--inject-failure-at",
                                  "5", "--ckpt-dir", str(tmp_path)])
    assert clean[-1] < clean[0]
    assert len(failed) > len(clean) and failed[-1] == clean[-1]


def test_layers_option_cuts_the_depth(capsys):
    losses = train.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                         "--steps", "1", "--seq-len", "16", "--global-batch",
                         "2", "--layers", "1"])
    assert len(losses) == 1 and np.isfinite(losses[0])
