"""The port's mamba2 path — weights carried across, ``forward`` (through
the SSD scan), the recurrent ``decode_step`` and ``ServeEngine`` — held
against the JAX package at ``get_config("mamba2-2.7b").smoke()`` on the
CPU (plain versions of the kernels).

The reference's init makes the SSD's share of the logits vanish (B, C
and x come out of the conv near 0.005, so dropping the SSD's output moves
the smoke model's logits by less than 1e-6).  The weights here are the reference's
init with the SSM's leaves redrawn from a seed so the scan matters:
in_proj std 1/sqrt(d_model), conv_w std 0.5, A in [1, 16], dt_bias =
softplus⁻¹ of [0.001, 0.1] (Mamba-2's own ranges), D in [0.5, 1.5]; then
dropping the SSD's output moves the f32 logits by 0.091 of 0.60, and
dropping only its inter-chunk carry by 0.066
(``test_ssd_and_its_carry_move_the_logits``).

Tolerances:

* float32 parameters: rtol/atol 1e-5 on logits of magnitude ~0.6.
  Measured max abs difference 2.7e-7 (forward) and 1.8e-7 (decode): only
  the order of float32 sums differs.
* bfloat16 parameters: rtol/atol 0.15, the reference's own mamba2 decode
  tolerance (``tests/test_decode_consistency.py:50``); the port's SSD
  works in float32 where the reference's ``ssd_chunked`` runs its
  products in bf16, and its RMSNorm rounds once (measured: 0.0039, one
  bf16 ulp, forward and decode).
* served tokens: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model_zoo as RZ
from repro.models import params as RP
from repro.serving import ServeEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request
from test_torch_serve import (_assert_same_bits, _decode_all, _f32, _port,
                              _tokens)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.15, atol=0.15)
T = 24          # three chunks of the smoke config's 8 (the reference asserts T % chunk == 0)

# One compile of each reference program per shape, at XLA's lowest
# backend optimisation level (as in test_torch_serve.py).
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
ref_forward = _jit(RZ.forward, static_argnums=1)
ref_decode = _jit(RZ.decode_step, static_argnums=1)


def _live(tree, cfg, seed=0):
    """The reference's parameter tree (numpy) with the SSM's leaves redrawn
    so that the scan and its carry move the logits (module docstring)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    lay = dict(tree["layers"])
    nl, h = lay["A_log"].shape

    def normal(like, std):
        return (rng.standard_normal(like.shape) * std).astype(like.dtype)

    lay["in_proj"] = normal(lay["in_proj"], cfg.d_model ** -0.5)
    lay["conv_w"] = normal(lay["conv_w"], 0.5)
    lay["A_log"] = np.log(rng.uniform(1, 16, (nl, h))).astype(np.float32)
    lay["dt_bias"] = np.log(np.expm1(
        rng.uniform(1e-3, 0.1, (nl, h)))).astype(np.float32)
    lay["D"] = rng.uniform(0.5, 1.5, (nl, h)).astype(np.float32)
    return dict(tree, layers=lay)


@pytest.fixture(scope="module")
def cfgs():
    return (ref_get_config("mamba2-2.7b").smoke(),
            get_config("mamba2-2.7b").smoke())


@pytest.fixture(scope="module")
def ref_params(cfgs):
    return _live(_jit(RZ.init, static_argnums=0)(cfgs[0], jax.random.key(0)),
                 cfgs[0])


def _caches(rcfg, cfg, b, dtype):
    """Empty caches of both packages; the conv buffer in ``dtype``."""
    spec = RZ.cache_spec(rcfg, b, 8)
    rc = dict(state=np.zeros(spec["state"].shape, np.float32),
              conv=np.zeros(spec["conv"].shape,
                            np.float32 if dtype == "f32" else jnp.bfloat16),
              length=np.int32(0))
    pc = P.init_tree(Z.cache_spec(cfg, b, 8), device="cpu")
    if dtype == "f32":
        pc["conv"] = pc["conv"].float()
    return rc, pc


def test_weights_round_trip_bit_for_bit(cfgs, ref_params):
    """Every leaf keeps its dtype and bits, the float32 A_log, D, dt_bias
    and gate_norm included, under the reference's names."""
    rcfg, cfg = cfgs
    model = _port(ref_params, cfg)
    assert isinstance(model, mamba2.Mamba2)
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    seen, f32 = 0, set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                name = ".".join(["layers", str(i)] + keys[1:])
                _assert_same_bits(model.get_parameter(name), leaf[i])
                seen += 1
        else:
            _assert_same_bits(model.get_parameter(".".join(keys)), leaf)
            seen += 1
        if leaf.dtype == np.float32:
            f32.add(keys[-1])
    assert {"A_log", "D", "dt_bias", "gate_norm", "scale"} <= f32
    assert seen == len(list(model.parameters()))
    assert RP.count_params(RZ.spec(rcfg)) == P.count_params(Z.spec(cfg)) \
        == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_and_forward_match_reference(cfgs, ref_params, dtype):
    rcfg, cfg = cfgs
    rp = _f32(ref_params) if dtype == "f32" else ref_params
    model = _port(rp, cfg)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    tok = _tokens(cfg, 2, T)

    want = np.asarray(ref_forward(rp, rcfg, {"tokens": jnp.asarray(tok)}),
                      np.float32)
    got = Z.forward(model, cfg, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.float().numpy(), want, **tol)

    rc, pc = _caches(rcfg, cfg, 2, dtype)
    want = _decode_all(lambda t, c: ref_decode(rp, rcfg, jnp.asarray(t), c),
                       tok, rc)
    got = _decode_all(lambda t, c: Z.decode_step(
        model, cfg, torch.from_numpy(t).long(), c), tok, pc)
    np.testing.assert_allclose(got, want, **tol)
    assert pc["length"] == 0      # the input dict's length is not advanced


def test_ssd_and_its_carry_move_the_logits(cfgs, ref_params, monkeypatch):
    """With these weights the f32 comparisons above see the scan: the
    logits move far beyond F32_TOL when the SSD's output, or only the
    state it carries from chunk to chunk, is dropped."""
    _, cfg = cfgs
    model = _port(_f32(ref_params), cfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, T)).long()}
    base = Z.forward(model, cfg, batch)
    plain = mamba2._SSD["torch"]

    def no_carry(x, dt, A, b, c, *, chunk):
        return torch.cat([plain(*(a[:, i:i + chunk] for a in (x, dt)), A,
                                *(a[:, i:i + chunk] for a in (b, c)),
                                chunk=chunk)
                          for i in range(0, x.shape[1], chunk)], dim=1)

    moved = {}
    for name, ssd in (("output", lambda *a, **k: plain(*a, **k) * 0),
                      ("carry", no_carry)):
        monkeypatch.setitem(mamba2._SSD, "torch", ssd)
        moved[name] = float((Z.forward(model, cfg, batch) - base).abs().max())
    assert min(moved.values()) > 1000 * F32_TOL["atol"], moved


def _serve(engine_cls, request_cls, cfg, params, *, slots, n, prompt_len,
           new_tokens, setup=lambda engine: engine, **kw):
    engine = setup(engine_cls(cfg, params, batch_slots=slots, max_seq=64,
                              **kw))
    rng = np.random.default_rng(0)
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab, size=int(
            rng.integers(*prompt_len))).astype(np.int32)
        engine.submit(request_cls(rid=rid, prompt=prompt,
                                  max_new_tokens=new_tokens))
    done = engine.run_until_drained()
    assert done.drained
    return {r.rid: r.out_tokens for r in done}, engine


def test_served_tokens_equal_reference(cfgs, ref_params):
    """5 requests through 3 slots: two slots are reused with the state and
    conv buffer their last request left (the reference resets neither),
    and every slot's state takes token 0 while another slot prefills.

    Served in float32 (parameters and both engines' conv buffers): in bf16
    the smoke model's 256 logits tie within one bf16 ulp often enough that
    one rounding apart flips a token (request 1's third token here)."""
    rcfg, cfg = cfgs
    rp = _f32(ref_params)
    kw = dict(slots=3, n=5, prompt_len=(3, 9), new_tokens=6)

    def f32_conv(engine):
        conv = engine.cache["conv"]
        engine.cache["conv"] = (conv.float() if isinstance(conv, torch.Tensor)
                                else conv.astype(jnp.float32))
        return engine

    want, ref_engine = _serve(RefEngine, RefRequest, rcfg, rp,
                              setup=f32_conv, **kw)
    got, engine = _serve(ServeEngine, Request, cfg, _port(rp, cfg),
                         setup=f32_conv, device="cpu", **kw)
    assert got == want
    assert engine.cache["length"] == int(ref_engine.cache["length"])
    for key in ("state", "conv"):
        np.testing.assert_allclose(engine.cache[key].numpy(),
                                   np.asarray(ref_engine.cache[key]),
                                   **F32_TOL)


def test_port_decode_matches_its_forward(cfgs):
    """Decode-vs-forward consistency of the port itself in float32, as
    ``tests/test_decode_consistency.py`` checks the reference (bf16)."""
    rcfg, cfg = cfgs
    model = _port(_f32(_live(_jit(RZ.init, static_argnums=0)(
        rcfg, jax.random.key(3)), rcfg, seed=3)), cfg)
    tok = torch.from_numpy(_tokens(cfg, 2, T, seed=3)).long()
    full = Z.forward(model, cfg, {"tokens": tok})
    _, pc = _caches(rcfg, cfg, 2, "f32")
    dec = _decode_all(lambda t, c: Z.decode_step(model, cfg, t, c), tok, pc)
    np.testing.assert_allclose(dec, full.numpy(), **F32_TOL)


def test_groups_read_per_head_where_reference_sums_them(cfgs):
    """ssm_groups=2.  The port reads head h's own group h // (H / G) of B
    and C everywhere, as the reference's intra-chunk term, its Pallas
    kernel and its oracle ``ssd_ref`` do; its decode then matches its own
    forward.  The reference's decode (``mamba2.py:176-178``) and its
    forward's chunk states (``:116-118``) sum B over the groups instead, so
    the two packages agree on a single chunk (T = 8, no carried state) and
    part past it (ROADMAP.md, Queue C)."""
    rcfg, cfg = (dataclasses.replace(c, ssm_groups=2) for c in cfgs)
    rp = _f32(_live(_jit(RZ.init, static_argnums=0)(rcfg, jax.random.key(3)),
                    rcfg, seed=3))
    model = _port(rp, cfg)
    tok = _tokens(cfg, 2, T, seed=3)
    full = Z.forward(model, cfg, {"tokens": torch.from_numpy(tok).long()})
    rc, pc = _caches(rcfg, cfg, 2, "f32")
    dec = _decode_all(lambda t, c: Z.decode_step(
        model, cfg, torch.from_numpy(t).long(), c), tok, pc)
    np.testing.assert_allclose(dec, full.numpy(), **F32_TOL)

    one = cfg.ssm_chunk
    ref_full = np.asarray(ref_forward(rp, rcfg, {"tokens": jnp.asarray(tok)}))
    np.testing.assert_allclose(full.numpy()[:, :one], ref_full[:, :one],
                               **F32_TOL)
    ref_dec = _decode_all(lambda t, c: ref_decode(
        rp, rcfg, jnp.asarray(t), c), tok, rc)
    assert np.abs(ref_full - full.numpy()).max() > 100 * F32_TOL["atol"]
    assert np.abs(ref_dec - dec).max() > 100 * F32_TOL["atol"]


def test_decode_takes_one_token(cfgs, ref_params):
    _, cfg = cfgs
    model = _port(ref_params, cfg)
    cache = P.init_tree(Z.cache_spec(cfg, 1, 8), device="cpu")
    with pytest.raises(ValueError, match="one token per step"):
        Z.decode_step(model, cfg, torch.zeros(1, 2, dtype=torch.long), cache)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Z.forward(model, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                  backend="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_full_width_engine_step_on_card(cuda_device):
    """One ServeEngine step at mamba2-2.7b's full width through the CUDA
    kernels: 129 RMSNorm and no SSD launches per decode call, and the
    logits within bf16 tolerance of the plain versions on the card."""
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssd import ops as sops
    cfg = get_config("mamba2-2.7b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Z.init(cfg, gen, cuda_device)
    engine = ServeEngine(cfg, model, batch_slots=2, max_seq=64,
                         device=cuda_device)
    assert engine.backend == "cuda"
    prompt = np.arange(5, dtype=np.int32)
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    rops.reset_launch_counts()
    sops.reset_launch_counts()
    emitted = engine.step()
    calls = len(prompt) + 1
    assert rops.launch_counts()["rmsnorm"] == 129 * calls
    assert sops.launch_counts()["ssd"] == 0
    assert list(emitted) == [0]
    tok = torch.tensor([[1], [2]], device=cuda_device)
    fresh = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in engine.cache.items()}
    got, _ = Z.decode_step(model, cfg, tok, engine.cache, backend="cuda")
    want, _ = Z.decode_step(model, cfg, tok, fresh, backend="torch")
    scale = float(want.float().abs().max())
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_forward_defaults_to_kernels_on_card(cuda_device):
    """``forward`` with no backend on the card runs the SSD kernel once a
    layer: mamba2-2.7b's widths, two layers, a ragged T of 300."""
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssd import ops as sops
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Z.init(cfg, gen, cuda_device)
    batch = Z.make_batch(cfg, seq_len=300, global_batch=2, generator=gen,
                         device=cuda_device)
    rops.reset_launch_counts()
    sops.reset_launch_counts()
    got = Z.forward(model, cfg, batch)
    torch.cuda.synchronize()
    assert sops.launch_counts()["ssd"] == 2
    assert rops.launch_counts()["rmsnorm"] == 2 * 2 + 1
    want = Z.forward(model, cfg, batch, backend="torch")
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
