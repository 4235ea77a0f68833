"""The port's LM serving path — weights carried across, ``forward``,
``decode_step`` and ``ServeEngine`` — held against the JAX package at
``get_config("qwen2-0.5b").smoke()`` on the CPU (plain versions of the
kernels).

Tolerances:

* float32 parameters: rtol 1e-5, atol 1e-4 on logits of magnitude ~10-80.
  Measured max abs difference 2.3e-5 (decode) and 1.5e-5 (forward): only
  the order of float32 sums differs.
* bfloat16 parameters: rtol/atol 0.12, the reference's own decode
  tolerance (``tests/test_decode_consistency.py:36-38``); the port's
  RMSNorm rounds once in float32 where the reference rounds its inverse to
  bf16 first, and its attention keeps probabilities in float32.
* served tokens: equal.
"""

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
from repro_torch.core import convert
from repro_torch.models import layers
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request

F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=0.12, atol=0.12)
T = 12

# One compile of each reference program per shape, instead of eager
# dispatch, at XLA's lowest backend optimisation level, which compiles
# them several times faster; the tolerances above hold all the same.
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
ref_forward = _jit(RZ.forward, static_argnums=1)
ref_decode = _jit(RZ.decode_step, static_argnums=1)


@pytest.fixture(scope="module")
def cfgs():
    return (ref_get_config("qwen2-0.5b").smoke(),
            get_config("qwen2-0.5b").smoke())


@pytest.fixture(scope="module")
def ref_params(cfgs):
    return _jit(RZ.init, static_argnums=0)(cfgs[0], jax.random.key(0))


def _port(ref_tree, cfg):
    return convert.params_from_arrays(jax.tree.map(np.asarray, ref_tree),
                                      cfg, "cpu")


def _f32(ref_tree):
    """The reference's tree cast to float32 in numpy (exact from bf16)."""
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), ref_tree)


def _ref_cache(rcfg, b, s, dtype):
    """The reference's cache_spec as numpy zeros in ``dtype``."""
    spec = RZ.cache_spec(rcfg, b, s)
    return dict(k=np.zeros(spec["k"].shape, dtype),
                v=np.zeros(spec["v"].shape, dtype), length=np.int32(0))


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def test_weights_round_trip_bit_for_bit(cfgs, ref_params):
    rcfg, cfg = cfgs
    model = _port(ref_params, cfg)
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    seen = 0
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
    assert seen == len(list(model.parameters()))
    assert RP.count_params(RZ.spec(rcfg)) == P.count_params(Z.spec(cfg)) \
        == sum(p.numel() for p in model.parameters())


def _assert_same_bits(t, a):
    assert tuple(t.shape) == a.shape
    if a.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert t.dtype == torch.float32 and a.dtype == np.float32
        np.testing.assert_array_equal(t.numpy(), a)


def _decode_all(decode, tokens, cache):
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = decode(tokens[:, i:i + 1], cache)
        outs.append(logits[:, 0].float().numpy() if isinstance(
            logits, torch.Tensor) else np.asarray(logits)[:, 0].astype(
                np.float32))
    return np.stack(outs, axis=1)


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

    rc = _ref_cache(rcfg, 2, T + 4,
                    np.float32 if dtype == "f32" else jnp.bfloat16)
    pc = P.init_tree(Z.cache_spec(cfg, 2, T + 4), device="cpu")
    pdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pc = dict(pc, k=pc["k"].to(pdt), v=pc["v"].to(pdt))
    want = _decode_all(lambda t, c: ref_decode(rp, rcfg, jnp.asarray(t), c),
                       tok, rc)
    got = _decode_all(lambda t, c: Z.decode_step(
        model, cfg, torch.from_numpy(t).long(), c), tok, pc)
    np.testing.assert_allclose(got, want, **tol)
    assert pc["length"] == 0      # the input dict's length is not advanced


def test_long_forward_matches_blockwise_reference(cfgs, ref_params):
    """T = 1024: the reference takes its blockwise attention path
    (``layers.py:280-283``), the port its flash attention."""
    rcfg, cfg = cfgs
    rp = _f32(ref_params)
    model = _port(rp, cfg)
    tok = _tokens(cfg, 1, 1024, seed=2)
    want = np.asarray(ref_forward(rp, rcfg, {"tokens": jnp.asarray(tok)}),
                      np.float32)
    got = Z.forward(model, cfg, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def _serve(engine_cls, request_cls, cfg, params, *, slots, max_seq, n,
           prompt_len, new_tokens, **kw):
    engine = engine_cls(cfg, params, batch_slots=slots, max_seq=max_seq,
                        **kw)
    rng = np.random.default_rng(0)
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab, size=int(
            rng.integers(*prompt_len))).astype(np.int32)
        engine.submit(request_cls(rid=rid, prompt=prompt,
                                  max_new_tokens=new_tokens))
    done = engine.run_until_drained()
    assert done.drained
    return {r.rid: r.out_tokens for r in done}, engine


@pytest.mark.parametrize("max_seq", [96, 24], ids=["fits", "overflows"])
def test_served_tokens_equal_reference(cfgs, ref_params, max_seq):
    """5 requests through 3 slots.  At max_seq 24 the shared length runs
    past the cache (about 40 prefill tokens): the reference's clamped
    writes at max_seq - 1 are mirrored."""
    rcfg, cfg = cfgs
    kw = dict(slots=3, max_seq=max_seq, n=5, prompt_len=(3, 9),
              new_tokens=6)
    want, ref_engine = _serve(RefEngine, RefRequest, rcfg, ref_params, **kw)
    got, engine = _serve(ServeEngine, Request, cfg, _port(ref_params, cfg),
                         device="cpu", **kw)
    assert got == want
    assert engine.cache["length"] == int(ref_engine.cache["length"])
    if max_seq == 24:
        assert engine.cache["length"] > max_seq
    np.testing.assert_allclose(
        engine.cache["k"].float().numpy(),
        np.asarray(ref_engine.cache["k"], np.float32), **BF16_TOL)


def test_port_decode_matches_its_forward(cfgs, ref_params):
    """Decode-vs-forward consistency of the port itself, as
    ``tests/test_decode_consistency.py`` checks the reference."""
    _, cfg = cfgs
    model = _port(ref_params, cfg)
    tok = torch.from_numpy(_tokens(cfg, 2, T, seed=3)).long()
    full = Z.forward(model, cfg, {"tokens": tok})
    cache = P.init_tree(Z.cache_spec(cfg, 2, T + 4), device="cpu")
    dec = _decode_all(lambda t, c: Z.decode_step(model, cfg, t, c), tok,
                      cache)
    np.testing.assert_allclose(full.float().numpy(), dec, **BF16_TOL)


def test_unported_archs_and_families_raise(cfgs):
    import dataclasses
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("whisper-base")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    moe = dataclasses.replace(cfgs[1], family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Z.spec(moe)


def test_backend_resolves_from_the_device(cfgs, ref_params):
    """``backend=None`` is the plain versions on CPU tensors; the kernels
    need a CUDA device, and the layers take no backend of their own."""
    _, cfg = cfgs
    model = _port(ref_params, cfg)
    tok = torch.from_numpy(_tokens(cfg, 1, 4)).long()
    got = Z.forward(model, cfg, {"tokens": tok})
    assert torch.equal(got, Z.forward(model, cfg, {"tokens": tok},
                                      backend="torch"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Z.forward(model, cfg, {"tokens": tok}, backend="cuda")
    cache = P.init_tree(Z.cache_spec(cfg, 1, 8), device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Z.decode_step(model, cfg, tok[:, :1], cache, backend="cuda")
    with pytest.raises(TypeError, match="backend"):
        layers.apply_norm(model.final_norm, cfg, got[..., :cfg.d_model])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_full_width_engine_step_on_card(cuda_device):
    """One ServeEngine step at qwen2-0.5b's full width through the CUDA
    kernels: 24 flash and 49 RMSNorm launches per decode step, and the
    logits within bf16 tolerance of the plain versions on the card."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Z.init(cfg, gen, cuda_device)
    engine = ServeEngine(cfg, model, batch_slots=2, max_seq=64,
                         device=cuda_device)
    assert engine.backend == "cuda"
    prompt = np.arange(5, dtype=np.int32)
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    fops.reset_launch_counts()
    rops.reset_launch_counts()
    emitted = engine.step()
    calls = len(prompt) + 1
    assert fops.launch_counts()["flash_attention"] == 24 * calls
    assert rops.launch_counts()["rmsnorm"] == 49 * calls
    assert list(emitted) == [0]
    tok = torch.tensor([[1], [2]], device=cuda_device)
    cache = engine.cache
    got, _ = Z.decode_step(model, cfg, tok, dict(cache), backend="cuda")
    want, _ = Z.decode_step(model, cfg, tok, dict(cache), backend="torch")
    scale = float(want.float().abs().max())
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_model_entry_points_default_to_kernels_on_card(cuda_device):
    """``forward`` and ``decode_step`` called with no backend on the card
    go through the CUDA kernels: qwen2-0.5b's widths, two layers."""
    import dataclasses
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Z.init(cfg, gen, cuda_device)
    batch = Z.make_batch(cfg, seq_len=16, global_batch=2, generator=gen,
                         device=cuda_device)
    fops.reset_launch_counts()
    rops.reset_launch_counts()
    got = Z.forward(model, cfg, batch)
    cache = P.init_tree(Z.cache_spec(cfg, 2, 32), device=cuda_device)
    Z.decode_step(model, cfg, batch["tokens"][:, :1], cache)
    torch.cuda.synchronize()
    assert fops.launch_counts()["flash_attention"] == 2 * 2
    assert rops.launch_counts()["rmsnorm"] == 2 * 5
    want = Z.forward(model, cfg, batch, backend="torch")
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
