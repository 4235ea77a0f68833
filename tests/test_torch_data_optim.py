"""The port's data pipeline, clipping, schedules and optimizers held against
the JAX package's on the CPU.

* batches: bit for bit, for several seeds, steps, host shards, the
  prefetch thread and a memmap corpus;
* ``global_norm`` and ``clip_by_global_norm``: rtol 1e-6 (the leaves' sums
  run in another order);
* AdamW and Adafactor ``update`` on the same trees, three steps: the
  float32 state within rtol 1e-6 of each value plus 1e-6 of the leaf's
  largest (a master weight that the step nearly cancels keeps the
  absolute error of its operands, an ulp of ~1e-7 of them), bf16
  parameters within one bf16 ulp (a float32 result one rounding apart can
  round to neighbouring bf16 values);
* schedules: equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as RefPipeline
from repro.data import SyntheticLM as RefSynthetic
from repro.data.pipeline import MemmapCorpus as RefMemmap
from repro.optim.adafactor import adafactor as ref_adafactor
from repro.optim.adamw import adamw as ref_adamw
from repro.optim import clip as ref_clip
from repro.optim import schedule as ref_schedule
from repro_torch.data import DataPipeline, MemmapCorpus, SyntheticLM
from repro_torch.optim import adafactor, adamw, clip, schedule
from repro_torch.tree import flatten, leaves

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_batches_bit_equal(seed, num_hosts):
    for host in range(num_hosts):
        ours = DataPipeline(SyntheticLM(1000, seed), global_batch=4,
                            seq_len=33, host_id=host, num_hosts=num_hosts)
        ref = RefPipeline(RefSynthetic(1000, seed), global_batch=4,
                          seq_len=33, host_id=host, num_hosts=num_hosts)
        try:
            for step in (0, 1, 5):
                a, b = ours._make_batch(step), ref._make_batch(step)
                assert a.keys() == b.keys()
                assert a["tokens"].dtype == b["tokens"].dtype == np.int32
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert ours.state() == ref.state()
        finally:
            ours.close()
            ref.close()


def test_prefetch_stream_bit_equal():
    ours = DataPipeline(SyntheticLM(300, 1), global_batch=2, seq_len=8,
                        start_step=2, prefetch=3)
    ref = RefPipeline(RefSynthetic(300, 1), global_batch=2, seq_len=8,
                      start_step=2, prefetch=3)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(ours)["tokens"],
                                          next(ref)["tokens"])
        assert ours.state() == ref.state() == dict(step=6, host_id=0,
                                                   num_hosts=1)
    finally:
        ours.close()
        ref.close()


def test_memmap_corpus_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 4096, dtype=np.int32) \
        .tofile(path)
    ours, ref = MemmapCorpus(str(path)), RefMemmap(str(path))
    for step, index in ((0, 0), (3, 7), (11, 2)):
        np.testing.assert_array_equal(ours.sample(step, index, 64),
                                      ref.sample(step, index, 64))


def test_pipeline_rejects_uneven_hosts():
    with pytest.raises(ValueError, match="split evenly"):
        DataPipeline(SyntheticLM(10), global_batch=3, seq_len=4,
                     num_hosts=2)


# ---------------------------------------------------------------------------
# clipping, schedules
# ---------------------------------------------------------------------------

def _tree(seed, scale=1.0):
    """The same tree for both packages: numpy float32 leaves, one rounded to
    bf16 — nested dicts and a list, as the model trees are."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"b": mk(7), "a": {"w": mk(4, 5), "z": mk(3)},
            "layers": [{"k": mk(6, 2)}, {"k": mk(6, 2)}],
            "emb": mk(16, 8)}


_BF16 = ("emb",)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, {
        k: (jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
            if k in _BF16 else v) for k, v in tree.items()})


def _to_torch(tree):
    def conv(k, v):
        t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), v)
        return (jax.tree.map(lambda x: x.to(torch.bfloat16), t)
                if k in _BF16 else t)
    return {k: conv(k, v) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_global_norm_and_clip():
    g = _tree(1, scale=3.0)
    gj, gt = _to_jax(g), _to_torch(g)
    want = float(_jit(ref_clip.global_norm)(gj))
    got = float(clip.global_norm(gt))
    assert got == pytest.approx(want, rel=1e-6)
    cj, nj = _jit(ref_clip.clip_by_global_norm)(gj, 1.0)
    ct, nt = clip.clip_by_global_norm(gt, 1.0)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    assert flatten(ct)[1] == flatten(gt)[1]
    for a, b in zip(leaves(ct), jax.tree.leaves(cj)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                   atol=1e-6 if a.dtype == torch.float32
                                   else 8e-3)
    # a norm below the limit leaves every leaf as it is
    small, _ = clip.clip_by_global_norm(gt, 1e9)
    for a, b in zip(leaves(small), leaves(gt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10_000,
                                  12_000])
def test_schedules_equal(step):
    ours = schedule.cosine_schedule(3e-4, warmup_steps=100,
                                    total_steps=10_000)
    ref = ref_schedule.cosine_schedule(3e-4, warmup_steps=100,
                                       total_steps=10_000)
    got = ours(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(_jit(ref)(jnp.int32(step)))
    assert float(schedule.constant_schedule(0.1)(torch.tensor(step))) == \
        float(ref_schedule.constant_schedule(0.1)(step))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return np.asarray(x).view(np.uint16).astype(np.int64)


def _check_params(got, want):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            assert np.abs(_bf16_bits(a) - _bf16_bits(b)).max() <= 1
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def _check_state(got, want):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        if a.dtype == torch.int32:
            assert int(a) == int(b)
        else:
            b = _np(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()))


def _factored_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    t = _tree(seed, scale)
    t["big"] = (rng.standard_normal((128, 160)) * scale).astype(np.float32)
    return t


@pytest.mark.parametrize("name", ["adamw", "adamw_no_master", "adafactor",
                                  "adafactor_schedule"])
def test_optimizer_updates_match_reference(name):
    kw = {"adamw": dict(lr=1e-2, weight_decay=0.1),
          "adamw_no_master": dict(lr=1e-2, keep_master=False),
          "adafactor": dict(lr=1e-2, weight_decay=0.05),
          "adafactor_schedule": {}}[name]
    sched = name.endswith("schedule")
    if "adamw" in name:
        ours, ref = adamw(**kw), ref_adamw(**kw)
    else:
        ours = adafactor(**kw, schedule=schedule.cosine_schedule(
            1e-2, warmup_steps=2, total_steps=5) if sched else None)
        ref = ref_adafactor(**kw, schedule=ref_schedule.cosine_schedule(
            1e-2, warmup_steps=2, total_steps=5) if sched else None)
    p0 = _factored_tree(0)
    pj, pt = _to_jax(p0), _to_torch(p0)
    sj, st = ref.init(pj), ours.init(pt)
    _check_state(st, sj)
    upd = _jit(ref.update)
    for i in range(3):
        g = _factored_tree(10 + i, scale=0.3)
        pj, sj = upd(_to_jax(g), sj, pj)
        pt, st = ours.update(_to_torch(g), st, pt)
        _check_params(pt, pj)
        _check_state(st, sj)
    assert int(st["step"]) == 3
    if "adafactor" in name:     # the [128, 160] leaf keeps row and column
        assert set(st["slots"]["big"]) == {"vr", "vc"}
        assert st["slots"]["big"]["vr"].shape == (128,)


def test_adamw_update_is_in_place():
    opt = adamw(lr=1e-2)
    p = _to_torch(_tree(0))
    s = opt.init(p)
    before = [x.data_ptr() for x in leaves(p) + leaves(s["m"])]
    p2, s2 = opt.update(_to_torch(_tree(1)), s, p)
    assert p2 is p and s2 is s
    assert [x.data_ptr() for x in leaves(p) + leaves(s["m"])] == before


def test_make_optimizer_follows_the_config():
    from repro_torch.configs import get_config
    from repro_torch.optim import make_optimizer
    cfg = get_config("qwen2-0.5b")
    st = make_optimizer(cfg).init({"w": torch.zeros(2)})
    assert set(st) == {"m", "v", "master", "step"}


def test_adafactor_clip_is_per_layer_on_model_trees():
    """The port's layers are separate leaves where the reference stacks
    them, so Adafactor's RMS clip sees one layer at a time: each layer
    equals the reference's update of that layer alone, not its update of
    the stacked leaf (qwen2-0.5b trains with AdamW, which is
    elementwise)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((2, 128, 128)).astype(np.float32)
    g = rng.standard_normal((2, 128, 128)).astype(np.float32)
    g[1] *= np.linspace(0.1, 3.0, 128, dtype=np.float32)[:, None]
    ref, ours = ref_adafactor(lr=1e-2), adafactor(lr=1e-2)
    upd = _jit(ref.update)
    stacked = {"layers": {"w": jnp.asarray(w)}}
    pj, _ = upd({"layers": {"w": jnp.asarray(g)}}, ref.init(stacked), stacked)
    per_layer = {"layers": [{"w": torch.from_numpy(w[i].copy())}
                            for i in range(2)]}
    pt, _ = ours.update({"layers": [{"w": torch.from_numpy(g[i].copy())}
                                    for i in range(2)]},
                        ours.init(per_layer), per_layer)
    got = np.stack([pt["layers"][i]["w"].numpy() for i in range(2)])
    for i in range(2):
        one = {"w": jnp.asarray(w[i])}
        pi, _ = upd({"w": jnp.asarray(g[i])}, ref.init(one), one)
        np.testing.assert_allclose(got[i], np.asarray(pi["w"]), rtol=1e-6,
                                   atol=1e-7)
    assert not np.allclose(got, np.asarray(pj["layers"]["w"]), rtol=1e-6,
                           atol=1e-7)
