"""The port's DSE service on the card: the same seeded mix drained on the
CUDA kernels and on their plain versions answers alike (ints exact, floats
within 1e-12), chaos on the kernels answers bit for bit like the clean
run with every perturbation caught, a restart after a process kill
replays to the clean answers, and ``shard=True`` is ``shard=False`` bit
for bit on one card and refused over two.  Marked ``cuda``: they skip
without a card (run them there with
``python -m pytest -q -m cuda tests/test_torch_dse_service_card.py``).
This file imports nothing of the JAX package, which the card's host need
not have."""

import numpy as np
import pytest
import torch

from repro_torch.core import accelerator, energymodel as em, topology
from repro_torch.ft import faults
from repro_torch.launch import serve_dse
from repro_torch.serving import DSEService
from repro_torch.serving.dse_service import answer_diffs

NETS = ("AlexNet", "VGG16", "MobileNet", "ResNet50")
RTOL = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the count-terms kernels are built "
                    "with nvcc and run only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def space():
    grid = accelerator.ConfigGrid.product()
    return grid, {n: topology.get_network(n) for n in NETS}


def _drain(svc, mix):
    for q in mix:
        assert svc.submit(**q).accepted
    out, drained = svc.run_until_drained()
    assert drained
    return sorted(out, key=lambda r: r.rid)


def _close(a, b, rtol):
    diffs = answer_diffs(a, b, rtol)
    assert not diffs, diffs[:5]


@pytest.mark.cuda
def test_card_cuda_answers_equal_torch(space, cuda_device):
    grid, nets = space
    mix = serve_dse.seeded_mix(list(nets), 9, 2)
    got = {b: _drain(DSEService(grid, nets, device=cuda_device, backend=b,
                                chunk_size=40), mix)
           for b in ("cuda", "torch")}
    for c, t in zip(got["cuda"], got["torch"]):
        assert (c.ok, c.degraded) == (t.ok, t.degraded) == (True, False)
        _close(c.answer, t.answer, RTOL)
    assert {r.backend for r in got["cuda"]} == {"cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_card_chaos_equals_clean(space, cuda_device, seed):
    grid, nets = space
    mix = serve_dse.seeded_mix(list(nets), 6, seed)
    clean = _drain(DSEService(grid, nets, device=cuda_device,
                              chunk_size=40), mix)
    svc = DSEService(grid, nets, device=cuda_device, chunk_size=40,
                     verify_fraction=1.0, max_retries=30, backoff_s=1e-4)
    plan = faults.FaultPlan.random(seed, 4, p_perturb=0.5)
    with faults.inject_chunk_faults(plan):
        out = _drain(svc, mix)
    for a, b in zip(out, clean):
        assert a.ok and not a.degraded
        _close(a.answer, b.answer, 0.0)
    n_perturb = sum(k == "perturb" for _, k in plan.fired)
    assert svc.stats["shadow_mismatches"] == n_perturb
    assert svc.stats["backend_fallbacks"] == 0


@pytest.mark.cuda
def test_card_kill_restart_equals_clean(space, cuda_device, tmp_path):
    grid, nets = space
    mix = serve_dse.seeded_mix(list(nets), 6, 4)
    clean = _drain(DSEService(grid, nets, device=cuda_device,
                              chunk_size=40), mix)
    s1 = DSEService(grid, nets, device=cuda_device, chunk_size=40,
                    ckpt_every=1, state_dir=tmp_path)
    for q in mix:
        s1.submit(**q)
    with faults.inject_chunk_faults(faults.FaultPlan(pkill_at=2)):
        with pytest.raises(faults.ProcessKill):
            s1.run_until_drained()
    s2 = DSEService(grid, nets, device=cuda_device, chunk_size=40,
                    ckpt_every=1, state_dir=tmp_path)
    out, drained = s2.run_until_drained()
    s2.close()
    assert drained
    answers = sorted(list(s1.responses) + out, key=lambda r: r.rid)
    assert [r.rid for r in answers] == [r.rid for r in clean]
    for a, b in zip(answers, clean):
        _close(a.answer, b.answer, 0.0)


@pytest.mark.cuda
def test_card_shard_true_equals_false(space, cuda_device, monkeypatch):
    """On one visible card ``shard=True`` is the unsharded evaluation, bit
    for bit; with more than one it is refused."""
    grid, nets = space
    assert torch.cuda.device_count() == 1
    a = em.stream_layer_topk(grid, nets, bound=0.05, chunk_size=40)
    b = em.stream_layer_topk(grid, nets, bound=0.05, chunk_size=40,
                             shard=True)
    for k in ("topk_idx", "topk_metric", "layer_energy", "layer_latency",
              "min_metric", "argmin"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="shard=True over 2"):
        em.evaluate_networks(grid, nets, shard=True)
