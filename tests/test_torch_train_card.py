"""The training path on the card: the flash-attention and RMSNorm backward
kernels against their plain backwards, and a small model's loss and
gradients on the kernels against the plain versions.  Every test needs a
CUDA card (the ``cuda`` marker; they skip elsewhere) and none imports JAX.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_card.py

Tolerances: the kernels' (f32 2e-5, bf16 2e-2), as tol x max|g| + tol x
|g|; the model in float32 within 1e-4 of each leaf's largest |g|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rms
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.launch import steps as ST
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P
from repro_torch.tree import leaves

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


def _held(got, want, tol):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    assert float(((g - w).abs() - tol * w.abs().amax()
                  - tol * w.abs()).max()) <= 0


def _rand(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 256, 14, 2, 64, True, 0),
                                  (1, 200, 8, 2, 128, True, 32),
                                  (2, 16, 4, 4, 64, False, 0),
                                  (2, 1000, 14, 2, 64, True, 0),
                                  (1, 512, 14, 2, 64, True, 40),
                                  (2, 16, 14, 2, 64, True, 0)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_backward_kernel_matches_plain(case, dtype, cuda_device):
    b, t, h, kv, d, causal, window = case
    q, k, v = (_rand((b, t, n, d), dtype, cuda_device, i)
               for i, n in enumerate((h, kv, kv)))
    dout = _rand((b, t, h, d), dtype, cuda_device, 9)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    fa.reset_backward_launch_counts()
    fa.reset_route_counts()
    fa.reset_backward_route_counts()
    out = fa.flash_attention(qa, ka, va, causal=causal, window=window)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fa.backward_launch_counts() == {"flash_attention_bwd": 1}
    assert fa.route_counts()[fa._grad_route(dtype, d)] == 1
    route = "mma" if dtype == torch.bfloat16 else "fma"
    assert fa._bwd_route(dtype, d) == route
    assert fa.backward_route_counts() == {"fma": 0, "mma": 0, route: 1}
    _, lse = fa._launch(q, k, v, causal, window, 0,
                        fa._grad_route(dtype, d), True)
    want = fa_ref.attention_bwd_ref(q, k, v, out.detach(), lse, dout,
                                    causal=causal, window=window)
    for g, w in zip((qa.grad, ka.grad, va.grad), want):
        _held(g, w, TOL[dtype])
    again = fa.flash_attention_bwd(q, k, v, out.detach(), lse, dout,
                                   causal=causal, window=window)
    for g, w in zip(again, (qa.grad, ka.grad, va.grad)):
        assert torch.equal(g, w)


def _offset(t):
    """A copy of t one element into a fresh buffer: contiguous, not
    16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


# (shape, operand offset by one element): the train shape, mamba2's
# widths, one element an access by D and by an offset view of x or of g
@pytest.mark.cuda
@pytest.mark.parametrize("shape, offset",
                         [((4096, 896), None), ((37, 2560), None),
                          ((3, 1001), None), ((8192, 5120), None),
                          ((4096, 896), "g"), ((64, 2560), "x")], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_backward_kernel_matches_plain(shape, offset, dtype,
                                               cuda_device):
    x = _rand(shape, dtype, cuda_device, 0)
    sc = _rand(shape[-1:], torch.float32, cuda_device, 1)
    g = _rand(shape, dtype, cuda_device, 2)
    if offset == "x":
        x = _offset(x)
    elif offset == "g":
        g = _offset(g)
    assert bool(offset) == bool((x.data_ptr() | g.data_ptr()) & 15)
    # x's own storage, so that an offset x reaches the backward as it is
    xa, sa = x.detach().requires_grad_(), sc.clone().requires_grad_()
    rms.reset_backward_launch_counts()
    rms.rmsnorm(xa, sa).backward(g)
    torch.cuda.synchronize()
    assert rms.backward_launch_counts() == {"rmsnorm_bwd": 1}
    wdx, wds = rms_ref.rmsnorm_bwd_ref(x, sc, g)
    _held(xa.grad, wdx, TOL[dtype])
    _held(sa.grad, wds, TOL[dtype])
    dx, ds = rms.rmsnorm_bwd(x, sc, g)
    assert torch.equal(dx, xa.grad) and torch.equal(ds, sa.grad)


@pytest.mark.cuda
def test_model_gradients_on_the_kernels(cuda_device):
    """A 2-layer dense model at head dim 64, float32: loss and gradients on
    the kernels against the plain versions, remat on; and remat off gives
    the kernels' bits."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), d_model=128,
                              n_heads=4, n_kv_heads=2, head_dim=64,
                              microbatches=2)
    params = P.cast_tree(P.init_tree(Z.spec(cfg), torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device), torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64))).to(cuda_device)
    out = {bk: ST.loss_and_grads(params, cfg, {"tokens": tokens},
                                 microbatches=2, backend=bk)
           for bk in ("cuda", "torch")}
    assert float(out["cuda"][0]) == pytest.approx(float(out["torch"][0]),
                                                  rel=1e-5)
    for g, w in zip(leaves(out["cuda"][1]), leaves(out["torch"][1])):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    # remat recomputes each layer through the same kernels: the same bits
    loss, grads = ST.loss_and_grads(params, dataclasses.replace(
        cfg, remat=False), {"tokens": tokens}, microbatches=2,
        backend="cuda")
    assert torch.equal(loss, out["cuda"][0])
    for g, w in zip(leaves(grads), leaves(out["cuda"][1])):
        assert torch.equal(g, w)
