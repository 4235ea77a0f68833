"""The port's count-terms kernels and their plain torch versions, held
against the JAX package's Pallas kernel (interpret mode, float64) and its
numpy engine (``energymodel._count_terms(np, ...)`` plus slice sums).

Tolerance: rtol 1e-12, atol 0 — the reference's own kernel tolerance
(``tests/test_count_terms_kernel.py``).  Only the segment sums' order
differs between the versions; every per-layer term is an integer or one
division, so zeros must match exactly.

The CUDA kernels run only on a card; their tests carry the ``cuda`` marker
and skip elsewhere (``python -m pytest -q -m cuda tests/test_torch_*.py``
on the card).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import energymodel as ref_em
from repro.core import topology as ref_topo
from repro_torch.core import convert
from repro_torch.core import energymodel as em
from repro_torch.kernels.count_terms import ops, ref

NETS = ("AlexNet", "VGG16", "MobileNet")
RTOL = 1e-12

GRIDS = {
    "paper150": lambda: ref_acc.ConfigGrid.product(),
    # unique-row counts that divide no block size (the Pallas edge padding)
    "odd_blocks": lambda: ref_acc.ConfigGrid.product(
        arrays=((12, 14), (16, 16), (64, 64)), gb_psum_kb=(13, 54, 216),
        gb_ifmap_kb=(27,)),
    "extended_sub": lambda: ref_acc.extended_grid().take(
        np.arange(0, 5400, 30)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc "
                    "and run only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ref_nets():
    return {n: ref_topo.get_network(n) for n in NETS}


@pytest.fixture(scope="module")
def port_nets(ref_nets):
    return convert.networks_from_dicts(
        {n: [dataclasses.asdict(l) for l in v] for n, v in ref_nets.items()})


def _ref_operands(grid, nets, absorb_pad=True):
    """The reference engine's kernel operands, numpy."""
    lay, segments = ref_em._stack_networks(nets, absorb_pad=absorb_pad)
    lay = {k: v[None, :] for k, v in lay.items()}
    cfg_u, _ = ref_em._dedup_count_rows(
        ref_em._cfg_struct_from_grid(np, grid))
    return {k: v[:, None] for k, v in cfg_u.items()}, lay, segments


def _port_operands(grid, nets, absorb_pad=True, device="cpu"):
    """The port's own operands for the same grid, as float64 tensors."""
    lay, segments = em._stack_networks(nets, absorb_pad=absorb_pad)
    lay = {k: torch.as_tensor(v).to(device)[None, :] for k, v in lay.items()}
    _, cfg_u, _, _, _ = em._prepare_fields(
        convert.grid_from_fields(grid.fields).fields, torch.device(device),
        "cuda")
    return cfg_u, lay, segments


def _numpy_sums(cfg_u, lay, segments):
    terms = ref_em._count_terms(np, cfg_u, lay)
    n_u = cfg_u["rows"].shape[0]
    return np.stack([np.broadcast_to(
        np.stack([t[..., a:b].sum(-1) for a, b in segments], -1),
        (n_u, len(segments))) for t in terms])


def _numpy_layers(cfg_u, lay):
    terms = ref_em._count_terms(np, cfg_u, lay)
    shape = (cfg_u["rows"].shape[0], lay["m"].shape[1])
    return np.stack([np.broadcast_to(t, shape) for t in terms])


def _close(out, want):
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=0.0)
    np.testing.assert_array_equal(out == 0, want == 0)


@pytest.fixture(scope="module")
def pallas():
    pytest.importorskip("jax")
    import jax
    from repro.kernels import count_terms
    return jax, count_terms


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_port_operands_equal_reference(grid_name, ref_nets, port_nets):
    """The port's own stacking and dedup give the reference's operands."""
    grid = GRIDS[grid_name]()
    r_cfg, r_lay, r_seg = _ref_operands(grid, ref_nets)
    p_cfg, p_lay, p_seg = _port_operands(grid, port_nets)
    assert p_seg == r_seg
    for k in r_cfg:
        np.testing.assert_array_equal(p_cfg[k].numpy(), r_cfg[k])
    for k in r_lay:
        np.testing.assert_array_equal(p_lay[k].numpy(), r_lay[k])


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_plain_sums_match_pallas_and_numpy(grid_name, ref_nets, port_nets,
                                           pallas):
    jax, count_terms = pallas
    grid = GRIDS[grid_name]()
    r_cfg, r_lay, r_seg = _ref_operands(grid, ref_nets)
    with jax.enable_x64(True):
        pal = np.stack([np.asarray(o) for o in
                        count_terms.count_term_sums(r_cfg, r_lay, r_seg)])
    want = _numpy_sums(r_cfg, r_lay, r_seg)
    out = ref.count_term_sums_ref(*_port_operands(grid, port_nets)).numpy()
    _close(out, pal)
    _close(out, want)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_plain_layers_match_pallas_and_numpy(grid_name, ref_nets, port_nets,
                                             pallas):
    jax, count_terms = pallas
    grid = GRIDS[grid_name]()
    r_cfg, r_lay, _ = _ref_operands(grid, ref_nets, absorb_pad=False)
    with jax.enable_x64(True):
        pal = np.stack([np.asarray(o) for o in
                        count_terms.count_term_layers(r_cfg, r_lay)])
    p_cfg, p_lay, _ = _port_operands(grid, port_nets, absorb_pad=False)
    out = ref.count_term_layers_ref(p_cfg, p_lay).numpy()
    _close(out, pal)
    np.testing.assert_array_equal(out, _numpy_layers(r_cfg, r_lay))


def test_pad_layers_give_zero_terms(port_nets):
    """Layer pad columns are exactly 0.0 in every term, so the aggregate
    kernel may sum them into the last network."""
    cfg_u, lay, segments = _port_operands(GRIDS["odd_blocks"](), port_nets,
                                          absorb_pad=False)
    total = segments[-1][1]
    assert lay["m"].shape[1] > total
    out = ref.count_term_layers_ref(cfg_u, lay)
    assert bool((out[..., total:] == 0).all())


def test_wrappers_run_plain_versions_on_cpu(port_nets):
    """On CPU tensors the wrappers return the plain versions' values and
    launch nothing."""
    cfg_u, lay, segments = _port_operands(GRIDS["odd_blocks"](), port_nets)
    ops.reset_launch_counts()
    sums = torch.stack(ops.count_term_sums(cfg_u, lay, segments))
    layers = torch.stack(ops.count_term_layers(cfg_u, lay))
    assert torch.equal(sums, ref.count_term_sums_ref(cfg_u, lay, segments))
    assert torch.equal(layers, ref.count_term_layers_ref(cfg_u, lay))
    assert ops.launch_counts() == {"count_terms": 0, "count_layers": 0}


def test_operand_checks(port_nets):
    cfg_u, lay, _ = _port_operands(GRIDS["odd_blocks"](), port_nets)
    cfg32 = dict(cfg_u, rows=cfg_u["rows"].float())
    with pytest.raises(ValueError, match="float64"):
        ops._stack_operands(cfg32, lay)
    with pytest.raises(ValueError, match="shape"):
        ops._stack_operands(dict(cfg_u, cols=cfg_u["cols"][:3]), lay)
    with pytest.raises(ValueError, match="miss"):
        ops._stack_operands({k: v for k, v in cfg_u.items() if k != "rows"},
                            lay)
    cfg, laym = ops._stack_operands(cfg_u, lay)
    assert cfg.shape == (len(ops.CFG_COLUMNS), cfg_u["rows"].shape[0])
    assert laym.shape == (len(ops.LAYER_FIELDS), lay["m"].shape[1])
    assert cfg.is_contiguous() and laym.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_kernels_match_plain_on_card(grid_name, port_nets, cuda_device):
    cfg_u, lay, segments = _port_operands(GRIDS[grid_name](), port_nets,
                                          device=cuda_device)
    before = ops.launch_counts()
    sums = torch.stack(ops.count_term_sums(cfg_u, lay, segments))
    layers = torch.stack(ops.count_term_layers(cfg_u, lay))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["count_terms"] == before["count_terms"] + 1
    assert after["count_layers"] == before["count_layers"] + 1
    _close(sums.cpu().numpy(),
           ref.count_term_sums_ref(cfg_u, lay, segments).cpu().numpy())
    _close(layers.cpu().numpy(),
           ref.count_term_layers_ref(cfg_u, lay).cpu().numpy())
