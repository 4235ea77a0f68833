"""The port's count-terms kernels and their plain torch versions, held
against the JAX package's Pallas kernel (interpret mode, float64) and its
numpy engine (``energymodel._count_terms(np, ...)`` plus slice sums).

Tolerance: rtol 1e-12, atol 0 — the reference's own kernel tolerance
(``tests/test_count_terms_kernel.py``).  Only the segment sums' order
differs between the versions; every per-layer term is an integer or one
division, so zeros must match exactly.  On the card the kernels' integer
terms (all but 8 and 13) equal the plain version's bit for bit: integer
sums below 2^53 are exact in any order, which is what lets ``count_terms``
sum the mapping-level parts once per mapping row
(``test_kernel_decomposition_is_exact``).

The CUDA kernels run only on a card; their tests carry the ``cuda`` marker
and skip elsewhere (``python -m pytest -q -m cuda tests/test_torch_*.py``
on the card).
"""

import dataclasses
from types import SimpleNamespace

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
#: The two terms that divide by the active PEs; every other is an integer.
FLOAT_TERMS = (8, 13)
INT_TERMS = tuple(k for k in range(ops.N_TERMS) if k not in FLOAT_TERMS)
#: GB_psum sizes of the "psum_only" grid: 20 count rows, one mapping row
#: (more than one 16-row pass of a count_terms block).
PSUM_ONLY_KB = (1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987,
                1597, 2584, 4181, 6765, 10946)

GRIDS = {
    "paper150": lambda: ref_acc.ConfigGrid.product(),
    # unique-row counts that divide no block size (the Pallas edge padding)
    "odd_blocks": lambda: ref_acc.ConfigGrid.product(
        arrays=((12, 14), (16, 16), (64, 64)), gb_psum_kb=(13, 54, 216),
        gb_ifmap_kb=(27,)),
    "extended_sub": lambda: ref_acc.extended_grid().take(
        np.arange(0, 5400, 30)),
    # rows that differ only in GB_psum: one mapping row, many count rows
    "psum_only": lambda: ref_acc.ConfigGrid.product(
        arrays=((16, 16),), gb_psum_kb=PSUM_ONLY_KB, gb_ifmap_kb=(27,)),
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
    """The port's own heavy-stage operands for the same grid: segments,
    cfg_m, cfg_u, lay (float64 tensors) and inv_m."""
    lay, segments = em._stack_networks(nets, absorb_pad=absorb_pad)
    lay = {k: torch.as_tensor(v).to(device)[None, :] for k, v in lay.items()}
    cfg_m, cfg_u, inv_m, _, _ = em._prepare_fields(
        convert.grid_from_fields(grid.fields).fields, torch.device(device))
    return SimpleNamespace(segments=segments, cfg_m=cfg_m, cfg_u=cfg_u,
                           lay=lay, inv_m=inv_m)


def _sums_args(o):
    return o.segments, o.cfg_m, o.cfg_u, o.lay, o.inv_m


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
    """The port's own stacking and two-level dedup give the reference's
    operands: the same layers, segments and mapping rows, and the same
    count rows grouped by mapping row (the reference's rows sorted on the
    mapping columns, then GB_psum), with ``inv_m`` to match."""
    grid = GRIDS[grid_name]()
    r_cfg, r_lay, r_seg = _ref_operands(grid, ref_nets)
    o = _port_operands(grid, port_nets)
    assert o.segments == r_seg
    for k in r_lay:
        np.testing.assert_array_equal(o.lay[k].numpy(), r_lay[k])
    r_u = {k: v[:, 0] for k, v in r_cfg.items()}
    r_cfg_m, r_inv_m = ref_em._dedup_rows(r_u, ref_em._MAPPING_COLUMNS)
    grouped = np.lexsort([r_u[k] for k in reversed(
        ref_em._MAPPING_COLUMNS + ("gb_psum_words",))])
    assert tuple(o.cfg_u) == ref_em._COUNT_COLUMNS
    for k in r_cfg:
        np.testing.assert_array_equal(o.cfg_u[k].numpy()[:, 0],
                                      r_u[k][grouped])
    assert tuple(o.cfg_m) == ref_em._MAPPING_COLUMNS
    for k in r_cfg_m:
        np.testing.assert_array_equal(o.cfg_m[k].numpy()[:, 0], r_cfg_m[k])
    np.testing.assert_array_equal(o.inv_m.numpy(), r_inv_m[grouped])


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_rows_equals_numpy_unique(seed):
    """The port's lexsort dedup gives ``np.unique(axis=0)``'s unique rows,
    order and inverse, on rows with many repeats and ties in every
    column."""
    rng = np.random.default_rng(seed)
    cols = ("a", "b", "c")
    cfgs = {k: rng.integers(0, 4, 500).astype(np.float64) * 0.5
            for k in cols}
    cfgs["b"][:50] = -0.0
    uniq, inv = em._dedup_rows(cfgs, cols)
    want, want_inv = np.unique(np.stack([cfgs[k] for k in cols], 1), axis=0,
                               return_inverse=True)
    for i, k in enumerate(cols):
        np.testing.assert_array_equal(uniq[k], want[:, i])
    np.testing.assert_array_equal(inv, want_inv.reshape(-1))
    assert inv.dtype == np.int64


def test_prepare_fields_same_operands_for_both_backends(port_nets,
                                                        monkeypatch):
    """Both heavy stages receive the same two-level operands: the mapping
    dedup runs for the CUDA backend too, and its kernel gets what
    ``_term_sums_body`` gets."""
    grid = convert.grid_from_fields(GRIDS["odd_blocks"]().fields)
    lay_np, segments = em._stack_networks(port_nets)
    lay = {k: torch.as_tensor(v)[None, :] for k, v in lay_np.items()}
    seen, plain = {}, em._term_sums_body

    def spy(backend):
        def run(*args):
            seen[backend] = args
            return plain(*args)
        return run

    monkeypatch.setattr(em, "_cuda_term_sums", spy("cuda"))
    monkeypatch.setattr(em, "_term_sums_body", spy("torch"))
    outs = {b: em._eval_fields(grid.fields, lay, segments, b,
                               torch.device("cpu"))
            for b in ("cuda", "torch")}
    assert set(seen) == {"cuda", "torch"}
    (seg_c, m_c, u_c, lay_c, inv_c), (seg_t, m_t, u_t, lay_t, inv_t) = (
        seen["cuda"], seen["torch"])
    assert seg_c == seg_t and lay_c is lay_t
    assert tuple(m_c) == em._MAPPING_COLUMNS and m_c["rows"].shape[0] > 0
    for k in m_t:
        assert torch.equal(m_c[k], m_t[k])
    for k in u_t:
        assert torch.equal(u_c[k], u_t[k])
    assert torch.equal(inv_c, inv_t)
    assert m_c["rows"].shape[0] < u_c["rows"].shape[0]
    for e_c, e_t in zip(outs["cuda"], outs["torch"]):
        assert torch.equal(e_c, e_t)


def test_engine_marks_its_stages(port_nets, monkeypatch):
    """``evaluate_networks`` marks the end of each stage through
    ``energymodel._stage_hook`` (chip_smoke.py's host split times them), in
    order, the config stages once a chunk, and its outputs do not change
    with the hook set."""
    grid = convert.grid_from_fields(GRIDS["odd_blocks"]().fields)
    want = em.evaluate_networks(grid, port_nets, device="cpu")
    seen = []
    monkeypatch.setattr(em, "_stage_hook", seen.append)
    got = em.evaluate_networks(grid, port_nets, device="cpu")
    stages = ["layer stacking", "layer host-to-device", "config columns",
              "count dedup", "mapping dedup", "config host-to-device",
              "heavy stage", "gather-combine", "device-to-host"]
    assert seen == stages
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    seen.clear()
    em.evaluate_networks(grid, port_nets, device="cpu",
                         chunk_size=grid.n // 2 + 1)
    assert seen == stages[:2] + stages[2:] * 2


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_count_rows_grouped_by_mapping_row(grid_name, port_nets):
    """``_prepare_fields`` hands the kernel its count rows grouped by
    mapping row: ``inv_m`` never decreases and names every mapping row, and
    each config's count row holds that config's columns."""
    fields = convert.grid_from_fields(GRIDS[grid_name]().fields).fields
    cfg_m, cfg_u, inv_m, inv, _ = em._prepare_fields(
        fields, torch.device("cpu"))
    n_m = cfg_m["rows"].shape[0]
    assert bool((inv_m[1:] >= inv_m[:-1]).all())
    assert torch.equal(torch.unique(inv_m), torch.arange(n_m))
    for k in em._MAPPING_COLUMNS:
        assert torch.equal(cfg_u[k], cfg_m[k][inv_m])
    cfgs = em._cfg_struct_from_grid(fields)
    for k in em._COUNT_COLUMNS:
        np.testing.assert_array_equal(cfg_u[k][inv, 0].numpy(), cfgs[k])


@pytest.mark.parametrize("grid_name", ["paper150", "odd_blocks",
                                       "psum_only"])
def test_split_program_is_the_kernels_decomposition(grid_name, port_nets):
    """``ref.count_term_sums_split``, the kernel's decomposition as torch
    operations (what chip_smoke.py counts for its bound), equals the plain
    sums: the 12 integer terms bit for bit, terms 8 and 13 within rtol
    1e-12, zeros exact."""
    o = _port_operands(GRIDS[grid_name](), port_nets)
    got = ref.count_term_sums_split(*_sums_args(o))
    want = ref.count_term_sums_ref(*_sums_args(o))
    assert got.shape == want.shape
    assert torch.equal(got[list(INT_TERMS)], want[list(INT_TERMS)])
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid_name", ["paper150", "odd_blocks",
                                       "psum_only"])
def test_kernel_decomposition_is_exact(grid_name, port_nets):
    """What ``count_terms`` computes: the mapping-level segment sums once
    per mapping row, plus per count row the segment sums of
    A = inter_rounds · max(w_psum − GB_psum, 0) and
    B = inter_rounds · min(w_psum, GB_psum), give the plain sums' 12
    integer terms bit for bit: every value is an integer below 2^53, and
    A + B = inter_rounds · w_psum layer by layer."""
    o = _port_operands(GRIDS[grid_name](), port_nets)
    lay, inv_m = o.lay, o.inv_m
    n_m, n_l = o.cfg_m["rows"].shape[0], lay["m"].shape[1]
    if grid_name == "psum_only":
        assert (n_m, o.cfg_u["rows"].shape[0]) == (1, len(PSUM_ONLY_KB))

    def seg_sum(t):
        return torch.stack([t[..., a:b].sum(-1) for a, b in o.segments], -1)

    def exact_ints(t):
        return bool((t == t.round()).all() and (t.abs() < 2.0 ** 53).all())

    mp = em._mapping(o.cfg_m, lay)
    inter = torch.clamp(mp["n_c"] * mp["ky_serial"] - 1, min=0.0)
    w = mp["w_psum"]
    g = o.cfg_u["gb_psum_words"]
    a_u = inter[inv_m] * torch.clamp(w[inv_m] - g, min=0.0)
    b_u = inter[inv_m] * torch.minimum(w[inv_m], g)
    irw = inter * w
    assert all(exact_ints(t) for t in (a_u, b_u, irw, g))
    assert torch.equal(a_u + b_u, irw[inv_m])
    sum_a, sum_b = seg_sum(a_u), seg_sum(b_u)

    # every term but 0, 1, 3 and 11 is independent of GB_psum
    terms_m = em._count_terms(dict(o.cfg_m, gb_psum_words=torch.zeros_like(
        o.cfg_m["rows"])), lay, mp)
    got = [seg_sum(t.expand(n_m, n_l))[inv_m] for t in terms_m]
    m0 = seg_sum(lay["ifmap_words"] + lay["weight_words"])
    m1 = seg_sum(lay["ofmap_words"])
    got[0], got[1] = m0 + sum_a, m1 + sum_a
    got[3], got[11] = 2.0 * (sum_b + m1), sum_b + m1
    want = em._term_sums_body(o.segments, o.cfg_m, o.cfg_u, lay, inv_m)
    for k in INT_TERMS:
        assert exact_ints(terms_m[k]), k
        assert torch.equal(got[k], want[k].expand_as(got[k])), k
    for k in FLOAT_TERMS:
        _close(got[k].numpy(), want[k].expand_as(got[k]).numpy())


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
    out = ref.count_term_sums_ref(
        *_sums_args(_port_operands(grid, port_nets))).numpy()
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
    o = _port_operands(grid, port_nets, absorb_pad=False)
    out = ref.count_term_layers_ref(o.cfg_u, o.lay).numpy()
    _close(out, pal)
    np.testing.assert_array_equal(out, _numpy_layers(r_cfg, r_lay))


def test_pad_layers_give_zero_terms(port_nets):
    """Layer pad columns are exactly 0.0 in every term, so the aggregate
    kernel may sum them into the last network."""
    o = _port_operands(GRIDS["odd_blocks"](), port_nets, absorb_pad=False)
    total = o.segments[-1][1]
    assert o.lay["m"].shape[1] > total
    out = ref.count_term_layers_ref(o.cfg_u, o.lay)
    assert bool((out[..., total:] == 0).all())


def test_wrappers_run_plain_versions_on_cpu(port_nets):
    """On CPU tensors the wrappers return the plain versions' values and
    launch nothing."""
    o = _port_operands(GRIDS["odd_blocks"](), port_nets)
    ops.reset_launch_counts()
    sums = torch.stack(ops.count_term_sums(*_sums_args(o)))
    layers = torch.stack(ops.count_term_layers(o.cfg_u, o.lay))
    assert torch.equal(sums, ref.count_term_sums_ref(*_sums_args(o)))
    assert torch.equal(layers, ref.count_term_layers_ref(o.cfg_u, o.lay))
    assert ops.launch_counts() == {"count_terms": 0, "count_layers": 0}


def test_operand_checks(port_nets):
    o = _port_operands(GRIDS["odd_blocks"](), port_nets)
    cfg_u, lay = o.cfg_u, o.lay
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
    # count_term_sums passes the columns' addresses, copying only a column
    # that is not contiguous
    keep = []
    ptrs = ops._addresses(o.cfg_m, ops.MAP_COLUMNS, None, keep)
    assert ptrs == [o.cfg_m[k].data_ptr() for k in ops.MAP_COLUMNS]
    assert keep == []
    strided = dict(lay, m=torch.stack([lay["m"], lay["m"]], -1)[..., 0])
    assert not strided["m"].is_contiguous()
    ptrs = ops._addresses(strided, ops.LAYER_FIELDS, (1, lay["m"].shape[1]),
                          keep)
    assert len(keep) == 1 and torch.equal(keep[0], lay["m"])
    assert ptrs[1] == keep[0].data_ptr()
    with pytest.raises(ValueError, match="shape"):
        ops._addresses(dict(o.cfg_m, cols=o.cfg_m["cols"][:1]),
                       ops.MAP_COLUMNS, None, [])
    n_l = laym.shape[1]
    assert ops._check_segments([(0, 3), (3, 3)], n_l) == ((0, 3), (3, 3))
    for bad in ((), ((2, 1),), ((0, n_l + 1),), ((-1, 2),)):
        with pytest.raises(ValueError, match="segments"):
            ops._check_segments(bad, n_l)
    # the launch argument: 248 bytes of addresses and sizes, then the
    # segments as int32 pairs padded with zeros to MAX_NETS
    assert ops._LAUNCH.size + ops._SEGMENTS.size == 248 + 8 * ops.MAX_NETS
    words = np.frombuffer(ops._segment_words(((0, 3), (3, 7))), np.int32)
    assert words.shape == (2 * ops.MAX_NETS,)
    assert list(words[:4]) == [0, 3, 3, 7] and not words[4:].any()
    # the count rows must come grouped by mapping row
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.count_term_sums(o.segments, o.cfg_m, o.cfg_u, lay,
                            o.inv_m.flip(0))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _bit_equal_where_exact(sums, want, layers, segments):
    """``sums`` [14, n_u, n_net] against the plain ``want``: bit for bit in
    each (term, count row, network) whose per-layer values over the
    segment (``layers`` [14, n_u, L], the plain version) are integers with
    magnitudes summing below 2^53, within rtol 1e-12 (zeros exact)
    everywhere.  → the [14, n_u, n_net] mask of the cells held bit for
    bit."""
    whole = layers == layers.round()
    mask = torch.stack([whole[..., a:b].all(-1)
                        & (layers[..., a:b].abs().sum(-1) < 2.0 ** 53)
                        for a, b in segments], -1)
    assert torch.equal(sums[mask], want[mask])
    _close(sums.cpu().numpy(), want.cpu().numpy())
    return mask


def _two_level(cfg_u_np, lay_np, segments, dev):
    """Operands of ``count_term_sums`` from numpy count rows [n_u] (unique)
    and layer columns [L]: the count rows grouped by mapping row, as the
    engine groups them."""
    cfg_u_np, _ = em._dedup_count_rows(cfg_u_np)
    cfg_m, inv_m = em._dedup_rows(cfg_u_np, em._MAPPING_COLUMNS)

    def put(cols):
        return {k: torch.as_tensor(np.asarray(v, np.float64),
                                   device=dev)[:, None]
                for k, v in cols.items()}
    lay = {k: torch.as_tensor(np.asarray(v, np.float64), device=dev)[None, :]
           for k, v in lay_np.items()}
    return SimpleNamespace(segments=segments, cfg_m=put(cfg_m),
                           cfg_u=put(cfg_u_np), lay=lay,
                           inv_m=torch.as_tensor(inv_m, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_kernels_match_plain_on_card(grid_name, port_nets, cuda_device):
    o = _port_operands(GRIDS[grid_name](), port_nets, device=cuda_device)
    before = ops.launch_counts()
    sums = torch.stack(ops.count_term_sums(*_sums_args(o)))
    layers = torch.stack(ops.count_term_layers(o.cfg_u, o.lay))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["count_terms"] == before["count_terms"] + 1
    assert after["count_layers"] == before["count_layers"] + 1
    plain_layers = ref.count_term_layers_ref(o.cfg_u, o.lay)
    assert torch.equal(layers, plain_layers)
    exact = _bit_equal_where_exact(
        sums, ref.count_term_sums_ref(*_sums_args(o)), plain_layers,
        o.segments)
    assert bool(exact[list(INT_TERMS)].all())


@pytest.mark.cuda
def test_adversarial_operands_on_card(cuda_device):
    """Quotients exactly at integers, dividends of 0, values near 2^40,
    non-integer word counts and shapes (among them the floor and ceiling
    corrections: 1675.160959435283 / 7.755374812200385 rounds up to 216,
    103.78034770693813 / 2.117966279733431 down to 49): ``count_layers``
    equals the plain version bit for bit, ``count_terms`` wherever the
    terms are exact integers."""
    big = 2.0 ** 40
    cfg_u = dict(
        rows=[16, 16, 12, 16, 64, 1, 2.117966279733431, 12],
        cols=[16, 16, 14, 16, 64, 1, 8, 14],
        gb_ifmap_words=[27648, 0, 81, 1e6, big + 1, 0, big, 81],
        gb_psum_words=[27648, 0, 6912, 1, 3, 0, big, 6912],
        rf_ifmap_words=[12, 12, 12, 12, 12, 0, 12, 12.5],
        rf_weight_words=[224, 0, 224, 224, big, 0, 1675.160959435283,
                         224.5],
        rf_psum_words=[16, 16, 16, 16, 16, 0, 16, 16.5])
    # layers 0-2 integer and ordinary, 3 near 2^40, 4 depthwise, 5 pool,
    # 6 a 1x1 plane, 7 non-integer
    lay = dict(
        c_ch=[3, 96, 16, 2 ** 20, 1, 64, 512, 103.78034770693813],
        m=[96, 256, 16, 2 ** 20, 1, 64, 512, 7],
        ky=[11, 5, 16, 3, 3, 2, 1, 103.78034770693813],
        kx=[11, 5, 16, 3, 3, 2, 1, 7.755374812200385],
        stride=[4, 1, 1, 1, 1, 2, 1, 1],
        ix=[227, 27, 12, 2 ** 10, 14, 28, 7, 9],
        iy=[227, 27, 12, 2 ** 10, 14, 28, 7, 9],
        oy=[55, 27, 12, 2 ** 10, 12, 14, 7, 9],
        ox=[55, 27, 12, 2 ** 10, 12, 14, 7, 9],
        macs=[105415200, 447897600, 0, big, 1296, 0, big, 5.5],
        weight_words=[34848, 614400, 0, 2 ** 30, 9, 0, big, 1.5],
        ifmap_words=[154587, 69984, 0, 2 ** 30, 196, 50176, big, 2.5],
        ofmap_words=[290400, 186624, 0, 2 ** 30, 144, 12544, big, 3.5],
        is_acc=[1, 1, 1, 1, 0, 0, 1, 1],
        is_dw=[0, 0, 0, 0, 1, 0, 0, 0],
        is_pool=[0, 0, 0, 0, 0, 1, 0, 0])
    segments = ((0, 3), (3, 3), (3, 8), (0, 8))
    o = _two_level({k: np.asarray(v, np.float64) for k, v in cfg_u.items()},
                   lay, segments, cuda_device)
    layers = torch.stack(ops.count_term_layers(o.cfg_u, o.lay))
    plain_layers = ref.count_term_layers_ref(o.cfg_u, o.lay)
    assert torch.equal(layers, plain_layers)
    sums = torch.stack(ops.count_term_sums(*_sums_args(o)))
    exact = _bit_equal_where_exact(
        sums, ref.count_term_sums_ref(*_sums_args(o)), plain_layers,
        segments)
    integer_rows = [u for u in range(o.inv_m.shape[0])
                    if all(float(v[u]) == round(float(v[u]))
                           for v in o.cfg_u.values())]
    assert len(integer_rows) >= 5
    assert bool(exact[list(INT_TERMS)][:, integer_rows, :2].all())
    assert bool((sums[:, :, 1] == 0).all())      # the empty segment


@pytest.mark.cuda
def test_single_row_and_empty_segment_on_card(port_nets, cuda_device):
    """n_u = n_m = 1 and an empty segment, through the engine's operands."""
    grid = GRIDS["paper150"]().take(np.array([7]))
    o = _port_operands(grid, port_nets, device=cuda_device)
    assert o.cfg_m["rows"].shape[0] == o.inv_m.shape[0] == 1
    a, b = o.segments[1]
    o.segments = o.segments + ((a, a),)
    sums = torch.stack(ops.count_term_sums(*_sums_args(o)))
    want = ref.count_term_sums_ref(*_sums_args(o))
    assert sums.shape == (ops.N_TERMS, 1, len(o.segments))
    plain_layers = ref.count_term_layers_ref(o.cfg_u, o.lay)
    exact = _bit_equal_where_exact(sums, want, plain_layers, o.segments)
    assert bool(exact[list(INT_TERMS)].all())
    assert bool((sums[..., -1] == 0).all())


@pytest.mark.cuda
def test_more_networks_than_one_launch_takes_on_card(port_nets, cuda_device):
    """Beyond ``MAX_NETS`` segments a call takes one launch for each
    ``MAX_NETS``, each writing its own networks' columns."""
    o = _port_operands(GRIDS["odd_blocks"](), port_nets, device=cuda_device)
    o.segments = tuple(o.segments[i % len(o.segments)]
                       for i in range(ops.MAX_NETS + 44))
    before = ops.launch_counts()["count_terms"]
    sums = torch.stack(ops.count_term_sums(*_sums_args(o)))
    assert ops.launch_counts()["count_terms"] == before + 2
    want = ref.count_term_sums_ref(*_sums_args(o))
    plain_layers = ref.count_term_layers_ref(o.cfg_u, o.lay)
    exact = _bit_equal_where_exact(sums, want, plain_layers, o.segments)
    assert bool(exact[list(INT_TERMS)].all())


@pytest.mark.cuda
def test_same_bits_on_second_call_without_sync(port_nets, cuda_device):
    """A second call gives the same bits, and the host path of a call
    neither synchronises nor copies to the host before its launch."""
    o = _port_operands(GRIDS["psum_only"](), port_nets, device=cuda_device)
    first = torch.stack(ops.count_term_sums(*_sums_args(o)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = torch.stack(ops.count_term_sums(*_sums_args(o)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, second)
    layers = torch.stack(ops.count_term_layers(o.cfg_u, o.lay))
    assert torch.equal(layers,
                       torch.stack(ops.count_term_layers(o.cfg_u, o.lay)))
