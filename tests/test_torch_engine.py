"""The port's engine (``repro_torch.core``) against the JAX package's numpy
engine on the same inputs, carried across by ``convert``.

Tolerance: rtol 1e-12 (``SHADOW_RTOL`` of ``repro/ft/verify.py``).  The
port and the reference differ only in the order of the per-network layer
sums, so the per-layer outputs agree exactly.  The reference's jax and
pallas backends are not used here; its numpy backend is the yardstick.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import accelerator as ref_acc
from repro.core import energymodel as ref_em
from repro.core import topology as ref_topo
from repro_torch.core import accelerator, convert, energymodel as em, topology

NETS = ("AlexNet", "MobileNet", "ResNet50", "DenseNet121", "InceptionV3",
        "NASNetMobile")
RTOL = 1e-12

GRIDS = {
    "paper150": lambda: ref_acc.ConfigGrid.product(),
    "extended_sub": lambda: ref_acc.extended_grid().take(
        np.arange(0, 5400, 30)),
}

MODES = {
    "aggregate": dict(),
    "per_layer": dict(per_layer=True),
    "chunked": dict(chunk_size=50),
    "chunked_per_layer": dict(chunk_size=50, per_layer=True),
}


@pytest.fixture(scope="module")
def ref_nets():
    return {n: ref_topo.get_network(n) for n in NETS}


@pytest.fixture(scope="module")
def port_nets(ref_nets):
    return convert.networks_from_dicts(
        {n: [dataclasses.asdict(l) for l in v] for n, v in ref_nets.items()})


def test_topology_copy_equals_reference():
    """The port's own topology builds all 18 networks layer by layer as
    the reference does."""
    assert list(topology.NETWORKS) == list(ref_topo.NETWORKS)
    for name in ref_topo.NETWORKS:
        mine = topology.get_network(name)
        theirs = ref_topo.get_network(name)
        assert [dataclasses.asdict(l) for l in mine] == \
            [dataclasses.asdict(l) for l in theirs], name
        assert [(l.macs, l.weight_words, l.ifmap_words, l.ofmap_words)
                for l in mine] == [(l.macs, l.weight_words, l.ifmap_words,
                                    l.ofmap_words) for l in theirs], name


@pytest.mark.parametrize("name", ["product", "extended_grid", "mega_grid"])
def test_accelerator_copy_equals_reference(name):
    mine = (accelerator.ConfigGrid.product() if name == "product"
            else getattr(accelerator, name)())
    theirs = (ref_acc.ConfigGrid.product() if name == "product"
              else getattr(ref_acc, name)())
    assert accelerator.GRID_COLUMNS == ref_acc.GRID_COLUMNS
    assert mine.n == theirs.n
    for k in ref_acc.GRID_COLUMNS:
        np.testing.assert_array_equal(mine.fields[k], theirs.fields[k])
    assert mine.config_at(17) == convert.grid_from_fields(
        theirs.fields).config_at(17)


def test_convert_round_trip(ref_nets, port_nets):
    g = ref_acc.extended_grid().take(np.arange(0, 5400, 97))
    pg = convert.grid_from_fields(g.fields)
    assert isinstance(pg, accelerator.ConfigGrid)
    assert all(np.array_equal(pg.fields[k], g.fields[k])
               for k in ref_acc.GRID_COLUMNS)
    pg.fields["rows"][0] = -1.0          # a copy, not a view
    assert g.fields["rows"][0] > 0
    for n in NETS:
        assert all(isinstance(l, topology.Layer) for l in port_nets[n])
        assert [dataclasses.asdict(l) for l in port_nets[n]] == \
            [dataclasses.asdict(l) for l in ref_nets[n]]
    bad = dict(g.fields, rows=np.where(np.arange(g.n) == 3, np.nan,
                                       g.fields["rows"]))
    with pytest.raises(ValueError, match="rows.*row 3"):
        convert.grid_from_fields(bad)


def test_stacked_networks_equal_reference(ref_nets, port_nets):
    for absorb in (True, False):
        r_lay, r_seg = ref_em._stack_networks(ref_nets, absorb_pad=absorb)
        p_lay, p_seg = em._stack_networks(port_nets, absorb_pad=absorb)
        assert p_seg == r_seg
        assert p_lay.keys() == r_lay.keys()
        for k in r_lay:
            np.testing.assert_array_equal(p_lay[k], r_lay[k])
    np.testing.assert_array_equal(em.network_layer_counts(port_nets),
                                  ref_em.network_layer_counts(ref_nets))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_evaluate_networks_matches_numpy_reference(grid_name, mode, ref_nets,
                                                   port_nets):
    grid = GRIDS[grid_name]()
    kw = MODES[mode]
    e0, t0 = ref_em.evaluate_networks(grid, ref_nets, backend="numpy", **kw)
    e1, t1 = em.evaluate_networks(convert.grid_from_fields(grid.fields),
                                  port_nets, device="cpu", **kw)
    assert em.last_backend() == "torch"
    assert e1.shape == e0.shape and e1.dtype == np.float64
    np.testing.assert_allclose(e1, e0, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(t1, t0, rtol=RTOL, atol=0.0)
    if kw.get("per_layer"):
        np.testing.assert_array_equal(e1, e0)
        np.testing.assert_array_equal(t1, t0)


def test_per_layer_sums_reproduce_aggregate(port_nets):
    grid = accelerator.extended_grid().take(np.arange(0, 5400, 45))
    e, t = em.evaluate_networks(grid, port_nets, device="cpu")
    el, tl = em.evaluate_networks(grid, port_nets, device="cpu",
                                  per_layer=True)
    counts = em.network_layer_counts(port_nets)
    assert el.shape == (grid.n, len(port_nets), counts.max())
    for j, c in enumerate(counts):
        assert not el[:, j, c:].any()
    np.testing.assert_allclose(el.sum(-1), e, rtol=RTOL)
    np.testing.assert_allclose(tl.sum(-1), t, rtol=RTOL)


@pytest.mark.parametrize("net", ["ResNet50", "MobileNet", "InceptionV3"])
def test_simulate_network_matches_reference_field_by_field(net, ref_nets,
                                                           port_nets):
    kws = (dict(array_rows=16, array_cols=16, gb_psum_kb=54, gb_ifmap_kb=54),
           dict(array_rows=12, array_cols=14, gb_psum_kb=13, gb_ifmap_kb=216,
                rf_psum_words=16, noc_words_per_cycle=2.0))
    for kw in kws:
        r0 = ref_em.simulate_network(ref_acc.AcceleratorConfig(**kw),
                                     ref_nets[net], net)
        r1 = em.simulate_network(accelerator.AcceleratorConfig(**kw),
                                 port_nets[net], net, device="cpu")
        assert (r1.name, r1.energy, r1.latency) == \
            (r0.name, r0.energy, r0.latency)
        assert len(r1.layers) == len(r0.layers)
        for a, b in zip(r1.layers, r0.layers):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        np.testing.assert_array_equal(r1.layer_latencies, r0.layer_latencies)


def test_simulate_network_agrees_with_batched_engine(port_nets):
    grid = accelerator.ConfigGrid.product()
    e, t = em.evaluate_networks(grid, port_nets, device="cpu")
    for i in (0, 77, 149):
        for j, (name, layers) in enumerate(port_nets.items()):
            rep = em.simulate_network(grid.config_at(i), layers, name,
                                      device="cpu")
            np.testing.assert_allclose(rep.energy, e[i, j], rtol=RTOL)
            np.testing.assert_allclose(rep.latency, t[i, j], rtol=RTOL)


def test_simulate_grid_matches_reference(ref_nets, port_nets):
    cfgs = [ref_acc.AcceleratorConfig(array_rows=r, array_cols=c,
                                      gb_psum_kb=p)
            for r, c in ((16, 16), (32, 32)) for p in (13, 108)]
    e0, t0 = ref_em.simulate_grid(cfgs, ref_nets["AlexNet"],
                                  backend="numpy")
    e1, t1 = em.simulate_grid(
        [accelerator.AcceleratorConfig(**dataclasses.asdict(c)
                                       | {"energy": accelerator.EnergyTable()})
         for c in cfgs], port_nets["AlexNet"], device="cpu")
    np.testing.assert_allclose(e1, e0, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(t1, t0, rtol=RTOL, atol=0.0)


def test_input_validation_at_engine_boundary(port_nets):
    layers = list(port_nets["AlexNet"])
    layers[3] = dataclasses.replace(layers[3], c_in=0)
    with pytest.raises(ValueError, match="layer 2 field 'c_ch'"):
        em.evaluate_networks(accelerator.ConfigGrid.product(),
                             {"bad": layers}, device="cpu")
    with pytest.raises(ValueError, match="at least one network"):
        em.evaluate_networks(accelerator.ConfigGrid.product(), {},
                             device="cpu")


def test_backend_resolution():
    cpu = torch.device("cpu")
    assert em.resolve_backend(None, cpu) == "torch"
    assert em.resolve_backend("torch", cpu) == "torch"
    assert em.resolve_backend(None, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        em.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="backend must be one of"):
        em.resolve_backend("numpy", cpu)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        em.resolve_device("meta")
