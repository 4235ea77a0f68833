"""The port's DSE statistics, §IV.A chip and Algorithm II against the JAX
package's, on the same inputs (the reference's numpy backend and its
numpy partition solver).

The statistics and the chip are numpy over the engine's outputs, which
agree at rtol 1e-12; the chip's choices and the partitions must be
identical.
"""

import dataclasses
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import accelerator as ref_acc
from repro.core import dse as ref_dse
from repro.core import energymodel as ref_em
from repro.core import hetero as ref_hetero
from repro.core import partition as ref_part
from repro.core import topology as ref_topo
from repro_torch.core import (accelerator, convert, dse, energymodel,
                              hetero, partition)

NETS = ("AlexNet", "VGG16", "MobileNet", "ResNet50", "DenseNet121",
        "Xception")
RTOL = 1e-12
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref_nets():
    return {n: ref_topo.get_network(n) for n in NETS}


@pytest.fixture(scope="module")
def port_nets(ref_nets):
    return convert.networks_from_dicts(
        {n: [dataclasses.asdict(l) for l in v] for n, v in ref_nets.items()})


@pytest.fixture(scope="module")
def sweeps(ref_nets, port_nets):
    return (ref_dse.sweep_networks(ref_nets, backend="numpy"),
            dse.sweep_networks(port_nets, device="cpu"))


def test_sweep_and_table_statistics(sweeps):
    ref_sw, port_sw = sweeps
    assert list(port_sw) == list(ref_sw)
    for name, r in ref_sw.items():
        p = port_sw[name]
        assert (p.arrays, p.psum_kb, p.ifmap_kb) == \
            (r.arrays, r.psum_kb, r.ifmap_kb)
        np.testing.assert_allclose(p.energy, r.energy, rtol=RTOL, atol=0)
        np.testing.assert_allclose(p.latency, r.latency, rtol=RTOL, atol=0)
        assert p.argmin_cell() == r.argmin_cell()
        assert p.cell_label(p.argmin_cell()) == r.cell_label(r.argmin_cell())
        assert dse.boundary_configs(p, 0.05) == \
            ref_dse.boundary_configs(r, 0.05)
        for swept in ("ifmap", "psum"):
            mp, mr = dse.mu_delta(p, swept), ref_dse.mu_delta(r, swept)
            assert mp.keys() == mr.keys()
            np.testing.assert_allclose([mp[k] for k in mp],
                                       [mr[k] for k in mr], rtol=1e-9)
        dp, dr = dse.delta_whole_space(p), ref_dse.delta_whole_space(r)
        np.testing.assert_allclose([dp[k] for k in dp], [dr[k] for k in dr],
                                   rtol=1e-9)
        np.testing.assert_allclose(dse.edp_spread(p), ref_dse.edp_spread(r),
                                   rtol=1e-9)


def test_sweep_network_and_layer_metrics(ref_nets, port_nets):
    r = ref_dse.sweep_network(ref_nets["ResNet50"], "ResNet50",
                              backend="numpy")
    p = dse.sweep_network(port_nets["ResNet50"], "ResNet50", device="cpu")
    np.testing.assert_allclose(p.edp, r.edp, rtol=RTOL)
    grid = ref_acc.extended_grid().take(np.arange(0, 5400, 60))
    e0, t0 = ref_dse.layer_metrics(ref_nets, grid, backend="numpy")
    e1, t1 = dse.layer_metrics(port_nets, convert.grid_from_fields(
        grid.fields), device="cpu")
    np.testing.assert_array_equal(e1, e0)
    np.testing.assert_array_equal(t1, t0)


@pytest.mark.parametrize("max_cores", [2, 3, 4])
def test_design_chip_identical(sweeps, max_cores):
    ref_sw, port_sw = sweeps
    rc = ref_hetero.design_chip(ref_sw, bound=0.05, max_cores=max_cores)
    pc = hetero.design_chip(port_sw, bound=0.05, max_cores=max_cores)
    assert pc.core_types == rc.core_types
    assert pc.assignment == rc.assignment
    assert pc.candidate_sets == rc.candidate_sets
    assert [pc.core_label(i) for i in range(len(pc.core_types))] == \
        [rc.core_label(i) for i in range(len(rc.core_types))]
    sp, sr = hetero.savings_summary(pc), ref_hetero.savings_summary(rc)
    assert sp.keys() == sr.keys()
    for n in sr:
        for k in ("energy_saved", "edp_saved"):
            np.testing.assert_allclose(sp[n][k], sr[n][k], rtol=1e-12,
                                       atol=1e-12)
    for n in NETS:
        for other in range(len(rc.core_types)):
            a = hetero.cross_penalty(pc, n, other)
            b = ref_hetero.cross_penalty(rc, n, other)
            np.testing.assert_allclose([a[k] for k in b], list(b.values()),
                                       rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def latencies(ref_nets, port_nets):
    """Per-layer latencies of every network on one core, from the port."""
    cfg = accelerator.AcceleratorConfig(array_rows=16, array_cols=16)
    return {n: energymodel.simulate_network(cfg, port_nets[n], n,
                                            device="cpu").layer_latencies
            for n in NETS}


def _same(a, b):
    """Every field of two Partitions (of either package) exactly equal."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b), (a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_partitioners_bit_exact(latencies, k):
    for n, lat in latencies.items():
        _same(partition.bb_partition(lat, k), ref_part.bb_partition(lat, k))
        _same(partition.dp_partition(lat, k), ref_part.dp_partition(lat, k))
    small = latencies["AlexNet"][:9]
    _same(partition.brute_force_partition(small, min(k, 4)),
          ref_part.brute_force_partition(small, min(k, 4)))


def test_batch_partition_bit_exact(latencies):
    lats = list(latencies.values())
    ks = tuple(range(1, 11))
    mine = partition.batch_partition(lats, ks)
    theirs = ref_part.batch_partition(lats, ks, use_jax=False)
    assert [list(d) for d in mine] == [list(d) for d in theirs]
    for i, lat in enumerate(lats):
        for k in ks:
            _same(mine[i][k], theirs[i][k])
            assert mine[i][k].pipeline_latency == \
                ref_part.dp_partition(lat, k).pipeline_latency
    for a, b in zip(partition.batch_partition(lats, 3),
                    ref_part.batch_partition(lats, 3, use_jax=False)):
        _same(a[3], b[3])


def test_partition_network(ref_nets, port_nets):
    cfg = dict(array_rows=16, array_cols=16, gb_psum_kb=54, gb_ifmap_kb=54)
    rr = ref_em.simulate_network(ref_acc.AcceleratorConfig(**cfg),
                                 ref_nets["ResNet50"], "ResNet50")
    pr = energymodel.simulate_network(accelerator.AcceleratorConfig(**cfg),
                                      port_nets["ResNet50"], "ResNet50",
                                      device="cpu")
    for method in ("bb", "dp"):
        p = partition.partition_network(pr, 3, method)
        q = ref_part.partition_network(rr, 3, method)
        _same(p, q)
        assert p.table_row() == q.table_row()


def test_quickstart_runs_on_cpu(capsys, monkeypatch):
    """examples/quickstart_torch.py end to end with --device cpu."""
    monkeypatch.setattr(sys, "argv", ["quickstart_torch.py", "--device",
                                      "cpu"])
    runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "engine backend: torch on cpu" in out
    assert "Algorithm II over 3 cores" in out
    assert "heterogeneous chip (paper §IV.A)" in out
    assert "[paper: up to 36% / 67%]" in out
