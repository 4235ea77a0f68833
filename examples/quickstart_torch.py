"""Quickstart on the PyTorch port: the paper's pipeline on the H100.

1. Simulate a CNN on an array-based accelerator (the Tool, §II).
2. Sweep the design space and find the near-optimal configs (§III/Table 5).
3. Distribute the layers over homogeneous cores with Algorithm II (§IV.B).
4. Design the heterogeneous chip of §IV.A over the 18 CNNs.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import collections

import numpy as np

from repro_torch.core import (accelerator, dse, energymodel, hetero,
                              partition, topology)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    dev = ap.parse_args(argv).device

    # --- 1. simulate ResNet50 on a [16,16] core ------------------------------
    cfg = accelerator.AcceleratorConfig(array_rows=16, array_cols=16,
                                        gb_psum_kb=54, gb_ifmap_kb=54)
    layers = topology.get_network("ResNet50")
    report = energymodel.simulate_network(cfg, layers, "ResNet50",
                                          device=dev)
    print(f"ResNet50 on {cfg.label()}:")
    print(f"  energy  {report.energy:.3e} pJ")
    print(f"  latency {report.latency:.3e} ns")
    print(f"  EDP     {report.edp:.3e}")

    # --- 2. design-space exploration ------------------------------------------
    sweep = dse.sweep_network(layers, "ResNet50", device=dev)
    best = sweep.argmin_cell("edp")
    print(f"\n150-point DSE minimum (EDP): {sweep.cell_label(best)}")
    boundary = dse.boundary_configs(sweep, bound=0.05)
    print(f"configs within 5% of optimum: {len(boundary)}")
    mean, mx = dse.edp_spread(sweep)
    print(f"EDP spread over the space: mean +{mean:.0f}%, max +{mx:.0f}% "
          "(Table 4)")

    # --- 3. Algorithm II: distribute layers over 3 homogeneous cores -----------
    p = partition.partition_network(report, 3)
    print(f"\nAlgorithm II over 3 cores: speedup {p.speedup:.2f}x "
          f"(ideal 3.0x)")
    print("  (l_initial, n_C):", p.table_row())

    # --- 4. §IV.A: 18 CNNs, 150-point space, 5% boundary, greedy cover ---------
    sweeps = dse.sweep_networks(
        {n: topology.get_network(n) for n in topology.NETWORKS}, device=dev)
    print(f"\nengine backend: {energymodel.last_backend()} on {dev}")
    chip = hetero.design_chip(sweeps, bound=0.05, max_cores=3)
    groups = collections.defaultdict(list)
    for net, i in chip.assignment.items():
        groups[i].append(net)
    print("=== heterogeneous chip (paper §IV.A) ===")
    for i in sorted(groups):
        print(f"core type {i} {chip.core_label(i)}: "
              f"{', '.join(sorted(groups[i]))}")
    sav = hetero.savings_summary(chip)
    es = [v["energy_saved"] for v in sav.values()]
    ed = [v["edp_saved"] for v in sav.values()]
    print(f"savings vs worst single core: energy up to {max(es):.0f}% "
          f"(mean {np.mean(es):.0f}%), EDP up to {max(ed):.0f}% "
          f"(mean {np.mean(ed):.0f}%)  [paper: up to 36% / 67%]")


if __name__ == "__main__":
    main()
