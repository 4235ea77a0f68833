"""Streamed DSE on the PyTorch port: the §IV.A chip from a streamed sweep,
then one per-layer pass over the 49,000-point mega grid.

1. Sweep the paper's 150-point space once densely and once streamed in
   chunks of 50 (``dse.stream_grid``): the greedy cover over the streamed
   boundary sets is the dense one (``hetero.design_chip_streaming`` against
   ``design_chip``), without the [n_cfg, n_net] matrices.
2. Stream ``mega_grid()`` (every ``--every``-th point) x 18 CNNs in
   per-layer mode (``dse.stream_layer_grid``): each network's top-8
   configs with their per-layer rows, the minima and the <=5% boundary
   sets, never the [n_cfg, n_net, n_layer] tensors.

    PYTHONPATH=src python examples/dse_stream_torch.py                # the card
    PYTHONPATH=src python examples/dse_stream_torch.py --device cpu --every 245
"""

import argparse
import collections
import time

import numpy as np

from repro_torch.core import accelerator, dse, energymodel, hetero, topology


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    ap.add_argument("--every", type=int, default=1,
                    help="stream every N-th point of the mega grid "
                         "(default: all 49,000)")
    args = ap.parse_args(argv)
    dev = args.device
    nets = {n: topology.get_network(n) for n in topology.NETWORKS}

    # --- 1. §IV.A from a streamed sweep -------------------------------------
    grid = accelerator.ConfigGrid.product()
    sweeps = dse.sweep_networks(nets, device=dev)
    chip = hetero.design_chip(sweeps, bound=0.05, max_cores=3)
    stream = dse.stream_grid(nets, grid, device=dev, chunk_size=50,
                             bound=0.05)
    print(f"engine backend: {energymodel.last_backend()} on {dev}")
    schip = hetero.design_chip_streaming(stream, grid, nets, max_cores=3)
    shape = next(iter(sweeps.values())).edp.shape
    same = (schip.core_cells(shape) == chip.core_types
            and schip.assignment == chip.assignment)
    print(f"streaming design_chip reproduces the cover: {same} "
          f"(boundary sets only, no [n_cfg, n_net] matrices)")
    groups = collections.defaultdict(list)
    for net, i in schip.assignment.items():
        groups[i].append(net)
    for i in sorted(groups):
        print(f"core type {i} {schip.core_label(i, grid)}: "
              f"{', '.join(sorted(groups[i]))}")

    # --- 2. one per-layer pass over the mega grid ---------------------------
    mega = accelerator.mega_grid()
    if args.every > 1:
        mega = mega.take(np.arange(0, mega.n, args.every))
    t0 = time.perf_counter()
    lt = dse.stream_layer_grid(nets, mega, device=dev, topk=8, bound=0.05)
    secs = time.perf_counter() - t0
    print(f"\nmega grid: {mega.n} points x {len(nets)} CNNs streamed per "
          f"layer in {secs:.2f} s ({energymodel.last_backend()} on {dev})")
    sizes = [lt.boundary_idx[nm].size for nm in lt.networks]
    print(f"<=5% boundary sets: {min(sizes)}-{max(sizes)} configs a "
          f"network; top-8 rows kept: {lt.layer_energy.shape}")
    for j, nm in enumerate(lt.networks[:4]):
        best = mega.config_at(int(lt.argmin[j]))
        print(f"  {nm}: EDP minimum {lt.min_metric[j]:.4e} at "
              f"{best.label()} ({lt.layer_counts[j]} layers)")


if __name__ == "__main__":
    main()
