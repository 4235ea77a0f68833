"""Per-layer chip + schedule co-design (§IV.A × §IV.B) on the PyTorch port.

Which heterogeneous 4-core chip, and which layer→core schedule on it, for
all 18 CNNs at once: one sweep of the paper's 150-point space ranks the
configurations, the candidate pool is the greedy cover of the ≤5%
boundary sets topped up to 6 types, one per-layer engine call evaluates
the pool, and one batched solve (``partition.batch_schedule_hetero``)
schedules every (candidate chip × network) problem.  Then the same chip
from a streamed pool (``hetero.co_design_streaming``, chunks of 50):
boundary sets and top-k from one per-layer pass, no [n_cfg, n_net]
matrices.

    PYTHONPATH=src python examples/codesign_torch.py                # the card
    PYTHONPATH=src python examples/codesign_torch.py --device cpu
"""

import argparse
import time

from repro_torch.core import accelerator, energymodel, hetero, topology


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    grid = accelerator.ConfigGrid.product()
    nets = {n: topology.get_network(n) for n in topology.NETWORKS}

    print("=== per-layer chip + schedule co-design (§IV.A × §IV.B) ===")
    t0 = time.perf_counter()
    cd = hetero.co_design(grid, nets, m_cores=4, max_types=3, pool_size=6,
                          device=dev)
    secs = time.perf_counter() - t0
    print(f"engine backend: {energymodel.last_backend()} on {dev}; "
          f"{secs:.2f} s")
    print(f"co-designed chip ({cd.n_chips} candidates searched): "
          f"{cd.summary(grid)}")
    print(f"mean normalized EDP {cd.score:.3f} vs best homogeneous "
          f"{cd.homogeneous_score:.3f} "
          f"({(1 - cd.score / cd.homogeneous_score) * 100:.1f}% better)")
    for net in ("ResNet50", "MobileNetV2", "VGG16"):
        s = cd.schedules[net]
        moves = sum(1 for a, b in zip(s.layer_core, s.layer_core[1:])
                    if a != b)
        print(f"  {net}: {s.n_layers} layers over {s.n_cores} cores "
              f"({len(set(s.layer_type))} type(s)), pipeline speedup "
              f"{s.speedup:.2f}x, {moves} core hand-offs")

    print("\n=== the same search from a streamed pool (chunks of 50) ===")
    sd = hetero.co_design_streaming(grid, nets, m_cores=4, max_types=3,
                                    pool_size=6, device=dev, chunk_size=50)
    same = (sd.pool == cd.pool and sd.core_types == cd.core_types
            and sd.core_counts == cd.core_counts)
    print(f"streamed chip: {sd.summary(grid)}; pool and chip equal to the "
          f"dense search: {same}")


if __name__ == "__main__":
    main()
