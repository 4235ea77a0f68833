"""Per-layer chip + schedule co-design (§IV.A × §IV.B) on the PyTorch port.

Which heterogeneous 4-core chip, and which layer→core schedule on it, for
all 18 CNNs at once: one sweep of the paper's 150-point space ranks the
configurations, the candidate pool is the greedy cover of the ≤5%
boundary sets topped up to 6 types, one per-layer engine call evaluates
the pool, and one batched solve (``partition.batch_schedule_hetero``)
schedules every (candidate chip × network) problem.  Then the same chip
from a streamed pool (``hetero.co_design_streaming``, chunks of 50):
boundary sets and top-k from one per-layer pass, no [n_cfg, n_net]
matrices.  On that streamed problem set: the latency-bound Pareto sweep
(``hetero.pareto_codesign``, every chip against 8 deadlines at once),
the energy-aware deadline-slack schedules (``slack=True``), one chip
under the second of those deadlines (``hetero.score_codesign``), and the
co-design under hardware faults (``hetero.resilience_codesign``: a lost
core or a PE array with 4 rows and 4 columns disabled on each type slot,
the degraded pools evaluated per layer on the card).

    PYTHONPATH=src python examples/codesign_torch.py                # the card
    PYTHONPATH=src python examples/codesign_torch.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.core import (accelerator, energymodel, hetero, partition,
                              topology)


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

    # --- latency-bound Pareto sweep: every chip against ALL deadlines ----
    print("\n=== latency-bound Pareto co-design (streamed pool) ===")
    probs = hetero.codesign_problems_streaming(grid, nets, m_cores=4,
                                               max_types=3, pool_size=6,
                                               device=dev, chunk_size=50)
    res = partition.batch_schedule_hetero(probs.lat_dense, probs.counts,
                                          n_layers=probs.n_layers_b)
    pc = hetero.pareto_codesign(probs, res, n_deadlines=8)
    print(f"{pc.n_chips} chips x {len(nets)} networks x "
          f"{pc.deadlines.size} deadlines (x min single-core latency):")
    for di, (d, c) in enumerate(zip(pc.deadlines, pc.best_chip)):
        if c < 0:
            print(f"  deadline {d:.2f}: no chip feasible")
        else:
            print(f"  deadline {d:.2f}: chip {int(c)} "
                  f"({pc.chip_summary(int(c), grid)}), "
                  f"mean norm energy {pc.scores[int(c), di]:.3f}")
    net = "ResNet50"
    print(f"Pareto frontier for {net} (latency ns, energy pJ):")
    for c, lat, en in pc.frontier(net)[:5]:
        print(f"  chip {c}: latency {lat:.3e}, energy {en:.3e}")

    # --- energy-aware deadline slack: spend latency headroom on energy ---
    # layers migrate to lower-energy core types while the pipeline stays
    # under each deadline (bit-exact against partition.slack_schedule_oracle)
    print("\n=== energy-aware deadline-slack scheduling ===")
    ps = hetero.pareto_codesign(probs, res, n_deadlines=8, slack=True)
    moved = int(ps.slack_moves.sum())
    saved = 100.0 * (1.0 - np.nanmean(
        np.where(np.isfinite(ps.slack_energy)
                 & np.isfinite(ps.energy)[:, :, None],
                 ps.slack_energy / ps.energy[:, :, None], np.nan)))
    print(f"{moved} layer moves across "
          f"{ps.n_chips} chips x {len(nets)} networks x "
          f"{ps.deadlines.size} deadlines; mean energy saved {saved:.2f}% "
          f"(never worse than the latency-argmin schedule)")
    for di in (0, ps.deadlines.size - 1):
        c = int(ps.best_chip_slack[di])
        tag = (f"chip {c}, mean norm energy {ps.slack_scores[c, di]:.3f}"
               if c >= 0 else "no chip feasible")
        print(f"  deadline {ps.deadlines[di]:.2f}x: {tag}")
    dl = float(pc.deadlines[1])
    dc = hetero.score_codesign(probs, res, m_cores=4, deadline=dl)
    print(f"best chip under deadline {dl:.2f}x: {dc.summary(grid)} (mean "
          f"normalized EDP {dc.score:.3f}; without the deadline "
          f"{sd.score:.3f})")

    # --- co-design under hardware faults ---------------------------------
    # scenario 0 nominal, then a lost core and a degraded PE array on each
    # type slot; one host solve over the [B, S, T, L] scenario block
    print("\n=== resilience co-design (a lost core, a degraded array) ===")
    t0 = time.perf_counter()
    rc = hetero.resilience_codesign(grid, nets, m_cores=4, max_types=3,
                                    pool_size=6, device=dev, probs=probs,
                                    degradations=((4, 4),))
    print(f"{rc.n_chips} chips x {len(rc.scenario_names)} scenarios "
          f"({', '.join(rc.scenario_names[:3])}, ...) in "
          f"{time.perf_counter() - t0:.2f} s")
    for tag, c in (("best nominal", rc.best_nominal),
                   ("best worst case", rc.best_robust)):
        print(f"  {tag}: chip {c} ({pc.chip_summary(c, grid)}): nominal "
              f"{rc.nominal_score[c]:.3f}, worst {rc.worst_score[c]:.3f} "
              f"(x{rc.worst_overhead[c]:.2f}), expected "
              f"{rc.expected_score[c]:.3f}")
    print(f"  (nominal, worst-case) front: {len(rc.frontier())} chips")


if __name__ == "__main__":
    main()
