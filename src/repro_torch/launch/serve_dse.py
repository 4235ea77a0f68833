"""DSE-service launcher of the port: drive the fault-tolerant co-design
query server, on the card by default.

Builds a :class:`repro_torch.serving.dse_service.DSEService` over a design
space (the paper's 150-point grid by default), submits a seeded mix of
best-config / best-chip / Pareto queries, drains the queue, and prints
the health snapshot.  ``--chaos SEED`` overlays a deterministic
:class:`repro_torch.ft.faults.FaultPlan` on the streaming engine while
serving — the service must still answer everything (exactly or
degraded).  ``--fault-event`` then reports a hardware fault (one core
lost) on the first served best-chip answer and drains the resulting
re-schedule query through the same loop.

``--state-dir DIR`` makes the service durable: requests journal to disk
before admission, warm tiers and answers persist in the store, and a
re-launch over the same directory replays whatever an earlier (killed)
launch accepted but never answered — those drain FIRST.  SIGTERM/SIGINT
trigger a graceful drain: admission closes, the queue is served to
completion, and the journal is closed before exit.  ``--scrub`` runs a
full store audit after draining (cached stream payloads re-derived on the
plain path, poisoned entries quarantined with a reason and recomputed);
``--no-verify`` disables the in-stream silent-corruption defense (see
:mod:`repro_torch.ft.verify`).  ``--device cpu`` runs the plain torch path
on the CPU; ``--backend`` is ``cuda`` (the kernels) or ``torch``.

    PYTHONPATH=src python -m repro_torch.launch.serve_dse --requests 12
    PYTHONPATH=src python -m repro_torch.launch.serve_dse --chaos 0
    PYTHONPATH=src python -m repro_torch.launch.serve_dse --fault-event
    PYTHONPATH=src python -m repro_torch.launch.serve_dse --device cpu \
        --requests 10 --seed 1 --state-dir DIR
"""

from __future__ import annotations

import argparse
import contextlib
import json
import signal
import time

import numpy as np

from repro_torch.core import topology
from repro_torch.core.accelerator import ConfigGrid, extended_grid
from repro_torch.ft.faults import FaultPlan, inject_chunk_faults
from repro_torch.ft.hw_faults import all_single_core_failures
from repro_torch.serving.dse_service import DSEService

KINDS = ("best_config", "best_chip", "pareto")


def seeded_mix(names, n_requests: int, seed: int,
               deadline_s=None) -> list:
    """The launcher's seeded query mix over network ``names``: one
    :meth:`DSEService.submit` keyword dict a request (a kind, a network
    for the chip-family kinds, a relative deadline), drawn from ``seed``
    in the reference launcher's order, so both launchers submit the same
    queries."""
    rng = np.random.default_rng(seed)
    mix = []
    for _ in range(n_requests):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        mix.append(dict(
            kind=kind,
            network=(names[int(rng.integers(len(names)))]
                     if kind != "best_config" else None),
            deadline=float(rng.choice([1.2, 1.5, 2.0, 3.0])),
            deadline_s=deadline_s))
    return mix


def install_graceful(svc, *, signals=(signal.SIGTERM, signal.SIGINT)):
    """Graceful-drain handler: on signal, close admission (``max_queue=0``
    rejects everything), serve the queue to completion, close the journal,
    and exit 0 — accepted work is answered, not re-queued for a replay.
    Returns the handler so tests can invoke it without a real signal."""
    def handler(signum, frame):
        svc.max_queue = 0
        svc.run_until_drained()
        svc.close()
        raise SystemExit(0)
    for s in signals:
        signal.signal(s, handler)
    return handler


def main(argv=None, *, clock=None, sleep=None, grid=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--networks", nargs="*",
                    default=["AlexNet", "VGG16", "MobileNet", "ResNet50"])
    ap.add_argument("--extended", action="store_true",
                    help="5,400-point extended grid (default: paper 150)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall budget (default: unbounded)")
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--degrade-stride", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("cuda", "torch"),
                    help="cuda: the hand-written kernels; torch: their "
                    "plain versions (default: cuda on the card, torch on "
                    "the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state-dir", default=None,
                    help="durable state root (journal + cache + "
                    "checkpoints); re-launching over it replays "
                    "unanswered requests")
    ap.add_argument("--chaos", type=int, default=None,
                    help="inject a seeded fault plan while serving")
    ap.add_argument("--fault-event", action="store_true",
                    help="after draining, report a single-core loss on "
                    "the first best-chip answer and re-schedule")
    ap.add_argument("--no-verify", action="store_true",
                    help="disable the silent-corruption defense "
                    "(invariant checks + shadow recompute + idle scrub)")
    ap.add_argument("--verify-fraction", type=float, default=1.0 / 16.0,
                    help="seeded fraction of chunks shadow-recomputed "
                    "on the plain path on the CPU (default 1/16)")
    ap.add_argument("--scrub", action="store_true",
                    help="after draining, run a FULL store scrub "
                    "(audit + quarantine + recompute) and print its "
                    "counters; requires --state-dir")
    args = ap.parse_args(argv)

    if grid is None:
        grid = extended_grid() if args.extended else ConfigGrid.product()
    nets = {n: topology.get_network(n) for n in args.networks}
    extra = {}
    if clock is not None:
        extra["clock"] = clock
    if sleep is not None:
        extra["sleep"] = sleep
    svc = DSEService(grid, nets, max_queue=args.max_queue,
                     chunk_size=args.chunk_size,
                     degrade_stride=args.degrade_stride,
                     device=args.device, backend=args.backend,
                     state_dir=args.state_dir,
                     verify=not args.no_verify,
                     verify_fraction=args.verify_fraction,
                     **extra)
    prev_handlers = {s: signal.getsignal(s)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    install_graceful(svc)
    if svc.stats["replayed"]:
        print(f"replayed {svc.stats['replayed']} unanswered requests "
              f"from {args.state_dir}")

    rejected = 0
    for q in seeded_mix(list(nets), args.requests, args.seed,
                        args.deadline_s):
        rejected += int(not svc.submit(**q).accepted)

    n_chunks = -(-grid.n // max(1, min(args.chunk_size, grid.n)))

    def chaos():
        if args.chaos is None:
            return contextlib.nullcontext()
        return inject_chunk_faults(FaultPlan.random(args.chaos, n_chunks))

    t0 = time.time()
    with chaos():
        responses, drained = svc.run_until_drained()
    dt = time.time() - t0

    n_deg = sum(r.degraded for r in responses)
    print(f"served {len(responses)} responses in {dt:.2f}s "
          f"({len(responses) / max(dt, 1e-9):.1f} q/s), "
          f"{n_deg} degraded, {rejected} rejected, drained={drained}")

    if args.fault_event:
        chip = next((r.answer for r in responses
                     if r.kind == "best_chip" and r.ok
                     and r.answer.get("feasible")), None)
        if chip is None:
            # the seeded mix served no feasible chip — ask for one
            svc.submit("best_chip", deadline=2.0)
            with chaos():
                extra, _ = svc.run_until_drained()
            responses.extend(extra)
            chip = next((r.answer for r in extra
                         if r.ok and r.answer.get("feasible")), None)
        if chip is None:
            print("fault-event: no feasible best-chip answer to break")
        else:
            scen = all_single_core_failures(chip["chip_counts"])[0]
            svc.fault_event(chip["chip_types"], chip["chip_counts"],
                            scen, deadline_s=args.deadline_s)
            with chaos():
                resched, _ = svc.run_until_drained()
            responses.extend(resched)
            for r in resched:
                a = r.answer
                print(f"fault-event {scen.name} on chip "
                      f"{chip['chip_types']}×{chip['chip_counts']}: "
                      f"ok={r.ok} degraded={r.degraded} "
                      f"feasible={a.get('feasible')} "
                      f"counts_after={a.get('counts_after')}")

    if args.scrub:
        if svc.store is None:
            print("scrub: no --state-dir, nothing to audit")
        else:
            res = svc.scrub()
            print(f"scrub: scanned {res['scanned']} entries, "
                  f"{res['bad']} quarantined, "
                  f"{res['recomputed']} recomputed")

    print(json.dumps(svc.health(), indent=2, default=str))
    svc.close()
    for s, h in prev_handlers.items():   # leave no handler behind (tests
        signal.signal(s, h)              # call main() in-process)
    return responses


if __name__ == "__main__":
    main()
