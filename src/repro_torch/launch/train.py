"""End-to-end trainer of the port: data pipeline → train step →
checkpoint and fault tolerance, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    python -m repro_torch.launch.train --no-smoke --steps 8 --seq-len 1024
    python -m repro_torch.launch.train --arch mamba2-2.7b --no-smoke \
        --steps 8 --seq-len 1024

``--smoke`` (the default) trains the reduced config with 2 microbatches
(as the reference's ``--smoke``); ``--no-smoke`` the full width with the
config's own microbatches (qwen2-0.5b 2, mamba2-2.7b 4).  ``--layers``
cuts the depth and keeps the widths: an aid for tests and smoke runs
(a full-width replay that a card's memory and disk hold), which the
reference's launcher lacks.  The weights are random, drawn from
``--seed``; each step's batch is ``DataPipeline._make_batch(step)`` of a
``SyntheticLM``, so a replay after a restore sees the same data.
``--device cpu`` runs the plain versions of the kernels; on the card
``--backend cuda`` (the default) runs the hand-written kernels,
``--backend torch`` their plain versions.
``--ckpt-dir`` keeps the checkpoints (by default a temporary directory,
removed at the end); ``--inject-failure-at`` raises a worker failure once
at that step, from which the supervisor restores the last checkpoint and
replays.  The reference's ``--multi-pod`` waits for the port's parallel
slice.  Both families train: qwen2-0.5b (dense) and mamba2-2.7b (ssm).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.ft import FaultInjector, Supervisor
from repro_torch.launch import steps as ST
from repro_torch.models import model_zoo as Z
from repro_torch.models import params as P


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="train this many layers at full width (0: the "
                         "config's); a test and smoke aid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("cuda", "torch"),
                    help="the kernels (default on the card) or their plain "
                         "versions")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    Z.check_trainable(cfg)
    if args.smoke:
        cfg = dataclasses.replace(cfg.smoke(), microbatches=2)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)

    step_fn, opt = ST.build_train_step(
        cfg, seq_len=args.seq_len, global_batch=args.global_batch,
        lr=args.lr, device=dev, backend=args.backend)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = P.init_tree(Z.spec(cfg), gen, dev)
    opt_state = opt.init(params)

    pipe = DataPipeline(SyntheticLM(cfg.vocab, args.seed),
                        global_batch=args.global_batch, seq_len=args.seq_len)
    losses = []

    def one_step(state, step):
        params, opt_state = state
        batch = pipe._make_batch(step)        # deterministic per step
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return (params, opt_state)

    injector = None
    if args.inject_failure_at >= 0:
        injector = FaultInjector({args.inject_failure_at: "fail"})

    with contextlib.ExitStack() as stack:
        stack.callback(pipe.close)
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_"))
        manager = CheckpointManager(ckpt_dir)
        stack.callback(manager.wait)
        # the step updates its state in place: no in-process re-execution
        sup = Supervisor(manager, checkpoint_every=args.ckpt_every,
                         reexecute_stragglers=False)
        t0 = time.time()
        sup.run(state=(params, opt_state), step_fn=one_step,
                num_steps=args.steps, injector=injector)
        dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({cfg.name}, {dev}, "
          f"backend {resolve_backend(args.backend, dev)})", flush=True)
    return losses


if __name__ == "__main__":
    main()
