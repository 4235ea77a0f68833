"""Serving launcher of the port: batched prefill/decode with continuous
batching, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 6 --max-new-tokens 8 [--device cpu] [--no-smoke]

``--arch`` is any architecture the port runs (``qwen2-0.5b``,
``mamba2-2.7b``).  ``--smoke`` (the default) serves the reduced config;
``--no-smoke`` serves the full width.  The weights are random, drawn
from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as Z
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = Z.init(cfg, gen, dev)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_seq=args.max_seq, device=dev)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(3, 9))).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new_tokens))

    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, {cfg.name}, {engine.slots} "
          f"slots, {dev}, backend {engine.backend})")
    return done


if __name__ == "__main__":
    main()
