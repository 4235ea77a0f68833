"""Batched serving with continuous batching on the PyTorch port: 6 requests
through 3 slots (the counterpart of ``examples/serve_decode.py``).

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu] \
        [--arch qwen2-0.5b | mamba2-2.7b] [--no-smoke]

On a card the attention and RMSNorm run through the port's CUDA kernels;
on the CPU through their plain torch versions.  mamba2-2.7b serves from
its O(1) recurrent state (no SSD scan in decode).  ``--smoke`` (the
default) serves the reduced config, ``--no-smoke`` the full width.
"""

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
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = Z.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(cfg, params, batch_slots=3, max_seq=96, device=dev)

    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(3, 9))
        engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new_tokens=8))

    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {dev}, {cfg.name}, backend "
          f"{engine.backend}, {engine.slots} slots)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt {r.prompt.tolist()} -> {r.out_tokens}")


if __name__ == "__main__":
    main()
