"""Time the port's SSD scan backward on one card.

    python3 examples/ssd_bwd_torch.py [--src DIR] [--t 1024 ...]

At mamba2-2.7b's widths (H 80, P 64, G 1, N 128, chunk 256), B 2 and each
T of ``--t``, in bf16 with operands from seed 11,
``chip_smoke.ssd_bwd_times`` (phase 9's figures: the backward's time by
CUDA events, each device launch's traced time, host µs a call, the float32
scratch bytes, the plain version's time and the bound), and the host µs
of a forward scan call (``ssd_scan`` under no_grad, same operands).
``--src``
imports ``repro_torch`` from another checkout's ``src``, so that two
commits can be timed on one card in one run (run them in alternating
processes: parent, change, change, parent).  One JSON line per shape;
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--t", type=int, nargs="*", default=[1024])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_torch: needs a CUDA card")
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    src = str(Path(ssd.__file__).parents[3])
    print(f"card {card}; repro_torch from {src}", flush=True)
    cfg = get_config("mamba2-2.7b")
    for t in args.t:
        # ssd_bwd_times takes B from the train step's microbatch and T from
        # TRAIN_T
        C.TRAIN_T = t
        r = C.ssd_bwd_times(cfg, dev, card)
        gen = torch.Generator(device=dev).manual_seed(11)
        x, dt, a, bm, cm = C._ssd_operands(tuple(r["shape"]), torch.bfloat16,
                                           gen, dev)
        with torch.no_grad():
            fwd_us, fwd_done_us = C.host_us(lambda: ssd.ssd_scan(
                x, dt, a, bm, cm, chunk=cfg.ssm_chunk), calls=200)
        print(json.dumps(dict(card=card, src=src, forward_host_us=fwd_us,
                              forward_host_done_us=fwd_done_us, **r)),
              flush=True)


if __name__ == "__main__":
    main()
