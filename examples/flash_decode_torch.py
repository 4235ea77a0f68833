"""Time the port's flash attention and qwen2-0.5b's decode step on one card.

    python3 examples/flash_decode_torch.py [--src DIR] [--lengths 405 1024]
        [--step LENGTH]

Flash attention at qwen2-0.5b's decode shape, B 4, T 1, H 14 over KV 2,
D 64, bf16, at each cache length S of ``--lengths``: the kernel's and
``scaled_dot_product_attention``'s CUDA-event time, traced device time
and device launches of a call, host µs a call (1,000 calls with no
synchronisation among them) and the profiler's CPU self time of a call
(``chip_smoke.flash_times``), and the kernel's largest error against its
plain version.  ``--step LENGTH`` also times one decode step of
qwen2-0.5b at full width (random weights from seed 0, 4 slots, a random
KV cache at that length) on the kernels: the median of 10 CUDA-event
timings and the traced device time of a step.  ``--src`` imports
``repro_torch`` from another checkout's ``src``, so that two commits can
be timed on one card in one run.  One JSON line per measurement; needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def step_times(length: int, dev) -> dict:
    """qwen2-0.5b's decode step at cache length ``length``, on the kernels."""
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z, params as P

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Z.init(cfg, gen, dev)
    cache = P.init_tree(Z.cache_spec(cfg, chip_smoke.SLOTS, chip_smoke.MAX_SEQ),
                        device=dev)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen,
                                      device=dev))
    cache["length"] = length
    tokens = torch.randint(0, cfg.vocab, (chip_smoke.SLOTS, 1),
                           generator=gen, device=dev)
    # each call gets the cache at ``length``: the step writes its K/V in
    # place at that row and returns a new dict with the length advanced
    step = lambda: Z.decode_step(model, cfg, tokens, dict(cache))  # noqa: E731
    prof = chip_smoke.profile_ms(step, steps=5)
    return dict(step_ms=chip_smoke.cuda_ms(step), device_ms=prof["device_ms"],
                kernel_launches=prof["kernel_launches"],
                busy_share=prof["busy_share"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--lengths", type=int, nargs="*", default=[405, 1024])
    ap.add_argument("--step", type=int, default=None, metavar="LENGTH")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_decode_torch: needs a CUDA card")
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    src = str(Path(ops.__file__).parents[3])
    print(f"card {card}; repro_torch from {src}", flush=True)
    for s in args.lengths:
        case = (4, 1, s, 14, 2, 64, False)
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = chip_smoke._flash_operands(case, torch.bfloat16, g, dev)
        err = float((ops.flash_attention(q, k, v, causal=False).float()
                     - ref.attention_ref(q, k, v, causal=False).float())
                    .abs().max())
        r = chip_smoke.flash_times(case, dev)
        print(json.dumps(dict(card=card, src=src, max_abs_err=err, **r)),
              flush=True)
    if args.step is not None:
        r = step_times(args.step, dev)
        print(json.dumps(dict(card=card, src=src, decode_step_length=args.step,
                              **r)), flush=True)


if __name__ == "__main__":
    main()
