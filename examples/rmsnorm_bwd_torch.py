"""Time the port's RMSNorm backward on one card.

    python3 examples/rmsnorm_bwd_torch.py [--src DIR]
        [--shapes 4096x896 8192x2560 8192x5120] [--step]

At each [rows, D] of ``--shapes``, in bf16 with a scale of ones and x
and the output gradient drawn from seed 9,
``chip_smoke.rmsnorm_bwd_times`` (phase 8's figures: the kernel held
against its plain version, then its CUDA-event time warm and with L2
flushed, each device launch's traced time, host µs a call, the plain
version's time, ``F.rms_norm``'s autograd backward by events and on the
device, and the bytes bound); then the registers, spills, static shared
memory and blocks an SM of each device kernel of the backward.
``--step`` traces one qwen2-0.5b train step at chip_smoke.py's shape and
gives the backward's device time in it, in all and a launch.
``--src`` imports ``repro_torch`` from another checkout's ``src``, so that
two commits can be timed on one card in one run.  One JSON line per
measurement; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Appended to a copy of a source whose wrapper has no ``bwd_resources``
#: (the first version of the kernel: a warp and a block route, one element
#: an access, and a dscale pass) to read its kernels' resources.
_FIRST_VERSION_PROBE = r"""
extern "C" int probe_bwd_resources(int which, int threads, int* out) {
  const void* f[5] = {
      (const void*)rmsnorm_bwd_warp_kernel<float>,
      (const void*)rmsnorm_bwd_warp_kernel<__nv_bfloat16>,
      (const void*)rmsnorm_bwd_block_kernel<float>,
      (const void*)rmsnorm_bwd_block_kernel<__nv_bfloat16>,
      (const void*)rmsnorm_bwd_dscale_kernel};
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, f[which]);
  if (rc != cudaSuccess) return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], f[which],
                                                       threads, 0);
}
"""


def first_version_resources(rms, d: int) -> dict:
    """{kernel: {registers, spill_bytes, shared, blocks_per_sm}} of a
    first-version backward at row width ``d``, bf16."""
    import torch
    from repro_torch.kernels import _build

    probe = _build.BUILD_DIR / "probe" / "rmsnorm_bwd_first.cu"
    probe.parent.mkdir(parents=True, exist_ok=True)
    probe.write_text(rms.BWD_SOURCE.read_text() + _FIRST_VERSION_PROBE)
    lib = _build.load(probe, (), {"probe_bwd_resources": [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
    route, threads, _ = rms.bwd_plan(1, d)
    which = {("warp", torch.float32): 0, ("warp", torch.bfloat16): 1,
             ("block", torch.float32): 2, ("block", torch.bfloat16): 3}
    out = {}
    for name, idx, thr in ((f"rmsnorm_bwd_{route}_kernel",
                            which[route, torch.bfloat16], threads),
                           ("rmsnorm_bwd_dscale_kernel", 4, 256)):
        r = (ctypes.c_int * 4)()
        rc = lib.probe_bwd_resources(idx, thr, r)
        if rc != 0:
            raise RuntimeError(f"probe_bwd_resources: CUDA error {rc}")
        out[name] = dict(registers=r[0], spill_bytes=r[1], shared=r[2],
                         blocks_per_sm=r[3], threads=thr)
    return out


def step_share(dev) -> dict:
    """One traced qwen2-0.5b train step at chip_smoke.py's shape, after two
    untraced ones: the backward's device ms in the step and a launch."""
    import torch
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.launch import steps as ST
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P

    cfg = get_config("qwen2-0.5b")
    step_fn, opt = ST.build_train_step(cfg, seq_len=C.TRAIN_T,
                                       global_batch=C.TRAIN_B, lr=3e-3,
                                       device=dev, backend="cuda")
    params = P.init_tree(Z.spec(cfg), torch.Generator(device=dev)
                         .manual_seed(0), dev)
    state = opt.init(params)
    pipe = DataPipeline(SyntheticLM(cfg.vocab, 0), global_batch=C.TRAIN_B,
                        seq_len=C.TRAIN_T)
    try:
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in pipe._make_batch(i).items()}
                   for i in range(3)]
    finally:
        pipe.close()
    for i in range(2):
        params, state, _ = step_fn(params, state, batches[i])
    torch.cuda.synchronize()
    prof = C.profile_ms(lambda: step_fn(params, state, batches[2]), steps=1,
                        warmup=False, match=("rmsnorm_bwd",))
    total = prof["matched_ms"]["rmsnorm_bwd"]
    per = prof["matched_per_launch_ms"]["rmsnorm_bwd"]
    return dict(step_device_ms=prof["device_ms"], step_wall_ms=prof["wall_ms"],
                rmsnorm_bwd_step_ms=total, rmsnorm_bwd_ms_a_launch=per,
                rmsnorm_bwd_launches=round(total / per) if per else 0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--shapes", nargs="*",
                    default=["4096x896", "8192x2560", "8192x5120"])
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("rmsnorm_bwd_torch: needs a CUDA card")
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels.rmsnorm import ops as rms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    src = str(Path(rms.__file__).parents[3])
    print(f"card {card}; repro_torch from {src}", flush=True)
    if args.step:
        C.build_all()
    for shape in args.shapes:
        rows, d = (int(v) for v in shape.split("x"))
        r = C.rmsnorm_bwd_times(rows, d, torch.Generator(device=dev)
                                .manual_seed(9), dev)
        r["resources"] = (rms.bwd_resources(torch.bfloat16, d)
                          if hasattr(rms, "bwd_resources")
                          else first_version_resources(rms, d))
        print(json.dumps(dict(card=card, src=src, **r)), flush=True)
    if args.step:
        print(json.dumps(dict(card=card, src=src, **step_share(dev))),
              flush=True)


if __name__ == "__main__":
    main()
