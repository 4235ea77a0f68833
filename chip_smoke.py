#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each fatal on any error:

1. build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   nvcc, one compiler per source, all at once; print registers and spills;
2. DSE: the count-terms kernels' registers, spills and blocks an SM;
   hold them against their plain torch versions at ``extended_grid()``,
   one 9,800-point chunk of ``mega_grid()`` and the whole of it x 18
   networks (the 12 integer terms bit for bit, terms 8 and 13 within
   1e-12 relative, atol 0, zeros exact; the same bits on a second call);
   drive the DSE path (the batched engine, the quickstart steps, the
   §IV.A chip) with the launch counts set to 0 just before and read just
   after, and check its outputs against the plain path on the card and
   against a CPU run; the same for the streamed DSE (both streams at
   mega x 18, the streamed chip) and the per-layer co-design
   (``co_design`` at extended x 18, 111 chips: cuda against torch on
   the card, every winning schedule against the scalar oracle bit for
   bit; ``co_design_streaming`` at extended, equal to the dense search,
   and at mega); and the co-design under a deadline and under faults
   (``resilience_codesign`` at extended x 18 with two degraded PE arrays,
   10 scenarios a chip, ``count_layers`` on each degraded pool against
   its plain version and every field on both backends;
   ``score_codesign(deadline=2.0)``, ``pareto_codesign(slack=True)`` and
   the streamed mega ``pareto_codesign``; seeded cells against
   ``slack_schedule_oracle`` and ``schedule_hetero_oracle`` bit for bit;
   the Pareto guardrails and the resilience front); and the
   fault-tolerant DSE service (``DSEService`` at extended x 18 with its
   defaults: the launcher's seeded mix on the kernels and on the plain
   backend, against a direct ``stream_layer_topk``; three seeded chaos
   runs with every chunk shadow-checked; a process kill in a second
   metric's stream and the restarts' journal replay; a core loss and a
   degraded PE array rescheduled on both backends; the store's scrub of
   a poisoned payload; ``shard=True`` against the service's stream);
3. LM kernels: hold flash attention and RMSNorm against their plain
   versions on the card (f32 2e-5, bf16 2e-2) at the serve paths' decode
   shapes and at D 128 (split edges, a window, causal rows at an offset)
   and the prefill shapes, with the route each flash case took and the same bits
   on a second call; RMSNorm at every route, vector width and instance
   (``RMSNORM_CASES``: ragged blocks, one row, a misaligned x, the widest
   row); the flash kernels' registers, spills, shared memory and
   tensor-core (HMMA) instructions, and each RMSNorm instance's
   registers, spills and blocks an SM;
4. serve qwen2-0.5b at full width through ``ServeEngine`` (8 requests,
   4 slots, random bf16 weights from a seed) on the kernels, with the
   counts set to 0 just before and read just after (every flash call on
   the split route), then on the plain versions; replay the kernel
   run's inputs through the plain decode step and hold every step's
   logits to bf16 tolerance;
5. the prefill forward at full width (B 2, T 2048) on both backends,
   every flash call on the tensor-core route;
6. time each kernel, its plain version and its library call (the
   count-terms kernels by events, traced device time and host µs a call,
   beside a bound counted on the kernel's own decomposition; an
   ``evaluate_networks`` call's wall time, trace and host split by stage;
   the co-design's walls, split by phase and device busy share, and the
   same for the deadline, Pareto and resilience calls;
   flash decode at S 405 and 1,024; prefill at D 64 and D 128; RMSNorm
   at qwen2's rows; each with its traced device time and the host time
   of a call), the serve runs and the forward with CUDA events;
   trace a decode step and the forward with torch.profiler (device busy
   share, kernel launches, the largest kernels and host ops, flash
   attention's share of the forward);
7. mamba2-2.7b at full width: hold the SSD scan, and each of its four
   passes, against its plain version on the card (f32 2e-4, bf16 6e-2)
   at the forward's shape, a ragged T and two groups; serve the same
   requests as in 4 from the recurrent state (RMSNorm launches only) with
   the same replay, at full width and 64 layers deep; the prefill forward
   at B 2, T 4096, 64 layers (64 SSD scan calls) on both backends; times
   and traces as in 6, each SSD pass's time, registers, spills, shared memory and tensor-core (HMMA)
   instructions, RMSNorm at mamba2's four rows (decode and forward, the
   pre-norm and the gated norm), and the SSD's share of the forward's
   device time;
8. train qwen2-0.5b at full width (seq_len 1,024, global batch 8 in the
   config's 2 microbatches, remat, f32 AdamW state): hold the flash
   attention and RMSNorm backward kernels against their plain backwards
   on the card (``FLASH_BWD_CASES``, ``RMSNORM_BWD_CASES``; f32 and bf16,
   the flash backward's f32 on its CUDA-core route and bf16 on its
   tensor-core route, tolerance tol x max|g| + tol x |g|, the same bits
   on a second call; the RMSNorm backward also on offset views of g and
   of x, which must take its one-element width), the log-sum-exp
   forward's O bit for bit against the same route without it; one step's
   loss, grad norm and every gradient leaf on the kernels against the
   plain versions from the same weights and batch, within
   max(2e-2, 2 x the rounding floor of the plain bf16 step against its
   float32 twin), with the launch counts set to 0 just before and read
   just after and no plain version called; 8 steps through
   ``repro_torch.launch.train.main`` (the loss falls) and again with a
   checkpoint every 4 and a failure at step 5 (the final loss within
   1e-4); the step's time by events, its tokens/s, a trace (the flash
   backward's share of the device time, by kernel; the RMSNorm
   backward's, in all and a launch), and each backward kernel's time
   beside its plain version, its library call and its bound (on the
   device, split by kernel, beside SDPA's or ``F.rms_norm``'s autograd
   backward on the device; the RMSNorm backward's host µs a call, and its
   times also at mamba2-2.7b's widths [8192, 2560] and [8192, 5120];
   each backward instance's registers and spill bytes, the RMSNorm
   backward's static shared memory and blocks an SM); print the
   ``train`` line;
9. train mamba2-2.7b at full width (64 layers, seq_len 1,024, global
   batch 8 in the config's 4 microbatches, remat, f32 AdamW state): hold
   the SSD backward (``ssd_bwd.cu``) and each pass of its route against
   the plain backward on the card (``SSD_BWD_CASES``: the training shape,
   a ragged T, two groups, the T 4,096 prefill shape; f32 on the "fma"
   route and bf16 on "mma", each call counted on its route, at the
   scan's tolerance as tol x max|g| + tol x |g|, the same bits on a
   second call); one step's loss, grad norm and every gradient leaf on
   the kernels against the plain versions, within max(2e-2, 2 x the
   rounding floor), launch counts exactly 2·L·m SSD scans, L·m SSD
   backwards, (4L+1)·m RMSNorms and (2L+1)·m RMSNorm backwards with no
   plain version called, and the peak device memory; 8 steps through
   ``repro_torch.launch.train.main`` (the loss falls), then the failure
   and its replay at ``SSM_REPLAY_LAYERS`` layers (two 64-layer
   checkpoints would take ~80 GB); the step's time by events, tokens/s,
   a trace (busy share, launches, the SSD backward's share); the SSD
   backward's time by events and on the device by pass and its host µs
   a call, beside its plain version and its bound (no library call
   computes it), each route's float32 scratch bytes (the "mma" route
   holds no per-head buffer), and each pass's registers, spills (a spill
   fails), shared memory, blocks an SM and HMMA count; print a second
   ``train`` line (keys: card, model, seq_len, global_batch,
   microbatches, step, trainer, timing, profile, kernels, max_abs_err,
   ssd_bwd_passes, build, ssd_bwd_workspace_bytes, phase_s), then the
   ``kernels`` line.

Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN.  The last line of standard output is
``{"ok": true, "device": {...}}``.  Without a card, or away from the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

RTOL = 1e-12
REPS = 10

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 34 TFLOP/s FP64 outside the
# tensor cores (the count-terms arithmetic is scalar FP64), 989 TFLOP/s
# bf16 and 67 TFLOP/s fp32 (CUDA cores) dense.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

#: Kernel tolerances of the LM kernels (``tests/test_kernels.py:18-20``)
#: and of the SSD scan (``tests/test_kernels.py:74-75``).
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 6e-2}

#: The backward kernels replace none: the JAX package differentiates XLA
#: attention and XLA RMSNorm, never its Pallas kernels.
REPLACES = {
    "flash_attention_bwd": "none: the JAX package differentiates XLA "
                           "attention (src/repro/models/layers.py:161), never "
                           "its Pallas kernel",
    "rmsnorm_bwd": "none: the JAX package differentiates XLA RMSNorm "
                   "(src/repro/models/layers.py:34), never its Pallas kernel",
    "ssd_bwd": "none: the JAX package differentiates XLA's ssd_chunked "
               "(src/repro/models/mamba2.py:83), never its Pallas kernel",
    "count_terms": "src/repro/kernels/count_terms/kernel.py:99",
    "count_layers": "src/repro/kernels/count_terms/kernel.py:146",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:110",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:29",
    "ssd": "src/repro/kernels/ssd/kernel.py:86",
}
SOURCES = {
    "count_terms": "src/repro_torch/csrc/count_terms.cu",
    "count_layers": "src/repro_torch/csrc/count_terms.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "ssd": "src/repro_torch/csrc/ssd.cu",
    "ssd_bwd": "src/repro_torch/csrc/ssd_bwd.cu",
}

#: RMSNorm cases on the card, (shape, storage offset of x in elements):
#: every route, vector width and instance of ``rmsnorm.cu`` in f32 and bf16
RMSNORM_CASES = (
    ((4, 896), 0), ((4096, 896), 0),    # warp route, vectors (qwen2)
    ((4097, 896), 0), ((1, 896), 0),    # a ragged last block, one row
    ((5, 1001), 0), ((64, 896), 1),     # warp route, one element an access
    ((4, 5120), 0), ((8192, 2560), 0),  # block route, vectors (mamba2)
    ((3, 5121), 0), ((3, 8192), 0))     # one element an access; widest

# serve runs (qwen2-0.5b and mamba2-2.7b at full width)
SLOTS, N_REQUESTS, NEW_TOKENS, MAX_SEQ = 4, 8, 16, 1024
PROMPT_LEN = (16, 65)          # numpy integers(16, 65): 16..64 tokens
PREFILL_B, PREFILL_T = 2, 2048
# mamba2-2.7b's prefill forward: the train_4k length, a batch the card holds
SSM_B, SSM_T = 2, 4096


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median over ``reps`` runs of fn's device time, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, calls: int = 1000) -> tuple:
    """(µs a call to enqueue, µs a call to the end of the device's work):
    ``calls`` calls of fn on the host clock with no synchronisation among
    them, read before and after one synchronisation at the end."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e6 / calls, (t2 - t0) * 1e6 / calls


def wall_ms(fn, reps: int = REPS) -> float:
    """Median host wall time of fn, which ends on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: float, ops: float, peak: float) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of bytes over the HBM
    rate and operations over ``peak``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profile_ms(fn, steps: int, match: tuple = (), warmup: bool = True
               ) -> dict:
    """Trace ``steps`` calls of fn with torch.profiler → wall ms per call,
    device kernel ms per call (kernels on one stream do not overlap, so
    their sum over the wall time is the device's busy share), kernel
    launches per call, the largest device kernels (also ms a launch) and
    host ops, and for each substring of ``match`` the device ms per call
    and per launch of the kernels whose names hold it (the tracer may miss
    the first kernels of a short window, and drops launches after long
    traces; a time per launch does not depend on how many it saw;
    ``warmup=False`` skips the untraced first call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3 / steps
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:6]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    hits = {m: [e for e in kernels if m in e.key] for m in match}
    return dict(
        wall_ms=wall, device_ms=busy, busy_share=busy / wall,
        host_self_ms=sum(e.self_cpu_time_total for e in host
                         if "Synchronize" not in e.key) / 1e3 / steps,
        matched_ms={m: sum(dev_us(e) for e in es) / 1e3 / steps
                    for m, es in hits.items()},
        matched_per_launch_ms={
            m: sum(dev_us(e) for e in es) / 1e3
            / max(1, sum(e.count for e in es)) for m, es in hits.items()},
        per_launch_ms={e.key[:60]: dev_us(e) / 1e3 / max(1, e.count)
                       for e in top_dev},
        kernel_launches=sum(e.count for e in kernels) / steps,
        top_device=[(e.key[:60], dev_us(e) / 1e3 / steps, e.count // steps)
                    for e in top_dev],
        top_host=[(e.key[:40], e.self_cpu_time_total / 1e3 / steps,
                   e.count // steps) for e in top_host])


def traced_call(fn, steps: int = 100) -> dict:
    """:func:`profile_ms` of ``steps`` calls of fn, with ``device_ms`` and
    ``kernel_launches`` a call recomputed as the device time of a traced
    launch times the launches a call (rounded): the tracer can miss the
    first launches of a window, all of them in a short one.  Traces again,
    with twice the calls, where it saw none; fails after three tries."""
    for _ in range(3):
        prof = profile_ms(fn, steps=steps)
        seen = prof["kernel_launches"]
        if seen >= 0.5:
            per_call = round(seen)
            prof["device_ms"] *= per_call / seen
            prof["kernel_launches"] = per_call
            return prof
        steps *= 2
    fail("the profiler saw no device launch in three traces")


def plain_ops_per_pair() -> dict:
    """Elementwise operations of the count-terms programs per (row, layer)
    pair, counted on a small CPU input (the 150-point grid, AlexNet):
    every aten op whose output covers a whole [n, L] tile counts once, n
    the mapping-unique rows ("m") or the count-unique rows ("u"); a
    segment sum counts one add per element it reads; views, copies,
    gathers and negations count nothing (a floor or ceiling division is
    one operation, so the bound is a lower bound).  count_terms runs its
    own decomposition (``ref.count_term_sums_split``: the mapping and the
    GB_psum-free terms a mapping row, A and B a count row), count_layers
    the plain mapping and terms on the count rows.
    → {kernel: {"m": ops, "u": ops}}"""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import accelerator, energymodel, topology
    from repro_torch.kernels.count_terms import ref

    lay_np, seg = energymodel._stack_networks(
        {"AlexNet": topology.get_network("AlexNet")})
    lay = {k: torch.as_tensor(v)[None, :] for k, v in lay_np.items()}
    cfg_m, cfg_u, inv_m, _, _ = energymodel._prepare_fields(
        accelerator.ConfigGrid.product().fields, torch.device("cpu"))
    n_m, n_u, n_l = cfg_m["rows"].shape[0], cfg_u["rows"].shape[0], \
        lay["m"].shape[1]
    if not 1 < n_m < n_u:
        fail("the operation count needs more than one mapping row and "
             "fewer mapping rows than count rows")
    skip = ("view", "expand", "unsqueeze", "stack", "cat", "select", "slice",
            "clone", "copy", "empty", "ones_like", "zeros_like", "lift",
            "detach", "_to_copy", "alias", "as_strided", "unbind", "index",
            "neg")

    def count(fn):
        per = {n_m: 0, n_u: 0}

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.__name__
                if name.startswith("sum"):
                    x = args[0]
                    if x.dim() == 2 and x.shape[0] in per:
                        per[x.shape[0]] += x.numel()
                elif (isinstance(out, torch.Tensor)
                      and not any(w in name for w in skip)):
                    for n in per:
                        if out.numel() == n * n_l:
                            per[n] += out.numel()
                return out

        with Count():
            fn()
        return {"m": per[n_m] / (n_m * n_l), "u": per[n_u] / (n_u * n_l)}

    return {"count_terms": count(lambda: ref.count_term_sums_split(
                seg, cfg_m, cfg_u, lay, inv_m)),
            "count_layers": count(lambda: ref.count_term_layers_ref(
                cfg_u, lay))}


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def build_all() -> dict:
    """→ {source file name: (library path, compiler log)}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.count_terms import ops as ct_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    wrappers = (ct_ops, fa_ops, rms_ops, ssd_ops)
    t0 = time.perf_counter()
    built = _build.build_many([(w.SOURCE, w.NVCC_FLAGS) for w in wrappers]
                              + [(w.BWD_SOURCE, w.NVCC_FLAGS)
                                 for w in (fa_ops, rms_ops, ssd_ops)])
    for w in wrappers:
        w._lib()
        if hasattr(w, "_bwd_lib"):
            w._bwd_lib()
    log(f"[1] built {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for source, (lib, build_log) in built.items():
        log(f"    {Path(source).name} -> {lib.parent.name}/{lib.name}")
        for line in build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error")):
                log(f"      {line.strip()}")
    return {Path(source).name: v for source, v in built.items()}


# ---------------------------------------------------------------------------
# 2. DSE path: the count-terms kernels
# ---------------------------------------------------------------------------

#: Count terms that divide by the active PEs; every other is an integer
#: below 2^53 at the DSE grids, held bit for bit.
FLOAT_TERMS = (8, 13)
#: Points of one chunk of the mega grid on the DSE path.
MEGA_CHUNK = 9800


def count_terms_build_report(built) -> dict:
    """Registers and spills (build log) of the two count-terms kernels, and
    their registers, local memory and blocks an SM at their block sizes."""
    from repro_torch.kernels.count_terms import ops

    def key(symbol):
        for name in ("count_terms", "count_layers"):
            if f"{name}_kernel" in symbol:
                return name
        return None

    report = kernel_build_report(built, "count_terms.cu", key)
    for name in ("count_terms", "count_layers"):
        r = report.setdefault(name, {})
        regs, local, r["blocks_per_sm"] = ops.resources(name)
        r.setdefault("registers", regs)
        r["local_bytes"] = local
        log(f"[2] {name}_kernel: {r['registers']} registers, spill "
            f"stores/loads {r.get('spill_stores', '?')}/"
            f"{r.get('spill_loads', '?')} bytes, {local} bytes of local "
            f"memory, {r['blocks_per_sm']} blocks an SM")
    return report


#: The stages of an ``evaluate_networks`` call, as the engine marks them.
SPLIT_STAGES = ("layer stacking", "layer host-to-device", "config columns",
                "count dedup", "mapping dedup", "config host-to-device",
                "heavy stage", "gather-combine", "device-to-host")


def stage_split(call, stages, reps: int = REPS) -> dict:
    """Host split of ``call()`` on the card: the engine's own stage marks
    (``energymodel._stage_hook``), each preceded by
    ``torch.cuda.synchronize()``, read on the host clock and summed over
    a call's repeats of a stage (a stream's chunks) → {stage: median ms
    over ``reps`` calls, "total": median ms a call}."""
    import torch
    from repro_torch.core import energymodel as em

    def once():
        ms = {}
        last = [time.perf_counter()]

        def mark(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms[stage] = ms.get(stage, 0.0) + (now - last[0]) * 1e3
            last[0] = now

        em._stage_hook = mark
        try:
            call()
        finally:
            em._stage_hook = None
        if set(ms) != set(stages):
            fail(f"the engine marked stages {sorted(ms)}, expected "
                 f"{sorted(stages)}")
        return ms

    once()
    runs = [once() for _ in range(reps)]
    split = {k: statistics.median(r[k] for r in runs) for k in stages}
    split["total"] = statistics.median(sum(r.values()) for r in runs)
    return split


def evaluate_split(fields, nets, dev, reps: int = REPS) -> dict:
    """:func:`stage_split` of ``evaluate_networks(fields, nets)``."""
    from repro_torch.core import energymodel as em
    return stage_split(lambda: em.evaluate_networks(fields, nets, device=dev),
                       SPLIT_STAGES, reps)


def dse_path(dev, card, built) -> list:
    import numpy as np
    import torch
    from repro_torch.core import (accelerator, dse, energymodel as em,
                                  hetero, partition, topology)
    from repro_torch.kernels.count_terms import ops, ref

    nets = {n: topology.get_network(n) for n in topology.NETWORKS}
    mega = accelerator.mega_grid()
    grids = {"extended": accelerator.extended_grid().fields,
             "mega_chunk": {k: v[:MEGA_CHUNK] for k, v in mega.fields.items()},
             "mega": mega.fields}
    lay_np, seg = em._stack_networks(nets)
    lay = {k: torch.as_tensor(v).to(dev)[None, :] for k, v in lay_np.items()}
    n_l, n_net = lay["m"].shape[1], len(seg)
    int_terms = [k for k in range(ops.N_TERMS) if k not in FLOAT_TERMS]

    def operands(fields):
        cfg_m, cfg_u, inv_m, _, _ = em._prepare_fields(fields, dev)
        return cfg_m, cfg_u, inv_m

    kernels = {
        "count_terms": (
            lambda o: ops.count_term_sums(seg, o[0], o[1], lay, o[2]),
            lambda o: ref.count_term_sums_ref(seg, o[0], o[1], lay, o[2])),
        "count_layers": (lambda o: ops.count_term_layers(o[1], lay),
                         lambda o: ref.count_term_layers_ref(o[1], lay)),
    }
    build = count_terms_build_report(built)

    # kernels against their plain versions on the card
    per_grid = {k: {} for k in kernels}
    for gname, fields in grids.items():
        o = operands(fields)
        n_m, n_u = o[0]["rows"].shape[0], o[1]["rows"].shape[0]
        for kname, (kern, plain) in kernels.items():
            out = torch.stack(kern(o))
            torch.cuda.synchronize()
            want = plain(o)
            torch.cuda.synchronize()
            again = torch.stack(kern(o))
            same_bits = torch.equal(out, again)
            diff = (out - want).abs()
            rel = float((diff / want.abs().clamp_min(1e-300)).max())
            zeros = bool(((out == 0) == (want == 0)).all())
            exact = int((out == want).sum()) / out.numel()
            int_exact = (int((out[int_terms] == want[int_terms]).sum())
                         / out[int_terms].numel())
            finite = bool(torch.isfinite(out).all())
            per_grid[kname][gname] = dict(
                n_m=n_m, n_u=n_u, shape=list(out.shape), max_rel_err=rel,
                max_abs_err=float(diff.max()), exact_share=exact,
                int_terms_exact_share=int_exact, same_bits=same_bits)
            log(f"[2] {kname} at {gname} {tuple(out.shape)} ({n_m} mapping "
                f"rows): max_rel_err {rel:.3e}, zeros match {zeros}, "
                f"bit-equal share {exact} (integer terms {int_exact}), same "
                f"bits on a second call {same_bits}")
            if not (rel <= RTOL and zeros and finite and same_bits):
                fail(f"{kname} disagrees with its plain version at {gname}")
            if int_exact != 1.0 or (kname == "count_layers" and exact != 1.0):
                fail(f"{kname} at {gname} is not bit-equal to its plain "
                     f"version on the integer terms")
            del out, want, again, diff
            torch.cuda.empty_cache()

    # the DSE path, with the counts set to 0 just before and read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    e_ext, t_ext = em.evaluate_networks(accelerator.extended_grid(), nets)
    e_pl, t_pl = em.evaluate_networks(accelerator.extended_grid(), nets,
                                      per_layer=True)
    e_mega, t_mega = em.evaluate_networks(mega, nets, chunk_size=MEGA_CHUNK)
    cfg = accelerator.AcceleratorConfig(array_rows=16, array_cols=16,
                                        gb_psum_kb=54, gb_ifmap_kb=54)
    report = em.simulate_network(cfg, nets["ResNet50"], "ResNet50")
    sweep = dse.sweep_network(nets["ResNet50"], "ResNet50")
    boundary = dse.boundary_configs(sweep, bound=0.05)
    spread = dse.edp_spread(sweep)
    part = partition.partition_network(report, 3)
    sweeps = dse.sweep_networks(nets)
    chip = hetero.design_chip(sweeps, bound=0.05, max_cores=3)
    sav = hetero.savings_summary(chip)
    launches = ops.launch_counts()
    backend = em.last_backend()
    log(f"[2] DSE path in {time.perf_counter() - t0:.1f} s: backend "
        f"{backend}, launches {launches}")
    if backend != "cuda":
        fail(f"DSE path ran on backend {backend!r}")
    if not all(launches[k] > 0 for k in kernels):
        fail(f"a kernel of the DSE path was never launched: {launches}")

    ext = accelerator.extended_grid()
    n_e, n_m = ext.n, mega.n
    n_layer = int(em.network_layer_counts(nets).max())
    for name, arr, shape in (
            ("extended", e_ext, (n_e, n_net)), ("extended t", t_ext, (n_e, n_net)),
            ("per-layer", e_pl, (n_e, n_net, n_layer)), ("mega", e_mega, (n_m, n_net)),
            ("mega t", t_mega, (n_m, n_net))):
        if arr.shape != shape or not np.isfinite(arr).all() or (arr < 0).any():
            fail(f"{name} output: shape {arr.shape}, expected {shape}, "
                 f"or non-finite / negative values")
    np.testing.assert_allclose(e_pl.sum(-1), e_ext, rtol=RTOL)
    np.testing.assert_allclose(t_pl.sum(-1), t_ext, rtol=RTOL)
    e_plain, t_plain = em.evaluate_networks(ext, nets, device=dev,
                                            backend="torch")
    np.testing.assert_allclose(e_ext, e_plain, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_ext, t_plain, rtol=RTOL, atol=0)
    sub = np.arange(0, n_m, 7)
    e_sub, t_sub = em.evaluate_networks(mega.take(sub), nets,
                                        device=dev, backend="torch")
    np.testing.assert_allclose(e_mega[sub], e_sub, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_mega[sub], t_sub, rtol=RTOL, atol=0)
    log("[2] engine outputs finite, of the expected shapes, per-layer sums "
        "= aggregate, cuda = plain torch on the card (rtol 1e-12)")

    report_cpu = em.simulate_network(cfg, nets["ResNet50"], "ResNet50",
                                     device="cpu")
    np.testing.assert_allclose(report.layer_latencies,
                               report_cpu.layer_latencies, rtol=RTOL)
    if partition.partition_network(report_cpu, 3) != part:
        fail("Algorithm II split differs between the card and the CPU")
    log(f"[2] quickstart: ResNet50 {cfg.label()} energy {report.energy:.6e} "
        f"pJ latency {report.latency:.6e} ns; DSE min "
        f"{sweep.cell_label(sweep.argmin_cell('edp'))}, {len(boundary)} "
        f"configs within 5%, EDP spread mean +{spread[0]:.0f}% max "
        f"+{spread[1]:.0f}%; Alg. II speedup {part.speedup:.2f}x "
        f"{part.table_row()}")

    chip_cpu = hetero.design_chip(dse.sweep_networks(nets, device="cpu"),
                                  bound=0.05, max_cores=3)
    if (chip.core_types, chip.assignment) != (chip_cpu.core_types,
                                              chip_cpu.assignment):
        fail(f"§IV.A chip differs: card {chip.core_types} "
             f"{chip.assignment}, CPU {chip_cpu.core_types} "
             f"{chip_cpu.assignment}")
    es = [v["energy_saved"] for v in sav.values()]
    ed = [v["edp_saved"] for v in sav.values()]
    log(f"[2] §IV.A chip (same on card and CPU): "
        f"{[chip.core_label(i) for i in range(len(chip.core_types))]}; "
        f"savings vs worst single core: energy up to {max(es):.1f}% "
        f"(mean {np.mean(es):.1f}%), EDP up to {max(ed):.1f}% "
        f"(mean {np.mean(ed):.1f}%)  [paper: up to 36% / 67%]")

    stream_launches = dse_stream(dev, card, nets, chip)
    codesign_launches = codesign_path(dev, card)
    deadline_launches = deadline_path(dev, card)
    service_launches = service_path(dev, card)

    # times: CUDA events around a call, the traced device time of a launch,
    # the host µs of a call; the bound on the operations of
    # ref.count_term_sums_split (count_terms) and the plain mapping and
    # terms a count row (count_layers)
    per_pair = plain_ops_per_pair()
    for gname, fields in grids.items():
        o = operands(fields)
        n_m, n_u = o[0]["rows"].shape[0], o[1]["rows"].shape[0]
        lay_bytes = len(ops.LAYER_FIELDS) * n_l * 8
        for kname, (kern, plain) in kernels.items():
            pp = per_pair[kname]
            if kname == "count_terms":
                n_bytes = (len(ops.MAP_COLUMNS) * n_m + 2 * n_u
                           + 14 * n_u * n_net) * 8 + lay_bytes
                flops = (pp["m"] * n_m + pp["u"] * n_u) * n_l
            else:
                n_bytes = (len(ops.CFG_COLUMNS) * n_u
                           + 14 * n_u * n_l) * 8 + lay_bytes
                flops = pp["u"] * n_u * n_l
            b_ms, b_by = bound(n_bytes, flops, FP64_FLOPS)
            k_ms = cuda_ms(lambda: kern(o))
            prof = profile_ms(lambda: kern(o), steps=50,
                              match=(f"{kname}_kernel",))
            dev_ms = prof["matched_per_launch_ms"][f"{kname}_kernel"]
            call_dev_ms = prof["device_ms"]
            enq_us, end_us = host_us(lambda: kern(o), calls=200)
            p_ms = cuda_ms(lambda: plain(o))
            per_grid[kname][gname].update(
                kernel_ms=k_ms, device_ms=dev_ms, call_device_ms=call_dev_ms,
                host_us=enq_us, host_end_us=end_us, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, fp64_ops=flops,
                ops_per_pair=pp)
            log(f"[6] {kname} at {gname} ({n_m} mapping rows, {n_u} count "
                f"rows): events {k_ms:.4f} ms a call, device {dev_ms:.4f} "
                f"ms a launch ({call_dev_ms:.4f} ms of device work a call), "
                f"host {enq_us:.1f} us a call ({end_us:.1f} to the end), "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; ops a "
                f"pair: mapping {pp['m']:.0f}, count {pp['u']:.0f}) ({card})")
            torch.cuda.empty_cache()

    # end to end: host wall time, a trace of one call, the host split
    e2e = {}
    for gname, grid, chunk in (("extended", ext, None),
                               ("mega", mega, MEGA_CHUNK)):
        def call():
            return em.evaluate_networks(grid, nets, chunk_size=chunk)
        w_ms = wall_ms(call)
        prof = profile_ms(call, steps=3, match=("count_terms_kernel",))
        k_ms = prof["matched_ms"]["count_terms_kernel"]
        e2e[gname] = dict(wall_ms=w_ms, kernel_ms=k_ms,
                          kernel_share=k_ms / w_ms, chunk_size=chunk,
                          device_ms=prof["device_ms"],
                          busy_share=prof["busy_share"],
                          kernel_launches=prof["kernel_launches"])
        log(f"[6] evaluate_networks at {gname} x 18 (chunk {chunk}): wall "
            f"{w_ms:.2f} ms, count_terms kernel {k_ms:.4f} ms = "
            f"{100 * k_ms / w_ms:.2f}% of it; device busy "
            f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['kernel_launches']:.0f} launches ({card})")
    split = {}
    for gname, fields in (("extended", grids["extended"]),
                          ("mega_chunk", grids["mega_chunk"])):
        split[gname] = evaluate_split(fields, nets, dev)
        log(f"[6] host split of evaluate_networks at {gname} (ms, median of "
            f"{REPS}, synchronised at each stage): " + ", ".join(
                f"{k} {v:.3f}" for k, v in split[gname].items())
            + f" ({card})")
    log("dse " + json.dumps({"grids": per_grid, "launches": launches,
                             "evaluate_networks": e2e, "host_split": split,
                             "build": build}))

    rows = []
    for kname in kernels:
        ext_r = per_grid[kname]["extended"]
        rows.append(dict(
            name=kname, route="cuda", source=SOURCES[kname],
            replaces=REPLACES[kname],
            launches=(launches[kname] + stream_launches[kname]
                      + codesign_launches[kname]
                      + deadline_launches[kname]
                      + service_launches[kname]),
            max_abs_err=max(g["max_abs_err"] for g in per_grid[kname].values()),
            max_rel_err=max(g["max_rel_err"] for g in per_grid[kname].values()),
            ms=ext_r["kernel_ms"], device_ms=ext_r["device_ms"],
            host_us=ext_r["host_us"], plain_ms=ext_r["plain_ms"],
            bound_ms=ext_r["bound_ms"], bound_by=ext_r["bound_by"],
            library_ms=None, shape="extended_grid x 18 networks"))
    return rows


# ---------------------------------------------------------------------------
# 2. The streamed DSE: stream_networks, stream_layer_topk, their resumable
# fold state and the streamed §IV.A chip
# ---------------------------------------------------------------------------

#: Rows a chunk of the streamed sweeps (their default): 12 chunks of mega.
STREAM_CHUNK = 4096
STREAM_REPS = 5
#: The chunk boundary at which a stream's state is exported and resumed.
KILL_AT = 5
#: The stages a streamed sweep marks (``energymodel._stage_hook``).
STREAM_STAGES = ("layer stacking", "layer host-to-device", "stream setup",
                 "config columns", "count dedup", "mapping dedup",
                 "config host-to-device", "heavy stage", "gather-combine",
                 "chunk fold", "stream finish")
#: Fields of the two streamed results compared at rtol 1e-12 across
#: backends, and those that must be equal.
STREAM_VALUES = ("min_energy", "min_latency", "min_edp", "min_metric",
                 "topk_metric", "layer_min_metric", "layer_energy",
                 "layer_latency", "boundary_energy", "boundary_latency")
STREAM_INDICES = ("argmin", "topk_idx", "layer_argmin", "boundary_idx")


def _bits_differ(x, y) -> bool:
    import numpy as np
    if isinstance(x, dict) or isinstance(y, dict):
        return (not isinstance(x, dict) or not isinstance(y, dict)
                or list(x) != list(y)
                or any(_bits_differ(x[k], y[k]) for k in x))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return (x.dtype != y.dtype or x.shape != y.shape
                or x.tobytes() != y.tobytes())
    return x != y


def differing(a, b) -> list:
    """The fields of two streamed results whose bits differ."""
    import dataclasses
    return [f.name for f in dataclasses.fields(b)
            if _bits_differ(getattr(a, f.name), getattr(b, f.name))]


def agreement(a, b) -> tuple:
    """(largest relative difference of the values, indices equal) of two
    streamed results; +inf where the infinities or shapes differ."""
    import numpy as np
    rel = 0.0
    for f in STREAM_VALUES:
        x, y = getattr(a, f, None), getattr(b, f, None)
        if x is None and y is None:
            continue
        pairs = zip(x.values(), y.values()) if isinstance(y, dict) \
            else [(x, y)]
        for u, w in pairs:
            u, w = np.asarray(u), np.asarray(w)
            fin = np.isfinite(w)
            if u.shape != w.shape or not np.array_equal(np.isfinite(u), fin) \
                    or (u[~fin] != w[~fin]).any():
                return float("inf"), False
            d = np.abs(u[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1e-300)
            rel = max(rel, float(d.max(initial=0.0)))
    same = not any(_bits_differ(getattr(a, f, None), getattr(b, f, None))
                   for f in STREAM_INDICES)
    return rel, same


def dense_stream(e, t, sr):
    """The reductions of ``stream_networks`` computed in one piece, in
    numpy, from dense [n, n_net] outputs, with ``sr``'s parameters."""
    import numpy as np
    from repro_torch.core import energymodel as em
    v = em._metric_of(sr.metric, e, t)
    idx = np.broadcast_to(np.arange(v.shape[0])[:, None], v.shape)
    order = np.lexsort((idx, v), axis=0)[:sr.topk_idx.shape[0]]
    min_m = v.min(axis=0)
    b_idx, b_e, b_t = {}, {}, {}
    for j, nm in enumerate(sr.networks):
        sel = np.flatnonzero(v[:, j] <= min_m[j] * (1.0 + sr.bound))
        sel = sel[np.argsort(v[sel, j], kind="stable")]
        b_idx[nm], b_e[nm], b_t[nm] = sel, e[sel, j], t[sel, j]
    return em.StreamResult(
        networks=sr.networks, n_cfg=v.shape[0], metric=sr.metric,
        bound=sr.bound, min_energy=e.min(axis=0), min_latency=t.min(axis=0),
        min_metric=min_m, argmin=v.argmin(axis=0),
        topk_idx=np.take_along_axis(idx, order, axis=0),
        topk_metric=np.take_along_axis(v, order, axis=0),
        boundary_idx=b_idx, boundary_energy=b_e, boundary_latency=b_t,
        device=sr.device, backend=sr.backend)


def dense_layer_stream(e, t, lt, dev):
    """The reductions of ``stream_layer_topk`` computed in one piece from
    dense [n, n_net, n_layer] outputs, with ``lt``'s parameters: the
    layer sums by torch on ``dev``, as the stream sums them, the rest in
    numpy."""
    import numpy as np
    import torch
    from repro_torch.core import energymodel as em
    es, ts = (torch.as_tensor(a, device=dev).sum(dim=-1).cpu().numpy()
              for a in (e, t))
    v = em._metric_of(lt.metric, es, ts)
    idx = np.broadcast_to(np.arange(v.shape[0])[:, None], v.shape)
    order = np.lexsort((idx, v), axis=0)[:lt.topk_idx.shape[0]]
    valid = np.arange(e.shape[2])[None, :] < lt.layer_counts[:, None]
    vl = np.where(valid[None], em._metric_of(lt.metric, e, t), np.inf)
    min_m = v.min(axis=0)
    b_idx, b_e, b_t = {}, {}, {}
    for j, nm in enumerate(lt.networks):
        sel = np.flatnonzero(v[:, j] <= min_m[j] * (1.0 + lt.bound))
        sel = sel[np.lexsort((sel, v[sel, j]))]
        b_idx[nm], b_e[nm], b_t[nm] = sel, es[sel, j], ts[sel, j]
    lmin = vl.min(axis=0)
    return em.LayerTopK(
        networks=lt.networks, n_cfg=v.shape[0], metric=lt.metric,
        layer_counts=lt.layer_counts,
        topk_idx=np.take_along_axis(idx, order, axis=0),
        topk_metric=np.take_along_axis(v, order, axis=0),
        layer_energy=np.take_along_axis(e, order[:, :, None], axis=0),
        layer_latency=np.take_along_axis(t, order[:, :, None], axis=0),
        min_energy=es.min(axis=0), min_latency=ts.min(axis=0),
        min_edp=(es * ts).min(axis=0), min_metric=min_m,
        argmin=v.argmin(axis=0), layer_min_metric=lmin,
        layer_argmin=np.where(np.isfinite(lmin), vl.argmin(axis=0), -1),
        bound=lt.bound, boundary_idx=b_idx, boundary_energy=b_e,
        boundary_latency=b_t)


def _bitwise(label, diffs) -> None:
    if diffs:
        fail(f"{label}: fields {diffs} differ in their bits")
    log(f"[2] {label}: bit for bit")


def _payload_keys(kind, n_net) -> list:
    """The keys of an exported fold state (the reference's layout)."""
    n_state = 6 if kind == "networks" else 11
    return sorted([f"state_{i}" for i in range(n_state)] + ["meta"]
                  + [f"cand{j}_{x}" for j in range(n_net)
                     for x in ("idx", "e", "t")])


def dse_stream(dev, card, nets, chip) -> dict:
    """The streamed DSE on the card: both streams at mega x 18 and the
    streamed §IV.A chip with the launch counts set to 0 just before and
    read just after; held bit for bit against dense folds, a second chunk
    size and a kill and resume, against the plain backend at rtol 1e-12;
    timed.  Prints the ``dse_stream`` line → the path's launches."""
    import numpy as np
    import tempfile
    from repro_torch.core import accelerator, dse, energymodel as em, hetero
    from repro_torch.kernels.count_terms import ops

    mega, ext = accelerator.mega_grid(), accelerator.extended_grid()
    paper = accelerator.ConfigGrid.product()
    n_chunks = -(-mega.n // STREAM_CHUNK)
    states = {"networks": [], "layer_topk": []}

    def stream(**kw):
        return dse.stream_grid(nets, mega, bound=0.05, metric="edp",
                               topk=16, **kw)

    def layer_stream(**kw):
        return dse.stream_layer_grid(nets, mega, bound=0.05, topk=8, **kw)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sr = stream(on_chunk=states["networks"].append)
    after_sr = ops.launch_counts()
    lt = layer_stream(on_chunk=states["layer_topk"].append)
    after_lt = ops.launch_counts()
    sr_paper = dse.stream_grid(nets, paper, chunk_size=50, bound=0.05)
    schip = hetero.design_chip_streaming(sr_paper, paper, nets, max_cores=3)
    sr_ext = dse.stream_grid(nets, ext, bound=0.05)
    schip_ext = hetero.design_chip_streaming(sr_ext, ext, nets, max_cores=3)
    launches = ops.launch_counts()
    backend = em.last_backend()
    log(f"[2] streamed DSE path in {time.perf_counter() - t0:.1f} s: "
        f"backend {backend}, launches {launches} (after stream_networks "
        f"{after_sr}, after stream_layer_topk {after_lt}; {n_chunks} "
        f"chunks of {STREAM_CHUNK} a mega stream)")
    if backend != "cuda" or sr.backend != "cuda":
        fail(f"streamed path ran on backend {backend!r}")
    if after_sr != {"count_terms": n_chunks, "count_layers": 0}:
        fail(f"stream_networks launched {after_sr}, expected count_terms "
             f"once a chunk ({n_chunks})")
    if after_lt["count_layers"] != n_chunks or \
            after_lt["count_terms"] != n_chunks:
        fail(f"stream_layer_topk launched {after_lt}, expected "
             f"count_layers once a chunk ({n_chunks})")

    n_net = len(nets)
    n_layer = int(em.network_layer_counts(nets).max())
    shapes = ((sr.topk_idx, (16, n_net)), (sr.min_metric, (n_net,)),
              (lt.layer_energy, (8, n_net, n_layer)),
              (lt.layer_min_metric, (n_net, n_layer)))
    if any(a.shape != shape for a, shape in shapes):
        fail(f"streamed shapes {[a.shape for a, _ in shapes]}")
    for r in (sr, lt):
        finite = all(np.isfinite(a).all() and (a > 0).all()
                     for a in (r.min_energy, r.min_latency, r.min_metric,
                               r.topk_metric))
        first = all(r.boundary_idx[nm][0] == r.argmin[j]
                    for j, nm in enumerate(r.networks))
        if not (finite and first and ((r.argmin >= 0)
                                      & (r.argmin < mega.n)).all()):
            fail(f"{type(r).__name__}: non-finite minima or a boundary set "
                 f"that does not start at the argmin")
    if not (np.isfinite(lt.layer_energy).all()
            and np.isfinite(lt.layer_latency).all()):
        fail("stream_layer_topk: non-finite top-k layer rows")

    # bit for bit: dense folds, a second chunk size, a kill and resume
    e_d, t_d = em.evaluate_networks(mega, nets, chunk_size=MEGA_CHUNK)
    _bitwise("stream_networks at mega x 18 against a fold of the dense "
          "evaluate_networks", differing(sr, dense_stream(e_d, t_d, sr)))
    _bitwise(f"stream_networks at chunk {MEGA_CHUNK} against chunk "
          f"{STREAM_CHUNK}", differing(stream(chunk_size=MEGA_CHUNK), sr))
    _bitwise(f"stream_layer_topk at chunk {MEGA_CHUNK} against chunk "
          f"{STREAM_CHUNK}",
          differing(layer_stream(chunk_size=MEGA_CHUNK), lt))
    lt_ext = dse.stream_layer_grid(nets, ext, bound=0.05, topk=8)
    e_pl, t_pl = em.evaluate_networks(ext, nets, per_layer=True)
    _bitwise("stream_layer_topk at extended x 18 against a fold of the dense "
          "per-layer evaluate_networks",
          differing(lt_ext, dense_layer_stream(e_pl, t_pl, lt_ext, dev)))
    del e_d, t_d, e_pl, t_pl
    resume = {}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for kind, full, run in (("networks", sr, stream),
                                ("layer_topk", lt, layer_stream)):
            st = states[kind][KILL_AT - 1]
            payload = st.export_state()
            meta = json.loads(payload["meta"])
            if st.next_chunk != KILL_AT or \
                    sorted(payload) != _payload_keys(kind, n_net) or \
                    meta["n_chunks"] != n_chunks or \
                    meta["chunk_size"] != STREAM_CHUNK:
                fail(f"{kind} state at chunk {KILL_AT}: keys "
                     f"{sorted(payload)}, meta {meta}")
            path = Path(tmp) / f"{kind}.npz"
            st.save(path)
            _bitwise(f"{kind} stream resumed from chunk {KILL_AT} (npz "
                  f"{path.stat().st_size} bytes)",
                  differing(run(resume_from=em.StreamFoldState.load(path)),
                            full))
            resume[kind] = dict(chunk=KILL_AT,
                                npz_bytes=path.stat().st_size)

    # the kernels against the plain backend on the card
    backends = {}
    for kind, got, want in (
            ("stream_networks", sr,
             lambda: em.stream_networks(mega, nets, device=dev,
                                        backend="torch")),
            ("stream_layer_topk", lt,
             lambda: em.stream_layer_topk(mega, nets, device=dev,
                                          backend="torch", bound=0.05))):
        rel, same = agreement(got, want())
        backends[kind] = dict(max_rel_err=rel, indices_equal=same)
        log(f"[2] {kind} at mega x 18, cuda against torch on the card: "
            f"max_rel_err {rel:.3e}, indices equal {same}")
        if not (rel <= RTOL and same):
            fail(f"{kind}: the kernels' stream disagrees with the plain one")

    # the streamed §IV.A chip: the dense cover, and the same on the CPU
    shape = (len(accelerator.ARRAY_SIZES), len(accelerator.GB_SIZES_KB),
             len(accelerator.GB_SIZES_KB))
    if (schip.core_cells(shape), schip.assignment) != \
            (chip.core_types, chip.assignment):
        fail(f"streamed chip {schip.core_cells(shape)} {schip.assignment} "
             f"differs from design_chip's {chip.core_types} "
             f"{chip.assignment}")
    cpu = hetero.design_chip_streaming(
        dse.stream_grid(nets, ext, device="cpu", bound=0.05), ext, nets,
        max_cores=3)
    if (cpu.core_types, cpu.assignment, cpu.candidate_sets) != \
            (schip_ext.core_types, schip_ext.assignment,
             schip_ext.candidate_sets):
        fail(f"streamed chip at extended differs: card "
             f"{schip_ext.core_types} {schip_ext.assignment}, CPU "
             f"{cpu.core_types} {cpu.assignment}")
    labels = [schip_ext.core_label(i, ext)
              for i in range(len(schip_ext.core_types))]
    log(f"[2] streamed §IV.A chip: the dense cover on the paper grid "
        f"{schip.core_cells(shape)}; at extended {labels}, the same on "
        f"the card and the CPU")

    # times: wall (median of STREAM_REPS), a trace, the host split
    times = {}
    for kind, call, kern, stages in (
            ("stream_networks", stream, "count_terms_kernel",
             STREAM_STAGES),
            ("stream_layer_topk", layer_stream, "count_layers_kernel",
             STREAM_STAGES + ("layer split",))):
        w_ms = wall_ms(call, reps=STREAM_REPS)
        prof = profile_ms(call, steps=2, match=(kern,))
        split = stage_split(call, stages, reps=3)
        times[kind] = dict(
            wall_ms=w_ms, device_ms=prof["device_ms"],
            busy_share=prof["busy_share"],
            launches_per_chunk=prof["kernel_launches"] / n_chunks,
            kernel_ms=prof["matched_ms"][kern],
            heavy_ms_per_chunk=split["heavy stage"] / n_chunks,
            fold_ms_per_chunk=split["chunk fold"] / n_chunks,
            split_ms=split, top_host=prof["top_host"])
        log(f"[6] {kind} at mega x 18 ({n_chunks} chunks): wall {w_ms:.2f} "
            f"ms (median of {STREAM_REPS}); device busy "
            f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['kernel_launches'] / n_chunks:.1f} launches a chunk, "
            f"{kern} {prof['matched_ms'][kern]:.4f} ms a call; a chunk's "
            f"fold {split['chunk fold'] / n_chunks:.3f} ms against its "
            f"heavy stage {split['heavy stage'] / n_chunks:.3f} ms on the "
            f"host clock ({card})")
        log(f"[6] host split of {kind} (ms over the call, synchronised at "
            f"each stage): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in split.items())
            + f" ({card})")
    log("dse_stream " + json.dumps({
        "card": card, "grid": "mega_grid x 18", "chunks": n_chunks,
        "chunk_size": STREAM_CHUNK, "launches": launches,
        "cuda_vs_torch": backends, "resume": resume, "times": times}))
    return launches


# ---------------------------------------------------------------------------
# 2. The per-layer chip + schedule co-design: co_design, co_design_streaming
# ---------------------------------------------------------------------------

#: The co-design search of ``examples/dse_hetero.py``: 4 cores of up to 3
#: types from a pool of 6 → 111 candidate chips, 1,998 problems at 18 CNNs.
CODESIGN_KW = dict(m_cores=4, max_types=3, pool_size=6)
CODESIGN_CHIPS = 111
CODESIGN_REPS = 5
#: The host stages a ``co_design`` call marks after the engine's own.
CODESIGN_MARKS = ("candidate pool", "problem expansion", "schedule solve",
                  "scoring")
#: The host stages ``hetero.py`` marks; engine stages between them go to
#: the phase of the last mark seen (none: "sweep or stream").
HETERO_MARKS = ("candidate pool", "problem expansion", "schedule solve",
                "slack solve", "pareto scoring", "degraded evaluation",
                "scenario solve", "scoring")
ENGINE_PHASE = {None: "sweep or stream",
                "candidate pool": "pool per-layer call",
                "problem expansion": "degraded evaluation"}


def marked_split(call, reps: int) -> tuple:
    """``reps`` calls of ``call()`` on the card, synchronised at each stage
    mark → ({phase: median ms, "total": median wall ms}, the marks seen in
    order).  A ``hetero.py`` mark closes its own phase; the engine's
    marks add to the phase of :data:`ENGINE_PHASE`."""
    import torch
    from repro_torch.core import energymodel as em

    runs, seqs = [], set()
    for _ in range(reps):
        ms, seen = {}, []
        t_start = time.perf_counter()
        last = [t_start]

        def mark(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            dt, last[0] = (now - last[0]) * 1e3, now
            if stage in HETERO_MARKS:
                seen.append(stage)
                key = stage
            else:
                key = ENGINE_PHASE.get(seen[-1] if seen else None, "engine")
            ms[key] = ms.get(key, 0.0) + dt

        em._stage_hook = mark
        try:
            call()
        finally:
            em._stage_hook = None
        torch.cuda.synchronize()
        end = time.perf_counter()
        ms["after the last mark"] = (end - last[0]) * 1e3
        ms["total"] = (end - t_start) * 1e3
        runs.append(ms)
        seqs.add(tuple(seen))
    if len(seqs) != 1:
        fail(f"stage marks differ between calls: {seqs}")
    split = {k: statistics.median(r.get(k, 0.0) for r in runs)
             for k in runs[0]}
    return split, list(seqs.pop())


def _max_rel(u, w) -> float:
    import numpy as np
    u, w = np.asarray(u, dtype=float), np.asarray(w, dtype=float)
    if u.shape != w.shape:
        return float("inf")
    d = np.abs(u - w) / np.maximum(np.abs(w), 1e-300)
    return float(d.max(initial=0.0))


def codesign_diffs(a, b) -> tuple:
    """(what differs, largest relative difference of the floats) of two
    ``CoDesign`` results: the pool, the candidates, the winning chip and
    each schedule's types, layer types and cores must be equal; the chip
    scores, energies, bottlenecks and loads within ``RTOL``."""
    import numpy as np
    out = [f"{f}: {getattr(a, f)} against {getattr(b, f)}"
           for f in ("pool", "chip_types", "chip_counts", "core_types",
                     "core_counts") if getattr(a, f) != getattr(b, f)]
    if out:
        out.append(f"scores {a.score!r} against {b.score!r}")
    names = list(a.schedules)
    if names != list(b.schedules):
        return out + [f"networks {names} against {list(b.schedules)}"], \
            float("inf")
    for nm in names:
        out += [f"{nm} {f}" for f in ("types", "layer_type", "layer_core")
                if getattr(a.schedules[nm], f) != getattr(b.schedules[nm], f)]
    loads = [np.concatenate([x.schedules[nm].loads for nm in names])
             for x in (a, b)]
    floats = {
        "chip_scores": (a.chip_scores, b.chip_scores),
        "score": (a.score, b.score),
        "homogeneous_score": (a.homogeneous_score, b.homogeneous_score),
        "energy": ([a.energy[n] for n in names], [b.energy[n] for n in names]),
        "latency": ([a.latency[n] for n in names],
                    [b.latency[n] for n in names]),
        "loads": tuple(loads)}
    rel = 0.0
    for k, (u, w) in floats.items():
        r = _max_rel(u, w)
        rel = max(rel, r)
        if not r <= RTOL:
            out.append(f"{k}: max_rel_err {r:.3e}")
    return out, rel


def _agree(label, a, b) -> float:
    diffs, rel = codesign_diffs(a, b)
    if diffs:
        fail(f"{label}: {diffs}")
    log(f"[2] {label}: pool, candidates, chip, layer types and cores "
        f"equal; floats within {rel:.3e}")
    return rel


def codesign_path(dev, card) -> dict:
    """The per-layer co-design on the card: ``co_design`` at extended x 18
    and ``co_design_streaming`` at extended and mega x 18 with the launch
    counts set to 0 just before and read just after; the kernels against
    the plain backend on the card, every winning schedule against the
    scalar oracle, the streamed search against the dense one; timed.
    Prints the ``codesign`` line → the path's launches."""
    import numpy as np
    from repro_torch.core import (accelerator, energymodel as em, hetero,
                                  partition, topology)
    from repro_torch.kernels.count_terms import ops

    nets = {n: topology.get_network(n) for n in topology.NETWORKS}
    ext, mega = accelerator.extended_grid(), accelerator.mega_grid()
    n_net = len(nets)
    lens = em.network_layer_counts(nets)
    n_layer = int(lens.max())

    def dense(backend=None):
        return hetero.co_design(ext, nets, **CODESIGN_KW, device=dev,
                                backend=backend)

    def streamed(grid):
        return hetero.co_design_streaming(grid, nets, **CODESIGN_KW,
                                          device=dev, chunk_size=STREAM_CHUNK)

    # the path, as a user calls it: the card and the kernels by default
    counts = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cd = hetero.co_design(ext, nets, **CODESIGN_KW)
    counts["co_design extended"] = ops.launch_counts()
    sd = hetero.co_design_streaming(ext, nets, **CODESIGN_KW,
                                    chunk_size=STREAM_CHUNK)
    counts["co_design_streaming extended"] = ops.launch_counts()
    md = hetero.co_design_streaming(mega, nets, **CODESIGN_KW,
                                    chunk_size=STREAM_CHUNK)
    launches = ops.launch_counts()
    counts["co_design_streaming mega"] = launches
    backend = em.last_backend()
    secs = time.perf_counter() - t0
    per_call, prev = {}, {k: 0 for k in launches}
    for call, now in counts.items():
        per_call[call] = {k: now[k] - prev[k] for k in now}
        prev = now
    want = {"co_design extended": {"count_terms": 1, "count_layers": 1}}
    for gname, grid in (("extended", ext), ("mega", mega)):
        want[f"co_design_streaming {gname}"] = {
            "count_terms": 0,
            "count_layers": -(-grid.n // STREAM_CHUNK) + 1}
    log(f"[2] co-design path in {secs:.1f} s: backend {backend}, launches "
        f"a call {per_call}")
    if backend != "cuda":
        fail(f"co-design path ran on backend {backend!r}")
    if per_call != want:
        fail(f"co-design launches {per_call}, expected {want} (the sweep's "
             f"count_terms, one count_layers a chunk and one for the pool)")

    # the problem set: shapes, and the kernels against the plain backend
    probs = {b: hetero.codesign_problems(ext, nets, **CODESIGN_KW,
                                         device=dev, backend=b)
             for b in ("cuda", "torch")}
    p = probs["cuda"]
    n_b = CODESIGN_CHIPS * n_net
    shapes = {"lat_dense": (n_b, 3, n_layer), "counts": (n_b, 3),
              "n_layers_b": (n_b,), "e_layer": (6, n_net, n_layer),
              "t_layer": (6, n_net, n_layer)}
    got = {f: getattr(p, f).shape for f in shapes}
    if got != shapes or len(p.chips) != CODESIGN_CHIPS:
        fail(f"co-design problem shapes {got}, {len(p.chips)} chips; "
             f"expected {shapes}, {CODESIGN_CHIPS}")
    if not all(np.isfinite(getattr(p, f)).all() and (getattr(p, f) >= 0).all()
               for f in ("lat_dense", "e_layer", "t_layer")):
        fail("co-design problem tensors: non-finite or negative values")
    if (p.pool, p.chips) != (probs["torch"].pool, probs["torch"].chips):
        fail(f"pool differs between backends: cuda {p.pool}, torch "
             f"{probs['torch'].pool}")
    tensor_rel = max(_max_rel(getattr(p, f), getattr(probs["torch"], f))
                     for f in ("lat_dense", "e_layer", "t_layer",
                               "min_energy", "min_latency", "min_edp"))
    if not tensor_rel <= RTOL:
        fail(f"co-design problem tensors: cuda against torch {tensor_rel}")
    log(f"[2] codesign_problems at extended x 18: {len(p.chips)} chips, "
        f"{p.n_problems} problems, lat_dense {p.lat_dense.shape}; cuda "
        f"against torch on the card within {tensor_rel:.3e}")
    del probs, p

    agree = {"cuda_vs_torch": _agree(
        "co_design at extended x 18, cuda against torch on the card",
        cd, dense("torch"))}

    # every winning schedule against the scalar oracle, bit for bit, on the
    # port's own per-layer tensors of the winning types
    e_l, t_l = em.evaluate_networks(ext.take(cd.core_types), nets,
                                    device=dev, per_layer=True)
    for j, nm in enumerate(nets):
        oracle = partition.schedule_hetero_oracle(t_l[:, j, :lens[j]],
                                                  cd.core_counts)
        s = cd.schedules[nm]
        if not (s.bottleneck == oracle["bottleneck"] == cd.latency[nm]
                and s.layer_type == tuple(int(t) for t in
                                          oracle["layer_type"])):
            fail(f"{nm}: schedule bottleneck {s.bottleneck!r} against the "
                 f"oracle's {oracle['bottleneck']!r}, or its layer types "
                 f"differ")
        want_e = e_l[oracle["layer_type"], j, np.arange(lens[j])].sum()
        if not _max_rel(cd.energy[nm], want_e) <= RTOL:
            fail(f"{nm}: scheduled energy {cd.energy[nm]!r} against "
                 f"{want_e!r}")
    log(f"[2] co_design's {n_net} winning schedules equal "
        f"schedule_hetero_oracle bit for bit (bottleneck, layer types)")
    agree["streamed_vs_dense"] = _agree(
        f"co_design_streaming at extended (chunks of {STREAM_CHUNK}) "
        f"against co_design", sd, cd)
    if not (md.n_chips == CODESIGN_CHIPS and sum(md.core_counts) == 4
            and np.isfinite(md.chip_scores).all()
            and md.score <= md.homogeneous_score
            and all(md.schedules[nm].n_layers == lens[j]
                    for j, nm in enumerate(nets))):
        fail(f"co_design_streaming at mega: {md.n_chips} chips, counts "
             f"{md.core_counts}, score {md.score} against homogeneous "
             f"{md.homogeneous_score}")
    log(f"[2] co-designed chip at extended x 18: {cd.summary(ext)} (score "
        f"{cd.score:.6f}, best homogeneous {cd.homogeneous_score:.6f}); at "
        f"mega x 18 from the stream: {md.summary(mega)} (score "
        f"{md.score:.6f}, best homogeneous {md.homogeneous_score:.6f})")

    # times: wall (median of CODESIGN_REPS), the split by phase, a trace
    times = {}
    match = ("count_terms_kernel", "count_layers_kernel")
    for name, call, steps in (
            ("co_design extended", dense, 2),
            ("co_design_streaming mega", lambda: streamed(mega), 1)):
        w_ms = wall_ms(call, reps=CODESIGN_REPS)
        split, marks = marked_split(call, 3)
        if tuple(marks) != CODESIGN_MARKS:
            fail(f"co-design marked {marks}, expected {CODESIGN_MARKS}")
        prof = profile_ms(call, steps=steps, match=match)
        times[name] = dict(
            wall_ms=w_ms, split_ms=split, device_ms=prof["device_ms"],
            busy_share=prof["busy_share"],
            device_launches=prof["kernel_launches"],
            kernel_ms=prof["matched_ms"], launches=per_call[name],
            top_host=prof["top_host"])
        log(f"[6] {name} x 18: wall {w_ms:.2f} ms (median of "
            f"{CODESIGN_REPS}); device busy {prof['device_ms']:.3f} ms "
            f"({100 * prof['busy_share']:.2f}%), "
            f"{prof['kernel_launches']:.0f} device launches, kernels "
            f"{prof['matched_ms']}, count-terms launches {per_call[name]} "
            f"({card})")
        log(f"[6] split of {name} (ms, median of 3, synchronised at each "
            f"mark): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ({card})")
    log("codesign " + json.dumps({
        "card": card, "kw": CODESIGN_KW, "chunk_size": STREAM_CHUNK,
        "chips": CODESIGN_CHIPS, "problems": n_b,
        "launches_per_call": per_call, "agreement_max_rel": agree,
        "chip_extended": cd.summary(ext), "score_extended": cd.score,
        "chip_mega": md.summary(mega), "score_mega": md.score,
        "times": times}))
    return launches


# ---------------------------------------------------------------------------
# 2. The co-design under a deadline and under faults:
# score_codesign(deadline=), pareto_codesign, resilience_codesign
# ---------------------------------------------------------------------------

#: Relative deadline (x each network's sweep-minimum latency) of the
#: deadline calls, and the degraded PE arrays of the resilience search:
#: S = 1 + 3 x (1 + 2) = 10 scenarios a chip.
DEADLINE = 2.0
DEGRADATIONS = ((2, 2), (4, 4))
RESIL_SCENARIOS = 1 + 3 * (1 + len(DEGRADATIONS))
#: Seeded samples held against the scalar oracles, bit for bit.
SLACK_CELLS = 32
RESIL_CELLS = 40
#: Past this many seconds of the phase, the slack calls are timed once.
DEADLINE_BUDGET_S = 90.0
def _field_diffs(a, b) -> list:
    """Fields of two result dataclasses that are not identical (arrays
    equal element for element, +inf included)."""
    import dataclasses
    import numpy as np
    out = []
    for f in dataclasses.fields(a):
        u, w = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, np.ndarray) or isinstance(w, np.ndarray):
            same = (u is None and w is None) or (
                u is not None and w is not None and u.shape == w.shape
                and np.array_equal(u, w))
        else:
            same = u == w
        if not same:
            out.append(f.name)
    return out


def _identical(label, a, b) -> None:
    diffs = _field_diffs(a, b)
    if diffs:
        fail(f"{label}: fields differ: {diffs}")
    log(f"[2] {label}: every field identical")


def _scenario_inputs(p, en_b, rc, deg_layers, c, j, s, lens):
    """(latencies [T, L_j], energies [T, L_j], counts [T]) of resilience
    cell (chip c, network j, scenario s), rebuilt from the problem set,
    its expanded energies ``en_b`` and the degraded pools' per-layer
    tensors."""
    b, n_l = c * len(p.names) + j, int(lens[j])
    lat = p.lat_dense[b, :, :n_l].copy()
    en = en_b[b, :, :n_l].copy()
    cnt = p.counts[b].copy()
    name = rc.scenario_names[s]
    if s:
        slot = int(name.split("slot")[1])
        if name.startswith("core_loss"):
            cnt[slot] = max(cnt[slot] - 1, 0)
        else:
            r, cc = (int(x) for x in
                     name.split("@")[0].removeprefix("degrade_r").split("c"))
            e_d, t_d = deg_layers[(r, cc)]
            row = rc.chip_types[c][slot]
            lat[slot] = t_d[row, j, :n_l]
            en[slot] = e_d[row, j, :n_l]
    return lat, en, cnt


def deadline_path(dev, card) -> dict:
    """The co-design under a deadline and under faults on the card, at
    extended x 18 (111 chips, 1,998 problems): ``resilience_codesign``
    with ``DEGRADATIONS`` (a [1998, 10, 3, 251] block, the degraded pools
    through ``count_layers``), ``score_codesign(deadline=2.0)``,
    ``pareto_codesign(n_deadlines=8, slack=True)``, and
    ``pareto_codesign(n_deadlines=12)`` on the streamed mega x 18 problem
    set; the launch counts set to 0 just before and read just after.
    The kernels against the plain backend on the degraded pools; every
    resilience field on both backends; seeded cells against the scalar
    oracles bit for bit; the Pareto guardrails; timed.  Prints the
    ``deadline`` line → the path's launches."""
    import numpy as np
    import torch
    from repro_torch.core import (accelerator, energymodel as em, hetero,
                                  partition, topology)
    from repro_torch.ft import hw_faults
    from repro_torch.kernels.count_terms import ops, ref

    t_phase = time.perf_counter()
    nets = {n: topology.get_network(n) for n in topology.NETWORKS}
    ext, mega = accelerator.extended_grid(), accelerator.mega_grid()
    n_net = len(nets)
    lens = em.network_layer_counts(nets)
    n_b = CODESIGN_CHIPS * n_net
    rkw = dict(CODESIGN_KW, degradations=DEGRADATIONS)
    skw = dict(CODESIGN_KW, chunk_size=STREAM_CHUNK)

    # the path, as a user calls it: the card and the kernels by default
    counts, calls = {}, {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = hetero.resilience_codesign(ext, nets, **rkw)
    counts["resilience_codesign"] = ops.launch_counts()
    p = hetero.codesign_problems(ext, nets, **CODESIGN_KW)
    res = partition.batch_schedule_hetero(p.lat_dense, p.counts,
                                          n_layers=p.n_layers_b)
    sd = hetero.score_codesign(p, res, m_cores=4, deadline=DEADLINE)
    ps = hetero.pareto_codesign(p, res, n_deadlines=8, slack=True)
    counts["score_codesign and pareto_codesign, extended"] = \
        ops.launch_counts()
    rd = hetero.resilience_codesign(ext, nets, **rkw, probs=p,
                                    deadline=DEADLINE)
    counts["resilience_codesign(deadline=, probs=)"] = ops.launch_counts()
    pm_probs = hetero.codesign_problems_streaming(mega, nets, **skw)
    pm = hetero.pareto_codesign(pm_probs, n_deadlines=12)
    launches = ops.launch_counts()
    counts["pareto_codesign, streamed mega"] = launches
    backend = em.last_backend()
    secs = time.perf_counter() - t0
    per_call, prev = {}, {k: 0 for k in launches}
    for call, now in counts.items():
        per_call[call] = {k: now[k] - prev[k] for k in now}
        prev = now
    n_deg = len(DEGRADATIONS)
    want = {"resilience_codesign": {"count_terms": 1,
                                    "count_layers": 1 + n_deg},
            "score_codesign and pareto_codesign, extended": {
                "count_terms": 1, "count_layers": 1},
            "resilience_codesign(deadline=, probs=)": {
                "count_terms": 0, "count_layers": n_deg},
            "pareto_codesign, streamed mega": {
                "count_terms": 0,
                "count_layers": -(-mega.n // STREAM_CHUNK) + 1}}
    log(f"[2] deadline and fault co-design path in {secs:.1f} s: backend "
        f"{backend}, launches a call {per_call}")
    if backend != "cuda":
        fail(f"deadline path ran on backend {backend!r}")
    if per_call != want:
        fail(f"deadline path launches {per_call}, expected {want} (the "
             f"sweep's count_terms, one count_layers for the pool, one a "
             f"degraded pool and one a chunk)")

    # shapes and finiteness
    S = RESIL_SCENARIOS
    if not (rc.n_chips == CODESIGN_CHIPS and len(rc.scenario_names) == S
            and rc.bottleneck.shape == (CODESIGN_CHIPS, n_net, S)
            and rc.pool == p.pool and rd.pool == p.pool
            and np.isfinite(rc.nominal_score).all()
            and np.isfinite(sd.score) and sum(sd.core_counts) == 4
            and ps.slack_energy.shape == (CODESIGN_CHIPS, n_net, 8)
            and pm.scores.shape == (CODESIGN_CHIPS, 12)):
        fail(f"deadline path outputs: {rc.n_chips} chips, "
             f"{len(rc.scenario_names)} scenarios, bottleneck "
             f"{rc.bottleneck.shape}, pools {rc.pool} {rd.pool} {p.pool}, "
             f"deadline score {sd.score}, slack {ps.slack_energy.shape}, "
             f"mega scores {pm.scores.shape}")
    feas = rc.feasible
    if not (np.isfinite(rc.bottleneck[feas]).all()
            and (rc.bottleneck[feas] > 0).all()
            and np.isinf(rc.energy[~feas]).all()
            and feas[:, :, 0].all()):
        fail("resilience cells: a feasible cell is not finite and "
             "positive, an infeasible one is not +inf, or a nominal "
             "cell is infeasible")

    # the kernels against the plain versions on the degraded pools (new
    # inputs of count_layers: PE arrays that are in no grid)
    lay_np, _ = em._stack_networks(nets)
    lay = {k: torch.as_tensor(v).to(dev)[None, :] for k, v in lay_np.items()}
    int_terms = [k for k in range(ops.N_TERMS) if k not in FLOAT_TERMS]
    pool_grid = ext.take(p.pool)
    pe = {"pool": [(int(r), int(c)) for r, c in
                   zip(pool_grid.fields["rows"], pool_grid.fields["cols"])]}
    deg_layers, deg_checks, deg_cfg = {}, {}, {}
    for r, c in DEGRADATIONS:
        deg = hw_faults.degrade_rows(pool_grid, r, c)
        pe[f"r{r}c{c}"] = [(int(a), int(b)) for a, b in
                           zip(deg.fields["rows"], deg.fields["cols"])]
        _, cfg_u, _, _, _ = em._prepare_fields(deg.fields, dev)
        deg_cfg[(r, c)] = cfg_u
        out = torch.stack(ops.count_term_layers(cfg_u, lay))
        torch.cuda.synchronize()
        want_t = ref.count_term_layers_ref(cfg_u, lay)
        diff = (out - want_t).abs()
        rel = float((diff / want_t.abs().clamp_min(1e-300)).max())
        int_exact = bool(torch.equal(out[int_terms], want_t[int_terms]))
        zeros = bool(((out == 0) == (want_t == 0)).all())
        exact = int((out == want_t).sum()) / out.numel()
        e_c, t_c = em.evaluate_networks(deg, nets, device=dev,
                                        backend="cuda", per_layer=True)
        e_t, t_t = em.evaluate_networks(deg, nets, device=dev,
                                        backend="torch", per_layer=True)
        same = np.array_equal(e_c, e_t) and np.array_equal(t_c, t_t)
        deg_layers[(r, c)] = (e_c, t_c)
        deg_checks[f"r{r}c{c}"] = dict(
            shape=list(out.shape), max_rel_err=rel,
            max_abs_err=float(diff.max()), int_terms_exact=int_exact,
            bit_equal_share=exact, per_layer_identical=same)
        log(f"[2] count_layers on the pool degraded by r{r}c{c} (PE arrays "
            f"{pe[f'r{r}c{c}']}) {tuple(out.shape)}: integer terms bit for "
            f"bit {int_exact}, terms 8 and 13 within {rel:.3e}, zeros match "
            f"{zeros}, bit-equal share {exact}; per-layer energy and "
            f"latency cuda = torch {same}")
        if not (int_exact and rel <= RTOL and zeros and same):
            fail(f"count_layers on the r{r}c{c} degraded pool disagrees "
                 f"with its plain version")
        del out, want_t, diff
    torch.cuda.empty_cache()

    # the first degraded pool's count_layers launch: events, traced device
    # time a launch, host µs a call, its plain version, and the bound on
    # the plain mapping and terms a count row (as dse_path counts them)
    cfg_u0 = deg_cfg[DEGRADATIONS[0]]
    n_u, n_l = cfg_u0["rows"].shape[0], lay["m"].shape[1]
    n_bytes = (len(ops.CFG_COLUMNS) * n_u + 14 * n_u * n_l
               + len(ops.LAYER_FIELDS) * n_l) * 8
    flops = plain_ops_per_pair()["count_layers"]["u"] * n_u * n_l
    b_ms, b_by = bound(n_bytes, flops, FP64_FLOPS)

    def kern():
        return ops.count_term_layers(cfg_u0, lay)

    prof = profile_ms(kern, steps=50, match=("count_layers_kernel",))
    enq_us, end_us = host_us(kern, calls=200)
    deg_time = dict(
        pool=f"r{DEGRADATIONS[0][0]}c{DEGRADATIONS[0][1]}", n_u=n_u,
        n_layers=n_l, kernel_ms=cuda_ms(kern),
        device_ms=prof["matched_per_launch_ms"]["count_layers_kernel"],
        host_us=enq_us, host_end_us=end_us,
        plain_ms=cuda_ms(lambda: ref.count_term_layers_ref(cfg_u0, lay)),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, fp64_ops=flops)
    log(f"[6] count_layers on the {deg_time['pool']} degraded pool ({n_u} "
        f"count rows x {n_l} layers): events {deg_time['kernel_ms']:.4f} ms "
        f"a call, device {deg_time['device_ms']:.4f} ms a launch, host "
        f"{enq_us:.1f} us a call ({end_us:.1f} to the end), plain "
        f"{deg_time['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}) "
        f"({card})")

    # every resilience field on both backends, the problem sets too
    p_t = hetero.codesign_problems(ext, nets, **CODESIGN_KW, device=dev,
                                   backend="torch")
    if _field_diffs(p, p_t):
        fail(f"extended problem set: cuda and torch differ in "
             f"{_field_diffs(p, p_t)}")
    _identical("resilience_codesign at extended x 18, cuda against torch",
               rc, hetero.resilience_codesign(ext, nets, **rkw, device=dev,
                                              backend="torch"))
    _identical("resilience_codesign(deadline=2.0), cuda against torch", rd,
               hetero.resilience_codesign(ext, nets, **rkw, device=dev,
                                          backend="torch", probs=p_t,
                                          deadline=DEADLINE))
    pm_t = hetero.pareto_codesign(hetero.codesign_problems_streaming(
        mega, nets, **skw, device=dev, backend="torch"), n_deadlines=12)
    _identical("pareto_codesign on the streamed mega x 18 set, cuda "
               "against torch", pm, pm_t)

    # seeded cells against the scalar oracles, bit for bit
    rng = np.random.default_rng(0)
    t_max = p.counts.shape[1]
    en_b = hetero._expand_pool_tensor(p.e_layer, p.chips, n_net, t_max)
    moved = np.argwhere(ps.slack_moves > 0)
    pick = np.concatenate([
        moved[rng.choice(len(moved), SLACK_CELLS // 2, replace=False)],
        np.stack([rng.integers(0, CODESIGN_CHIPS, SLACK_CELLS // 2),
                  rng.integers(0, n_net, SLACK_CELLS // 2),
                  rng.integers(0, 8, SLACK_CELLS // 2)], axis=1)])
    best = p.chips.index((tuple(p.pool.index(t) for t in sd.core_types),
                          tuple(sd.core_counts)))
    cells = [(int(c), int(j), int(d), ps.deadlines[d]) for c, j, d in pick]
    cells += [(best, j, -1, DEADLINE) for j in range(n_net)]
    for c, j, d, rel_dl in cells:
        b, n_l = c * n_net + j, int(lens[j])
        o = partition.slack_schedule_oracle(
            p.lat_dense[b, :, :n_l], en_b[b, :, :n_l], p.counts[b],
            p.min_latency[j] * rel_dl)
        if d >= 0:
            got = (ps.slack_latency[c, j, d], ps.slack_energy[c, j, d],
                   ps.slack_moves[c, j, d])
        else:       # score_codesign's winner: feasible, its schedules
            nm = list(nets)[j]
            got = (sd.latency[nm], sd.energy[nm], o["n_moves"])
            if not o["feasible"] or sd.schedules[nm].layer_type != tuple(
                    int(t) for t in o["layer_type"]):
                fail(f"score_codesign(deadline=): {nm} is infeasible or "
                     f"its layer types differ from slack_schedule_oracle's")
        if not (got[0] == o["bottleneck"] and got[1] == o["energy"]
                and got[2] == o["n_moves"]):
            fail(f"slack cell (chip {c}, {list(nets)[j]}, deadline "
                 f"{rel_dl}): {got} against the oracle's "
                 f"{(o['bottleneck'], o['energy'], o['n_moves'])}")
    n_slack = len(cells)
    log(f"[2] {n_slack} slack cells ({SLACK_CELLS} of pareto_codesign, "
        f"{SLACK_CELLS // 2} of them with moves; the {n_net} of "
        f"score_codesign's winner) equal slack_schedule_oracle bit for "
        f"bit (bottleneck, energy, moves, layer types)")

    valid = np.argwhere(rc.valid | (np.arange(S) == 0)[None, :])
    r_cells = valid[rng.choice(len(valid), RESIL_CELLS, replace=False)]
    n_dead = 0
    for c, s in r_cells:
        j = int(rng.integers(n_net))
        lat, en, cnt = _scenario_inputs(p, en_b, rc, deg_layers, int(c), j,
                                        int(s), lens)
        if not (cnt > 0).any():
            n_dead += 1
            if rc.feasible[c, j, s] or rd.feasible[c, j, s]:
                fail(f"resilience cell (chip {c}, net {j}, scenario {s}) "
                     f"has no core left but is reported feasible")
            continue
        o = partition.schedule_hetero_oracle(lat, cnt)
        od = partition.slack_schedule_oracle(lat, en, cnt,
                                             p.min_latency[j] * DEADLINE)
        ok = (rc.bottleneck[c, j, s] == o["bottleneck"]
              and _max_rel(rc.energy[c, j, s],
                           en[o["layer_type"], np.arange(len(o["layer_type"]))]
                           .sum()) <= RTOL
              and rd.bottleneck[c, j, s] == od["bottleneck"]
              and rd.feasible[c, j, s] == od["feasible"]
              and rd.slack_moves[c, j, s] == od["n_moves"]
              and (not od["feasible"] or rd.energy[c, j, s] == od["energy"]))
        if not ok:
            fail(f"resilience cell (chip {c}, net {j}, "
                 f"{rc.scenario_names[s]}): bottleneck "
                 f"{rc.bottleneck[c, j, s]!r} against "
                 f"{o['bottleneck']!r}; deadline mode "
                 f"{rd.bottleneck[c, j, s]!r} {rd.energy[c, j, s]!r} "
                 f"against {od['bottleneck']!r} {od['energy']!r}")
    log(f"[2] {RESIL_CELLS} resilience cells ({n_dead} with every core "
        f"dead, reported infeasible) equal schedule_hetero_oracle and, "
        f"under deadline {DEADLINE}, slack_schedule_oracle bit for bit")

    # the guardrails: a slack point never costs more than its base point
    # nor misses its deadline; the fronts hold their winners
    dl_abs = p.min_latency[:, None] * ps.deadlines[None, :]
    s_feas = ps.slack_latency <= dl_abs[None]
    guard = {
        "slack energy <= base": bool(
            (ps.slack_energy <= ps.energy[:, :, None] * (1 + 1e-9)).all()),
        "slack scores <= scores": bool(
            (ps.slack_scores <= ps.scores * (1 + 1e-9)).all()),
        "feasible slack cells meet the deadline": bool(
            np.isfinite(ps.slack_latency[s_feas]).all()),
        "a slack winner wherever a latency-only one": bool(
            (ps.best_chip_slack[ps.best_chip >= 0] >= 0).all()),
        "tightest deadline has a winner": bool(
            ps.best_chip[0] >= 0 and pm.best_chip[0] >= 0),
        "loosest deadline admits every chip": bool(
            np.isfinite(ps.scores[:, -1]).all()
            and np.isfinite(pm.scores[:, -1]).all()),
        "resilience front holds best_nominal and best_robust": bool(
            rc.front[rc.best_nominal] and rc.front[rc.best_robust]
            and rd.front[rd.best_nominal]),
        "deadline schedules meet the deadline": all(
            sd.latency[nm] <= DEADLINE * p.min_latency[j]
            for j, nm in enumerate(nets)),
    }
    for pc in (ps, pm):
        for d in range(pc.deadlines.size):
            c = int(pc.best_chip[d])
            if c >= 0:
                lim = pc.deadlines[d] * (p.min_latency if pc is ps
                                         else pm_probs.min_latency)
                guard.setdefault("winners feasible and least", True)
                guard["winners feasible and least"] &= bool(
                    (pc.latency[c] <= lim).all()
                    and pc.scores[c, d] == pc.scores[:, d].min())
    n_s, w_s = rc.nominal_score, rc.worst_score
    for i in np.flatnonzero(rc.front):
        if ((n_s <= n_s[i]) & (w_s <= w_s[i])
                & ((n_s < n_s[i]) | (w_s < w_s[i]))).any():
            guard["resilience front non-dominated"] = False
    if not all(guard.values()):
        fail(f"guardrails: {guard}")
    saved = 100.0 * (1.0 - np.nanmean(np.where(
        np.isfinite(ps.slack_energy), ps.slack_energy
        / ps.energy[:, :, None], np.nan)))
    log(f"[2] guardrails hold: {sorted(guard)}; pareto slack: "
        f"{int(ps.slack_moves.sum())} moves, mean energy saved "
        f"{saved:.2f}%; deadline {DEADLINE} chip {sd.summary(ext)} "
        f"(score {sd.score:.6f}); resilience: best nominal chip "
        f"{rc.best_nominal} (worst overhead "
        f"{rc.worst_overhead[rc.best_nominal]:.3f}), best robust "
        f"{rc.best_robust}, front {int(rc.front.sum())} chips")

    # times: a wall and its split by phase synchronised at each mark
    # (median of 3; the slack calls once past DEADLINE_BUDGET_S), and one
    # traced call for the device's busy share
    def dl_call():
        q = hetero.codesign_problems(ext, nets, **CODESIGN_KW)
        return hetero.score_codesign(q, hetero._solve(q), m_cores=4,
                                     deadline=DEADLINE)

    timed = {
        "score_codesign(deadline=2.0) extended": (dl_call, True),
        "pareto_codesign(slack=True) extended": (
            lambda: hetero.pareto_codesign(
                hetero.codesign_problems(ext, nets, **CODESIGN_KW),
                n_deadlines=8, slack=True), True),
        "pareto_codesign streamed mega": (
            lambda: hetero.pareto_codesign(
                hetero.codesign_problems_streaming(mega, nets, **skw),
                n_deadlines=12), False),
        "resilience_codesign extended": (
            lambda: hetero.resilience_codesign(ext, nets, **rkw), False),
        "resilience_codesign(deadline=2.0) extended": (
            lambda: hetero.resilience_codesign(ext, nets, **rkw,
                                               deadline=DEADLINE), True),
    }
    spent = time.perf_counter() - t_phase
    first = {}
    for name, (call, _) in timed.items():
        split, marks = marked_split(call, 1)
        first[name] = (split, marks)
    est = time.perf_counter() - t_phase + 3 * sum(
        f[0]["total"] for f in first.values()) / 1e3
    slack_reps = 3 if est <= DEADLINE_BUDGET_S else 1
    log(f"[6] deadline phase at {spent:.1f} s before timing, "
        f"{time.perf_counter() - t_phase:.1f} s after one call each; "
        f"estimated {est:.1f} s with 3 more: slack calls timed "
        f"{slack_reps} time(s), the others 3")
    times = {}
    for name, (call, slack) in timed.items():
        reps = slack_reps if slack else 3
        split, marks = (first[name] if reps == 1
                        else marked_split(call, reps))
        prof = profile_ms(call, steps=1, warmup=False,
                          match=("count_terms_kernel",
                                 "count_layers_kernel"))
        times[name] = dict(
            wall_ms=split["total"], reps=reps, split_ms=split, marks=marks,
            traced_wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
            busy_share=prof["busy_share"],
            device_launches=prof["kernel_launches"],
            kernel_ms=prof["matched_ms"])
        how = "one timing" if reps == 1 else f"median of {reps}"
        log(f"[6] {name} x 18: wall {split['total']:.2f} ms ({how}, "
            f"synchronised at each mark); device busy "
            f"{prof['device_ms']:.3f} ms of a traced {prof['wall_ms']:.2f} "
            f"ms ({100 * prof['busy_share']:.3f}%), "
            f"{prof['kernel_launches']:.0f} device launches, kernels "
            f"{prof['matched_ms']} ({card})")
        log(f"[6] split of {name} (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" ({card})")
    log("deadline " + json.dumps({
        "card": card, "kw": CODESIGN_KW, "degradations": DEGRADATIONS,
        "deadline": DEADLINE, "chips": CODESIGN_CHIPS, "problems": n_b,
        "scenarios": S, "block": [n_b, S, 3, int(p.lat_dense.shape[2])],
        "pe_arrays": pe, "launches_per_call": per_call,
        "degraded_count_layers": deg_checks,
        "degraded_count_layers_time": deg_time, "slack_cells": n_slack,
        "resilience_cells": RESIL_CELLS, "guardrails": guard,
        "slack_moves": int(ps.slack_moves.sum()),
        "chip_deadline": sd.summary(ext), "score_deadline": sd.score,
        "best_nominal": rc.best_nominal, "best_robust": rc.best_robust,
        "phase_s": time.perf_counter() - t_phase, "times": times}))
    return {k: sum(c[k] for c in per_call.values()) for k in launches}


# ---------------------------------------------------------------------------
# 2. The DSE service: DSEService on the card at extended x 18
# ---------------------------------------------------------------------------

#: The launcher's seeded mix (``serve_dse.seeded_mix``): 12 requests, seed 0.
SERVICE_REQUESTS = 12
SERVICE_SEED = 0
#: The service's defaults: pool 4, <= 2 types, top-k 8, chunks of 1,024
#: (6 exact chunks of extended, 1 of its stride-8 subsample).
SERVICE_CHUNK = 1024
CHAOS_SEEDS = (0, 1, 2)
#: The process kill: the middle chunk of the exact stream of a second
#: metric, after the mix is answered; checkpoints spilled after every
#: chunk, so the restart replays the unanswered and resumes at chunk 3.
SERVICE_KILL_AT = 3
SERVICE_KILL_METRIC = "energy"


def service_path(dev, card) -> dict:
    """The fault-tolerant DSE service on the card at extended x 18 with
    its defaults (``SERVICE_CHUNK``, pool 4, <= 2 types, top-k 8): the
    launcher's seeded mix drained on the kernels with the launch counts
    set to 0 just before and read just after, then on the plain backend
    (equal answers: ints exact, floats within 1e-12) and against a direct
    ``stream_layer_topk`` with ``shard=True`` (every field bit for bit
    against the service's stream); three seeded chaos runs (every chunk
    shadow-checked, each perturbation caught, answers bit-identical to the
    clean run); a ``ProcessKill`` in a second metric's stream after the
    mix is answered, and two restarts over a state directory under
    ``build/`` (only the unanswered replayed, their answers bit-identical,
    the second restart replays nothing); two fault events, a core loss
    and a degraded PE array, rescheduled in one coalesced batch (one
    ``count_layers`` launch on the union grid) and held against the same
    events on the plain backend; the store's scrub, clean and then with
    one stream payload poisoned self-consistently.  Times the cold
    and warm queries, the reschedule, the chaos and restart drains and
    the verifier's cost a chunk, splits a cold drain by stage mark and
    traces one.  Prints the ``dse_service`` line → the launches of the
    clean drain and the reschedule."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import accelerator, energymodel as em, topology
    from repro_torch.ft import faults, hw_faults, verify
    from repro_torch.kernels.count_terms import ops
    from repro_torch.launch import serve_dse
    from repro_torch.serving import DSEService
    from repro_torch.serving.dse_service import answer_diffs

    t_phase = time.perf_counter()
    nets = {n: topology.get_network(n) for n in topology.NETWORKS}
    ext = accelerator.extended_grid()
    n_chunks = -(-ext.n // SERVICE_CHUNK)
    mix = serve_dse.seeded_mix(list(nets), SERVICE_REQUESTS, SERVICE_SEED)

    def make(backend="cuda", **kw):
        return DSEService(ext, nets, device=dev, backend=backend,
                          chunk_size=SERVICE_CHUNK, **kw)

    def drain(svc, queries=mix):
        for q in queries:
            if not svc.submit(**q).accepted:
                fail(f"service rejected {q}")
        t0 = time.perf_counter()
        out, drained = svc.run_until_drained()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if not drained:
            fail(f"service did not drain: {svc.health()}")
        return sorted(out, key=lambda r: r.rid), wall

    def check_same(label, got, want, rtol=0.0):
        """Two drains of the mix, in submission order: the same kinds and
        flags, answers bit for bit (``rtol=0``) or within ``rtol``."""
        diffs = []
        for g, w in zip(got, want):
            if (g.kind, g.ok, g.degraded) != (w.kind, w.ok, w.degraded):
                diffs.append(f"rid {g.rid}: kind, ok or degraded differ")
            else:
                diffs += answer_diffs(g.answer, w.answer, rtol,
                                      f"rid {g.rid}")
        if len(got) != len(want) or diffs:
            fail(f"{label}: {len(got)} vs {len(want)} answers; {diffs[:5]}")

    # cold single queries on fresh services (the kernels are built)
    walls = {}
    for kind, q in (("best_config", dict(kind="best_config")),
                    ("best_chip", dict(kind="best_chip", deadline=2.0))):
        (r,), walls[f"cold_{kind}_ms"] = drain(make(), [q])
        if not (r.ok and not r.degraded):
            fail(f"cold {kind}: ok={r.ok} degraded={r.degraded} "
                 f"{r.error}")

    # 1. the clean drain, as a user calls it: the card and the kernels
    svc = make()
    ops.reset_launch_counts()
    clean, walls["cold_drain_ms"] = drain(svc)
    launches = ops.launch_counts()
    h = svc.health()
    log(f"[2] service: {len(clean)} answers of the seeded mix in "
        f"{walls['cold_drain_ms']:.1f} ms on backend "
        f"{em.last_backend()}, launches {launches}")
    if not all(r.ok and not r.degraded for r in clean) or h["errors"] or \
            h["faults"] or h["backend_fallbacks"]:
        fail(f"clean drain: {[(r.rid, r.ok, r.error) for r in clean]}, "
             f"health {h}")
    # a launch a chunk of the exact and the subsampled stream, and one a
    # tier's candidate pool where the mix asks for chips
    chips = any(q["kind"] != "best_config" for q in mix)
    want_layers = n_chunks + 1 + (2 if chips else 0)
    if em.last_backend() != "cuda" or launches["count_terms"] != 0 or \
            launches["count_layers"] != want_layers:
        fail(f"clean drain launches {launches} on {em.last_backend()}, "
             f"expected count_layers {want_layers} and no count_terms")
    warm, walls["warm_drain_ms"] = drain(svc)
    check_same("warm answers against the cold ones", warm, clean)
    walls["warm_query_ms"] = walls["warm_drain_ms"] / len(warm)
    # a second metric's queries, answered by a stream of their own: the
    # clean answers of the kill and restart below
    extra = [dict(kind="best_config", metric=SERVICE_KILL_METRIC),
             dict(kind="best_chip", metric=SERVICE_KILL_METRIC,
                  network=next(iter(nets)), deadline=2.0)]
    extra_clean, _ = drain(svc, extra)

    plain, walls["plain_cold_drain_ms"] = drain(make("torch"))
    check_same("cuda against torch on the card", clean, plain, RTOL)
    # shard=True on the one card: the unsharded stream, every field bit
    # for bit against the stream the service (shard=False) folded
    direct = em.stream_layer_topk(ext, nets, device=dev, topk=8,
                                  bound=0.05, chunk_size=SERVICE_CHUNK,
                                  shard=True)
    shard = differing(direct, svc._streams[("exact", "edp")])
    if shard:
        fail(f"stream_layer_topk(shard=True) differs from the service's "
             f"stream in {shard}")
    cfg = next(r for r in clean if r.kind == "best_config")
    got = {nm: (a["idx"], a["metric"], a["energy"], a["latency"])
           for nm, a in cfg.answer.items()}
    want = {nm: (int(direct.argmin[j]), float(direct.min_metric[j]),
                 float(direct.min_energy[j]), float(direct.min_latency[j]))
            for j, nm in enumerate(nets)}
    if got != want:
        fail(f"best_config against a direct stream_layer_topk: {got} vs "
             f"{want}")
    log("[2] service: cuda = torch (ints exact, floats within 1e-12); "
        "a direct stream_layer_topk(shard=True) = the service's stream "
        "and its best_config, bit for bit")

    # 2. chaos: every chunk shadow-checked, seeded faults; the retry
    # budget of the reference's chaos tests, so a chunk that fails, then
    # is corrupted, then perturbed still converges
    chaos = {}
    for seed in CHAOS_SEEDS:
        csvc = make(verify_fraction=1.0, max_retries=30, backoff_s=1e-4)
        plan = faults.FaultPlan.random(seed, n_chunks, p_perturb=0.25)
        with faults.inject_chunk_faults(plan):
            out, wall = drain(csvc)
        ch = csvc.health()
        kinds = [k for _, k in plan.fired]
        n_pert = kinds.count("perturb")
        check_same(f"chaos seed {seed} against the clean run", out, clean)
        if ch["shadow_mismatches"] < n_pert or ch["errors"] or \
                ch["backend_fallbacks"]:
            fail(f"chaos seed {seed}: fired {plan.fired}, health {ch}")
        chaos[seed] = dict(wall_ms=wall, fired=plan.fired,
                           perturbations=n_pert,
                           **{k: ch[k] for k in (
                               "faults", "retries", "resumes",
                               "shadow_checks", "shadow_mismatches",
                               "invariant_checks", "invariant_violations",
                               "backend_fallbacks")})
        log(f"[2] service chaos seed {seed}: {wall:.1f} ms, fired "
            f"{plan.fired}; {chaos[seed]}")

    # 3. kill and restart over a state directory under build/
    sd = Path(__file__).resolve().parent / "build" / "service_state"
    shutil.rmtree(sd, ignore_errors=True)
    s1 = make(state_dir=sd, ckpt_every=1)
    for q in mix + extra:
        s1.submit(**q)
    for _ in range(len(mix)):
        if len(s1.responses) >= len(mix):
            break
        s1.step()
    if len(s1.responses) != len(mix):
        fail(f"the mix took more steps than requests: "
             f"{len(s1.responses)} answers")
    with faults.inject_chunk_faults(
            faults.FaultPlan(pkill_at=SERVICE_KILL_AT)) as plan:
        try:
            s1.run_until_drained()
            fail("the process kill did not propagate out of the service")
        except faults.ProcessKill:
            pass
    killed = list(s1.responses)
    t0 = time.perf_counter()
    s2 = make(state_dir=sd, ckpt_every=1)
    replayed = s2.stats["replayed"]
    out, wall = drain(s2, [])
    walls["restart_drain_ms"] = (time.perf_counter() - t0) * 1e3
    h2 = s2.health()
    s2.close()
    check_same("the restart's answers against the clean run",
               sorted(killed + out, key=lambda r: r.rid),
               clean + extra_clean)
    if replayed != len(extra) or len(out) != len(extra) or \
            h2["resumes"] < 1 or (SERVICE_KILL_AT, "pkill") not in plan.fired:
        fail(f"restart: replayed {replayed} after {len(killed)} answers, "
             f"health {h2}, fired {plan.fired}")
    s3 = make(state_dir=sd, ckpt_every=1)
    if s3.stats["replayed"]:
        fail(f"a second restart replayed {s3.stats['replayed']}")
    s3.close()
    restart = dict(killed_answers=len(killed), replayed=replayed,
                   resumes=h2["resumes"], ckpt_gc=h2["ckpt_gc"],
                   store=h2["store"])
    log(f"[2] service restart: killed at chunk {SERVICE_KILL_AT} of the "
        f"{SERVICE_KILL_METRIC} stream after {len(killed)} answers; "
        f"{replayed} replayed and drained in "
        f"{walls['restart_drain_ms']:.1f} ms, bit-identical; {restart}")

    # 4. two fault events on the first feasible best-chip answer, a core
    # loss and a seeded degraded PE array: one coalesced reschedule whose
    # union grid holds the degraded arrays, held against the same events
    # on the plain backend
    chip = next(r.answer for r in clean if r.kind == "best_chip"
                and r.answer.get("feasible"))
    ct, cc = chip["chip_types"], chip["chip_counts"]
    scens = (hw_faults.all_single_core_failures(cc)[:1]
             + hw_faults.random_degradations(SERVICE_SEED, ext, ct,
                                             n_scenarios=1))
    union_rows = sum(hw_faults.expand_scenarios(
        ext, ct, cc, [s], include_nominal=True).grid.n for s in scens)

    def reschedule(rsvc):
        for s in scens:
            if not rsvc.fault_event(ct, cc, s).accepted:
                fail(f"fault event {s.name} rejected")
        return drain(rsvc, [])

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    resched, _ = reschedule(svc)
    walls["reschedule_ms"] = (time.perf_counter() - t0) * 1e3
    r_launches = ops.launch_counts()
    if [(r.ok, r.kind, r.answer.get("scenario")) for r in resched] != \
            [(True, "reschedule", s.name) for s in scens] or \
            r_launches != {"count_terms": 0, "count_layers": 1}:
        fail(f"reschedule: {[(r.ok, r.error) for r in resched]}, launches "
             f"{r_launches}")
    plain_resched, _ = reschedule(make("torch"))
    check_same("the reschedule on cuda against torch", resched,
               plain_resched, RTOL)
    log(f"[2] service fault events {[s.name for s in scens]} on {ct} x "
        f"{cc}: one union grid of {union_rows} rows; feasible "
        f"{[r.answer['feasible'] for r in resched]}, counts after "
        f"{[r.answer['counts_after'] for r in resched]}, "
        f"{walls['reschedule_ms']:.1f} ms, launches {r_launches}; cuda = "
        f"torch (ints exact, floats within 1e-12)")
    h = svc.health()

    # 5. scrub: clean, then one stream payload poisoned self-consistently
    ss = make(state_dir=sd, scrub_rows=10 ** 6)
    clean_scrub = ss.scrub()
    key = ss._stream_key("exact", "edp")
    arrays, meta = ss.store.get(key)
    bad = {k: np.array(v, copy=True) for k, v in arrays.items()}
    k, j = 1, 0
    li = int(np.nonzero(bad["layer_energy"][k, j])[0][0])
    bad["layer_energy"][k, j, li] *= 1.001
    bad["topk_metric"][k, j] = (bad["layer_energy"][k, j].sum()
                                * bad["layer_latency"][k, j].sum())
    ss.store.put(key, arrays=bad, meta=meta)
    t0 = time.perf_counter()
    poison_scrub = ss.scrub()
    scrub_ms = (time.perf_counter() - t0) * 1e3
    reasons = [p.read_text().strip()
               for p in ss.store.quarantine.glob("*.reason")]
    again = ss.store.get(key)
    ss.close()
    if clean_scrub["bad"] or poison_scrub["bad"] != 1 or \
            poison_scrub["recomputed"] != 1 or len(reasons) != 1 or \
            "diverges" not in reasons[0] or again is None or \
            any(not np.array_equal(again[0][n], arrays[n]) for n in arrays):
        fail(f"scrub: clean {clean_scrub}, poisoned {poison_scrub}, "
             f"reasons {reasons}")
    log(f"[2] service scrub: clean pass {clean_scrub['scanned']} entries, "
        f"0 bad; the poisoned stream quarantined ({reasons[0][:90]}...) "
        f"and recomputed bit for bit in {scrub_ms:.1f} ms")

    # what the verifier costs a chunk on the card: the exact stream with
    # no verifier, with the invariants alone, and with every chunk
    # shadow-recomputed on the CPU (median of 3 each)
    def stream_with(v):
        return lambda: em.stream_layer_topk(
            ext, nets, device=dev, topk=8, bound=0.05,
            chunk_size=SERVICE_CHUNK,
            verify=None if v is None else verify.StreamVerifier(
                verify_fraction=v))
    v_ms = {name: wall_ms(stream_with(v), reps=3)
            for name, v in (("none", None), ("invariants", 0.0),
                            ("invariants_and_shadow", 1.0))}
    verify_cost = dict(
        stream_ms=v_ms,
        invariants_ms_a_chunk=(v_ms["invariants"] - v_ms["none"])
        / n_chunks,
        shadow_ms_a_chunk=(v_ms["invariants_and_shadow"]
                           - v_ms["invariants"]) / n_chunks)
    log(f"[6] the verifier at extended x 18, {n_chunks} chunks: stream "
        f"walls {v_ms}; invariants "
        f"{verify_cost['invariants_ms_a_chunk']:.2f} ms a chunk, the "
        f"shadow {verify_cost['shadow_ms_a_chunk']:.2f} ms a chunk "
        f"({card})")

    # times: a cold drain split by stage mark, and traced
    split, marks = marked_split(lambda: drain(make()), reps=1)
    prof = profile_ms(lambda: drain(make()), steps=1, warmup=False,
                      match=("count_layers_kernel",))
    phase_s = time.perf_counter() - t_phase
    log(f"[6] service cold drain: split (ms) " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; traced wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.3f} ms "
        f"({100 * prof['busy_share']:.3f}%), {prof['kernel_launches']:.0f} "
        f"device launches ({card})")
    log("dse_service " + json.dumps({
        "card": card, "grid": "extended_grid", "points": ext.n,
        "networks": len(nets), "requests": SERVICE_REQUESTS,
        "seed": SERVICE_SEED, "chunk": SERVICE_CHUNK, "chunks": n_chunks,
        "walls_ms": walls, "p50_s": h["p50_s"], "p99_s": h["p99_s"],
        "n_lat": h["n_lat"], "launches_clean_drain": launches,
        "launches_reschedule": r_launches,
        "reschedule": dict(scenarios=[s.name for s in scens],
                           union_rows=union_rows), "chaos": chaos,
        "restart": restart, "scrub": dict(clean=clean_scrub["scanned"],
                                          quarantined=poison_scrub["bad"],
                                          ms=scrub_ms),
        "shard": "stream_layer_topk(shard=True) = the service's stream",
        "verify_cost": verify_cost, "split_ms": split,
        "marks": marks,
        "busy_share": prof["busy_share"], "device_ms": prof["device_ms"],
        "traced_wall_ms": prof["wall_ms"],
        "device_launches": prof["kernel_launches"],
        "count_layers_ms": prof["matched_ms"]["count_layers_kernel"],
        "phase_s": phase_s}, default=str))
    return {k: launches[k] + r_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# 3-5. LM path: flash attention and RMSNorm, the serve run, the forward
# ---------------------------------------------------------------------------

def _rand(shape, gen, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _flash_operands(case, dtype, gen, dev, cache_len=0):
    """q, k, v of a case; with ``cache_len`` k and v are the prefix views
    ``cache[:, :s]`` of [b, cache_len, kv, d] buffers, the strided layout
    the decode step hands the kernel."""
    b, t, s, h, kv, d = case[:6]
    rows = cache_len or s
    return (_rand((b, t, h, d), gen, dtype, dev),
            _rand((b, rows, kv, d), gen, dtype, dev)[:, :s],
            _rand((b, rows, kv, d), gen, dtype, dev)[:, :s])


def lm_kernel_checks(dev) -> dict:
    """Each LM kernel against its plain version on the card → max errors."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"flash_attention": 0.0, "rmsnorm": 0.0}
    kps = fa.KEYS_PER_SPLIT
    flash_cases = [
        # (b, t, s, h, kv, d, causal, window, q_offset, cache_len, label);
        # cache_len > 0: k, v are prefix views of a [b, cache_len, kv, d]
        # cache, as the decode step passes them
        (4, 1, 1, 14, 2, 64, False, 0, 0, 0, "decode S=1"),
        (4, 1, 129, 14, 2, 64, False, 0, 128, 0, "decode S=129"),
        (4, 1, 1024, 14, 2, 64, False, 0, 1023, 0, "decode S=1024"),
        (4, 1, 405, 14, 2, 64, False, 0, 404, MAX_SEQ,
         f"decode S=405 of a {MAX_SEQ}-row cache view"),
        (4, 1, 1024, 14, 2, 64, False, 16, 1023, 0, "decode S=1024 w=16"),
        (4, 1, kps + 1, 14, 2, 64, False, 0, kps, 0,
         f"decode S={kps + 1} (a last split of one key)"),
        (4, 8, 508, 14, 2, 64, True, 0, 500, MAX_SEQ,
         f"T=8 causal at offset 500 of a {MAX_SEQ}-row cache view"),
        (4, 1, 1024, 16, 2, 128, False, 0, 1023, 2 * MAX_SEQ,
         f"D=128 decode S=1024 of a {2 * MAX_SEQ}-row cache view"),
        (4, 8, 508, 16, 2, 128, True, 0, 500, MAX_SEQ,
         f"D=128 T=8 causal at offset 500 of a {MAX_SEQ}-row cache view"),
        (4, 1, kps + 1, 14, 2, 128, False, 16, kps, 0,
         f"D=128 decode S={kps + 1} w=16 (a last split of one key)"),
        (2, 2048, 2048, 14, 2, 64, True, 0, 0, 0, "prefill T=2048 causal"),
        (2, 512, 512, 14, 2, 64, True, 96, 0, 0, "window T=512 w=96"),
        (2, 512, 512, 16, 2, 128, True, 0, 0, 0, "D=128 GQA T=512 causal"),
        (2, 1000, 1000, 14, 2, 64, True, 0, 0, 0, "ragged T=1000 causal"),
        (2, 64, 1024, 14, 2, 64, True, 0, 960, 2048,
         "T=64 at offset 960 of a 2048-row cache view"),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        tol = LM_TOL[str(dtype).split(".")[1]]
        for case in flash_cases:
            causal, window, q_off, cache_len, label = case[6:]
            q, k, v = _flash_operands(case, dtype, gen, dev, cache_len)
            fa.reset_route_counts()
            run = lambda: fa.flash_attention(                 # noqa: E731
                q, k, v, causal=causal, window=window, q_offset=q_off)
            out = run()
            torch.cuda.synchronize()
            route = [r for r, n in fa.route_counts().items() if n]
            want = fa_ref.attention_ref(q, k, v, causal=causal,
                                        window=window, q_offset=q_off)
            diff = (out.float() - want.float()).abs()
            rel = diff / want.float().abs().clamp_min(1.0)
            err = float(diff.max())
            log(f"[3] flash_attention {label} {dtype}: route {route}, max "
                f"abs err {err:.3e} (tolerance rtol=atol={tol})")
            if not bool(torch.isfinite(out).all()) or float(
                    (diff - tol * want.float().abs()).max()) > tol:
                fail(f"flash_attention {label} {dtype} disagrees with its "
                     f"plain version: max abs {err}, max rel {float(rel.max())}")
            if route != [fa._route(dtype, case[1], case[5])]:
                fail(f"flash_attention {label} {dtype} took route {route}")
            if not torch.equal(out, run()):
                fail(f"flash_attention {label} {dtype} gives other bits on a "
                     f"second run")
            errs["flash_attention"] = max(errs["flash_attention"], err)
    errs["rmsnorm"] = rmsnorm_checks("3", RMSNORM_CASES, dev,
                                     every_instance=True)
    return errs


def rmsnorm_checks(tag, cases, dev, every_instance=False) -> float:
    """RMSNorm against its plain version on the card at ``cases`` of
    (shape, storage offset of x in elements), f32 and bf16, with the plan
    each took and the same bits on a second run → max abs error.  With
    ``every_instance`` each of the kernel's 8 instances (dtype, route,
    vector width) must have run."""
    import torch
    from repro_torch.kernels.rmsnorm import ops as rms, ref as rms_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    worst, ran = 0.0, set()
    for dtype in (torch.float32, torch.bfloat16):
        tol = LM_TOL[str(dtype).split(".")[1]]
        for shape, offset in cases:
            x = _rand(shape, gen, dtype, dev)
            if offset:
                x = torch.empty(x.numel() + offset, dtype=dtype, device=dev)[
                    offset:].view(shape).copy_(x)
            sc = torch.randn(shape[-1], generator=gen, device=dev)
            out = rms.rmsnorm(x, sc)
            torch.cuda.synchronize()
            plan = rms._plan(dtype, shape[-1], x.data_ptr() % 16 == 0)
            ran.add((dtype, plan.route, plan.vec))
            want = rms_ref.rmsnorm_ref(x, sc)
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            at = f" at offset {offset}" if offset else ""
            log(f"[{tag}] rmsnorm {list(shape)}{at} {dtype}: {plan.route} "
                f"route, {plan.vec} elements an access, {plan.threads} "
                f"threads a block; max abs err {err:.3e} (tolerance "
                f"rtol=atol={tol})")
            if not bool(torch.isfinite(out).all()) or float(
                    (diff - tol * want.float().abs()).max()) > tol:
                fail(f"rmsnorm {list(shape)} {dtype} disagrees with its "
                     f"plain version: max abs {err}")
            if not torch.equal(out, rms.rmsnorm(x, sc)):
                fail("rmsnorm gives other bits on a second run")
            worst = max(worst, err)
    if every_instance and len(ran) != 8:
        fail(f"rmsnorm ran {len(ran)} of its 8 instances: "
             f"{sorted(map(str, ran))}")
    return worst


def _requests(cfg):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    out = []
    for rid in range(N_REQUESTS):
        n = int(rng.integers(*PROMPT_LEN))
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt,
                           max_new_tokens=NEW_TOKENS))
    return out


def serve_run(cfg, model, dev, backend):
    """Serve the request set; record every decode call's inputs and
    logits → (engine, drain result, wall s, [(tokens, logits), ...])."""
    import torch
    from repro_torch.serving import ServeEngine

    engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_seq=MAX_SEQ,
                         device=dev, backend=backend)
    calls = []
    decode = engine._decode

    def recording(tokens):
        logits = decode(tokens)
        calls.append((tokens.copy(), logits))
        return logits

    engine._decode = recording
    for req in _requests(cfg):
        engine.submit(req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    return engine, done, time.perf_counter() - t0, calls


def logit_tol(want):
    """bf16 tolerance of one step's logits: 2e-2 of the step's largest
    logit plus 2e-2 of each logit (a bf16 ulp at the top is 2^-8 of it)."""
    return 2e-2 * want.abs().amax() + 2e-2 * want.abs()


def _rmsnorm_f64(x, scale, eps):
    """The plain RMSNorm with its mean of squares in float64: as right as
    the float32 one, and apart from it only by rounding."""
    import torch
    xd = x.double()
    return (xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
            * scale.double()).to(x.dtype)


@contextlib.contextmanager
def rounding_twin():
    """Within: the plain versions' RMSNorm is :func:`_rmsnorm_f64`."""
    from repro_torch.models import layers
    plain = layers._RMSNORM["torch"]
    layers._RMSNORM["torch"] = _rmsnorm_f64
    try:
        yield
    finally:
        layers._RMSNORM["torch"] = plain


def drift(got, want) -> float:
    """max |got - want| / max |want| over a step's (or a row's) logits."""
    return float(((got.float() - want.float()).abs()
                  / want.float().abs().amax(-1, keepdim=True)).max())


def _lm_kernel_ops():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssd import ops as ssd
    return fa, rms, ssd


def reset_lm_counts() -> None:
    for mod in _lm_kernel_ops():
        mod.reset_launch_counts()
        mod.reset_backward_launch_counts()
    fa = _lm_kernel_ops()[0]
    fa.reset_route_counts()
    fa.reset_backward_route_counts()


def flash_routes() -> dict:
    """Flash-attention launches by route since :func:`reset_lm_counts`."""
    return _lm_kernel_ops()[0].route_counts()


def lm_counts() -> dict:
    out = {}
    for mod in _lm_kernel_ops():
        out.update(mod.launch_counts())
    for mod in _lm_kernel_ops():
        out.update(mod.backward_launch_counts())
    return out


def describe(model) -> tuple:
    """(parameter count, parameter bytes)."""
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    return n_params, param_bytes


def _replay(cfg, model, dev, calls, backend="torch"):
    """Each decode call's logits when the recorded inputs run again from
    an empty cache on ``backend``."""
    import torch
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P

    cache = P.init_tree(Z.cache_spec(cfg, SLOTS, MAX_SEQ), device=dev)
    for tokens, _ in calls:
        want, cache = Z.decode_step(model, cfg,
                                    torch.from_numpy(tokens).to(dev), cache,
                                    backend=backend)
        yield want[:, -1].float()


def serve_check(tag, cfg, model, dev, card, per_call, floor=False) -> dict:
    """Serve the request set on the kernels, with the counts set to 0 just
    before and read just after (they must be ``per_call`` times the decode
    calls), then on the plain versions; replay the kernel run's inputs
    through the plain decode step and hold every step's logits to bf16
    tolerance (``logit_tol``) → the run's numbers, its engine and its last
    decode input.

    With ``floor``, the tolerance is the larger of ``logit_tol`` and twice
    the rounding floor: the largest drift, over the run, between the plain
    replay and a second plain replay that differs from it only in rounding
    (:func:`rounding_twin`).  A deep bf16 model turns one flipped rounding
    into logit changes above ``logit_tol`` (mamba2-2.7b: PERF.md)."""
    import torch

    reset_lm_counts()
    eng_k, done_k, wall_k, calls_k = serve_run(cfg, model, dev, "cuda")
    launches = lm_counts()
    routes = flash_routes()
    n_calls = len(calls_k)
    toks_k = {r.rid: r.out_tokens for r in done_k}
    n_tok = sum(len(t) for t in toks_k.values())
    length = eng_k.cache["length"]
    log(f"[{tag}] serve {cfg.name} on the kernels: {len(done_k)} requests, "
        f"{n_tok} tokens, {n_calls} decode calls, drained {done_k.drained}, "
        f"shared length {length}; wall {wall_k:.3f} s "
        f"({n_tok / wall_k:.2f} tok/s); launches {launches} ({card})")
    if not done_k.drained or len(done_k) != N_REQUESTS:
        fail(f"the kernel serve run of {cfg.name} did not drain")
    if length >= MAX_SEQ:
        fail(f"shared length {length} reached max_seq {MAX_SEQ}")
    want_counts = {k: per_call.get(k, 0) * n_calls for k in launches}
    if launches != want_counts:
        fail(f"launch counts {launches} are not {per_call} per decode call "
             f"x {n_calls}")

    eng_p, done_p, wall_p, calls_p = serve_run(cfg, model, dev, "torch")
    toks_p = {r.rid: r.out_tokens for r in done_p}
    log(f"[{tag}] serve {cfg.name} on the plain versions: drained "
        f"{done_p.drained}, {len(calls_p)} decode calls, wall {wall_p:.3f} s "
        f"({sum(len(t) for t in toks_p.values()) / wall_p:.2f} tok/s) "
        f"({card})")
    if not done_p.drained or len(done_p) != N_REQUESTS:
        fail(f"the plain serve run of {cfg.name} did not drain")
    del calls_p, eng_p

    plain = list(_replay(cfg, model, dev, calls_k))
    rounding, twin_same = 0.0, 0
    if floor:
        with rounding_twin():
            for t, w in zip(_replay(cfg, model, dev, calls_k), plain):
                rounding = max(rounding, drift(t, w))
                twin_same += int((t.argmax(-1) == w.argmax(-1)).sum())
    worst, compared, near_ties, over, same_tok = 0.0, 0, 0, 0, 0
    for (_, logits), want in zip(calls_k, plain):
        got = logits[:, -1].float()
        same_tok += int((got.argmax(-1) == want.argmax(-1)).sum())
        bf16_tol = logit_tol(want)
        tol = torch.maximum(bf16_tol, 2 * rounding * want.abs().amax(
            -1, keepdim=True))
        excess = float(((got - want).abs() - tol).max())
        worst = max(worst, drift(got, want))
        over += int(((got - want).abs() > bf16_tol).any())
        if excess > 0:
            fail(f"{cfg.name} decode logits of the kernels and the plain "
                 f"versions differ beyond tolerance by {excess}")
        top2 = want.topk(2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        sure = gap > 2 * tol.gather(1, top2.indices[:, :1])[:, 0]
        near_ties += int((~sure).sum())
        compared += int(sure.sum())
        if bool((got.argmax(-1) != top2.indices[:, 0])[sure].any()):
            fail(f"a {cfg.name} kernel decode step picked another token "
                 f"where the plain version's top-2 gap exceeds twice the "
                 f"tolerance")
    same = sum(toks_k[r] == toks_p[r] for r in toks_k)
    slot_steps = n_calls * SLOTS
    floor_note = (f"; rounding floor (plain vs its float64-norm twin) "
                  f"{rounding:.3e}, tolerance max(2e-2, 2 x floor); steps "
                  f"beyond 2e-2: {over}; argmax = the plain version's at "
                  f"{same_tok} of {slot_steps} slot-steps on the kernels, "
                  f"{twin_same} on the twin" if floor
                  else " (tolerance 2e-2)")
    log(f"[{tag}] {n_calls} decode steps replayed through the plain "
        f"versions: max |logit diff| / max |logit| {worst:.3e}{floor_note}; "
        f"argmax equal at all {compared} slot-steps with a clear top-2 gap "
        f"({near_ties} near ties); served tokens equal for {same} of "
        f"{len(toks_k)} requests")
    if same != len(toks_k) and near_ties == 0:
        fail(f"the two {cfg.name} serve runs served other tokens without a "
             f"near tie")
    if floor and same_tok < twin_same - 0.1 * slot_steps:
        fail(f"the kernels pick the plain version's token at {same_tok} of "
             f"{slot_steps} slot-steps, the rounding twin at {twin_same}")
    last = torch.from_numpy(calls_k[-1][0]).to(dev)
    stats = dict(requests=N_REQUESTS, slots=SLOTS, new_tokens=NEW_TOKENS,
                 max_seq=MAX_SEQ, tokens=n_tok, decode_calls=n_calls,
                 length=length, wall_s_kernels=wall_k, wall_s_plain=wall_p,
                 tok_per_s_kernels=n_tok / wall_k,
                 tok_per_s_plain=n_tok / wall_p, launches=launches,
                 flash_routes=routes,
                 max_rel_logit_diff=worst, near_ties=near_ties,
                 tokens_equal=same)
    if floor:
        stats.update(rounding_floor=rounding, steps_beyond_2e_2=over,
                     argmax_same_kernels=same_tok, argmax_same_twin=twin_same)
    return stats, eng_k, last


def decode_times(tag, cfg, model, engine, last, card, param_bytes) -> tuple:
    """A decode step's CUDA-event time on both backends at the serve run's
    end state, and a trace of 5 steps on the kernels."""
    from repro_torch.models import model_zoo as Z

    state = dict(engine.cache)
    step_ms = {b: cuda_ms(lambda: Z.decode_step(model, cfg, last,
                                                dict(state), backend=b))
               for b in ("cuda", "torch")}
    log(f"[{tag}] {cfg.name} decode step at length {state['length']}: "
        f"kernels {step_ms['cuda']:.3f} ms, plain {step_ms['torch']:.3f} ms; "
        f"weight-read bound {param_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({card})")
    prof = profile_ms(lambda: Z.decode_step(model, cfg, last, dict(state),
                                            backend="cuda"), steps=5)
    return step_ms, prof


def forward_check(tag, cfg, model, dev, card, batch, want_counts,
                  floor=False, match=()) -> tuple:
    """The prefill forward on the kernels (no backend: the default on the
    card), counts set to 0 just before and read just after, against the
    plain versions (tolerance as in :func:`serve_check`, ``floor`` from
    the forward's own rounding twin); then both timed, and the kernels
    traced."""
    import torch
    from repro_torch.models import model_zoo as Z

    with torch.no_grad():
        b, t = batch["tokens"].shape
        reset_lm_counts()
        logits_k = Z.forward(model, cfg, batch)   # on the card: the kernels
        torch.cuda.synchronize()
        launches = lm_counts()
        routes = flash_routes()
        logits_p = Z.forward(model, cfg, batch, backend="torch")
        rounding = 0.0
        if floor:
            with rounding_twin():
                twin = Z.forward(model, cfg, batch, backend="torch")
            rounding = max(float((twin[i].float() - logits_p[i].float())
                                 .abs().max()
                                 / logits_p[i].float().abs().max())
                           for i in range(b))
            del twin
        err, excess = 0.0, -1.0
        for i in range(b):
            got, want = logits_k[i].float(), logits_p[i].float()
            tol = torch.maximum(logit_tol(want),
                                2 * rounding * want.abs().amax())
            excess = max(excess, float(((got - want).abs() - tol).max()))
            err = max(err, float(((got - want).abs()
                                  / want.abs().amax()).max()))
        finite = bool(torch.isfinite(logits_k).all())
        floor_note = (f"; rounding floor {rounding:.3e}, tolerance max(2e-2, "
                      f"2 x floor)" if floor else " (tolerance 2e-2)")
        log(f"[{tag}] {cfg.name} forward B {b} T {t}: logits "
            f"{tuple(logits_k.shape)} finite {finite}, max |diff| / max "
            f"|logit| {err:.3e}{floor_note}, launches {launches}, flash "
            f"routes {routes}")
        if (not finite or excess > 0
                or tuple(logits_k.shape) != (b, t, cfg.vocab)):
            fail(f"the {cfg.name} forward on the kernels disagrees with the "
                 f"plain versions")
        if launches != {k: want_counts.get(k, 0) for k in launches}:
            fail(f"{cfg.name} forward launch counts {launches}, expected "
                 f"{want_counts}")
        del logits_k, logits_p
        torch.cuda.empty_cache()
        fwd_ms = {bk: cuda_ms(lambda: Z.forward(model, cfg, batch, backend=bk),
                              warmup=1) for bk in ("cuda", "torch")}
        log(f"[{tag}] {cfg.name} forward B {b} T {t}: kernels "
            f"{fwd_ms['cuda']:.2f} ms, plain {fwd_ms['torch']:.2f} ms "
            f"({card})")
        prof = profile_ms(lambda: Z.forward(model, cfg, batch, backend="cuda"),
                          steps=2, match=match)
        out = dict(batch=b, seq=t, ms=fwd_ms, launches=launches,
                   flash_routes=routes, max_rel_logit_diff=err)
        if floor:
            out["rounding_floor"] = rounding
        return out, prof


def log_profiles(tag, name, prof, card) -> None:
    for what, r in prof.items():
        log(f"[{tag}] profile of the {name} {what} on the kernels: wall "
            f"{r['wall_ms']:.3f} ms, device busy {r['device_ms']:.3f} ms "
            f"({100 * r['busy_share']:.1f}%), {r['kernel_launches']:.0f} "
            f"kernel launches per call ({card})")
        for k, ms, n in r["top_device"]:
            log(f"      device {ms:9.4f} ms x{n:<5d} {k}")
        for k, ms, n in r["top_host"]:
            log(f"      host   {ms:9.4f} ms x{n:<5d} {k}")


def rmsnorm_times(rows, d, dev) -> dict:
    """RMSNorm kernel, plain version and ``F.rms_norm`` at [rows, d] bf16,
    with the bound.  Beside the CUDA-event times, as in
    :func:`flash_times`: the traced device time and device launches of a
    call (:func:`traced_call`), the host µs of a call (:func:`host_us`)
    and the profiler's CPU self time of a call, for the kernel and the
    library."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms, ref as rms_ref

    g = torch.Generator(device=dev).manual_seed(3)
    x = _rand((rows, d), g, torch.bfloat16, dev)
    scale = torch.ones(d, device=dev)
    sb = scale.to(torch.bfloat16)
    kern = lambda: rms.rmsnorm(x, scale)                      # noqa: E731
    lib = lambda: F.rms_norm(x, (d,), sb, 1e-6)               # noqa: E731
    n_bytes = 2 * rows * d * 2 + 4 * d
    b_ms, b_by = bound(n_bytes, 4 * rows * d, FP32_FLOPS)
    prof_k, prof_l = traced_call(kern), traced_call(lib)
    (enq_k, end_k), (enq_l, end_l) = host_us(kern), host_us(lib)
    return dict(
        shape=[rows, d], ms=cuda_ms(kern),
        plain_ms=cuda_ms(lambda: rms_ref.rmsnorm_ref(x, scale)),
        library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes, device_ms=prof_k["device_ms"],
        library_device_ms=prof_l["device_ms"],
        device_launches=prof_k["kernel_launches"],
        library_device_launches=prof_l["kernel_launches"],
        host_us=enq_k, host_end_us=end_k, library_host_us=enq_l,
        library_host_end_us=end_l,
        host_self_us=prof_k["host_self_ms"] * 1e3,
        library_host_self_us=prof_l["host_self_ms"] * 1e3)


def log_times(tag, times, card) -> None:
    for name, r in times.items():
        lib = r["library_ms"]
        dev = (f" (on the device: kernel {r['device_ms']:.4f} ms, library "
               f"{r['library_device_ms']:.4f} ms)"
               if "library_device_ms" in r else "")
        log(f"[{tag}] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}){dev} ({card})")
        if "host_us" in r:
            log(f"      host µs a call (enqueue / to the device's end over "
                f"1,000 calls; profiler CPU self): kernel {r['host_us']:.2f}"
                f" / {r['host_end_us']:.2f}; {r['host_self_us']:.2f}, "
                f"library {r['library_host_us']:.2f} / "
                f"{r['library_host_end_us']:.2f}; "
                f"{r['library_host_self_us']:.2f}; device launches a call: "
                f"kernel {r['device_launches']:.0f}, library "
                f"{r['library_device_launches']:.0f}")


def flash_times(case, dev) -> dict:
    """Flash kernel, plain version and ``scaled_dot_product_attention``
    at (b, t, s, h, kv, d, causal) in bf16, with the bound: the larger of
    q, k, v and o over the HBM rate and 4·d operations per visible (row,
    key) pair over the bf16 tensor-core peak.  Beside the CUDA-event
    times: the traced device time and device launches of a call, the
    host µs of a call (:func:`host_us`) and the profiler's CPU self time
    of a call, for the kernel and for SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref

    b, t, s, h, kvh, d, causal = case
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = _flash_operands(case, torch.bfloat16, g, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(               # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    pairs = b * h * (t * (t + 1) // 2 if causal else t * s)
    n_bytes = 2 * (2 * b * t * h * d + 2 * b * s * kvh * d)
    b_ms, b_by = bound(n_bytes, 4 * d * pairs, BF16_FLOPS)
    # cuda_ms holds the host's launch work wherever the card waits on it;
    # the traced device time of a call does not
    prof_k, prof_l = profile_ms(kern, steps=10), profile_ms(lib, steps=10)
    (enq_k, end_k), (enq_l, end_l) = host_us(kern), host_us(lib)
    return dict(
        shape=[b, t, s, h, kvh, d], causal=causal,
        route=fa._route(torch.bfloat16, t, d),
        ms=cuda_ms(kern),
        plain_ms=cuda_ms(lambda: fa_ref.attention_ref(q, k, v,
                                                      causal=causal)),
        library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes, ops=4 * d * pairs,
        device_ms=prof_k["device_ms"],
        library_device_ms=prof_l["device_ms"],
        device_launches=prof_k["kernel_launches"],
        library_device_launches=prof_l["kernel_launches"],
        host_us=enq_k, host_end_us=end_k, library_host_us=enq_l,
        library_host_end_us=end_l,
        host_self_us=prof_k["host_self_ms"] * 1e3,
        library_host_self_us=prof_l["host_self_ms"] * 1e3)


def lm_path(dev, card, built) -> tuple:
    """qwen2-0.5b: phases 3-6 → (kernel rows, launches per kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z

    errs = lm_kernel_checks(dev)
    flash_build = flash_build_report(built)
    rms_build = rmsnorm_build_report(built)

    # ---- 4. serve at full width ------------------------------------------
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Z.init(cfg, gen, dev)
    n_params, param_bytes = describe(model)
    log(f"[4] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params} parameters, {param_bytes / 1e9:.3f} GB "
        f"(bf16 weights, f32 norm scales)")
    serve, eng_k, last = serve_check(
        "4", cfg, model, dev, card,
        {"flash_attention": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1})
    n_flash = serve["launches"]["flash_attention"]
    if serve["flash_routes"] != {"fma": 0, "mma": 0, "split": n_flash}:
        fail(f"the serve run's {n_flash} flash calls took the routes "
             f"{serve['flash_routes']}, not all the split route")
    step_ms, prof_decode = decode_times("6", cfg, model, eng_k, last, card,
                                        param_bytes)
    serve["decode_step_ms"] = step_ms
    length = serve["length"]
    del eng_k
    torch.cuda.empty_cache()

    # ---- 5. prefill forward at full width ----------------------------------
    batch = Z.make_batch(cfg, seq_len=PREFILL_T, global_batch=PREFILL_B,
                         generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    fwd, prof_fwd = forward_check(
        "5", cfg, model, dev, card, batch,
        {"flash_attention": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1},
        match=("flash",))
    if fwd["flash_routes"] != {"fma": 0, "mma": cfg.n_layers, "split": 0}:
        fail(f"the forward's flash calls took the routes "
             f"{fwd['flash_routes']}, not all the tensor-core route")
    flash_dev = prof_fwd["matched_ms"]["flash"]
    fwd["flash_device_ms"] = flash_dev
    log(f"[6] flash attention takes {flash_dev:.3f} ms of the traced "
        f"{cfg.name} forward's {prof_fwd['device_ms']:.3f} ms of device time "
        f"({100 * flash_dev / prof_fwd['device_ms']:.1f}%), "
        f"{prof_fwd['matched_per_launch_ms']['flash']:.4f} ms a launch "
        f"({card})")
    log_profiles("6", cfg.name, {"decode": prof_decode, "forward": prof_fwd},
                 card)

    # ---- 6. kernel times ----------------------------------------------------
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    times = {
        "flash_attention decode": flash_times(
            (SLOTS, 1, length, h, kvh, d, False), dev),
        "flash_attention decode S=1024": flash_times(
            (SLOTS, 1, MAX_SEQ, h, kvh, d, False), dev),
        "flash_attention prefill": flash_times(
            (PREFILL_B, PREFILL_T, PREFILL_T, h, kvh, d, True), dev),
        # D 128 at the same length (16 query heads over 2 kv heads)
        "flash_attention prefill D=128": flash_times(
            (PREFILL_B, PREFILL_T, PREFILL_T, 16, 2, 128, True), dev)}
    times["rmsnorm decode"] = rmsnorm_times(SLOTS, cfg.d_model, dev)
    times["rmsnorm prefill"] = rmsnorm_times(PREFILL_B * PREFILL_T,
                                             cfg.d_model, dev)
    log_times("6", times, card)

    log("lm " + json.dumps({
        "card": card, "model": cfg.name, "params": n_params,
        "param_bytes": param_bytes, "serve": serve, "forward": fwd,
        "profile": {"decode": prof_decode, "forward": prof_fwd},
        "kernels": times, "max_abs_err": errs, "flash_build": flash_build,
        "rmsnorm_build": rms_build}))

    rows = []
    for name in ("flash_attention", "rmsnorm"):
        r = times[f"{name} decode"]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=0,
            max_abs_err=errs[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            shape=f"qwen2-0.5b serve decode {r['shape']} bf16"))
    # the flash row's decode host times and device launches, and the times
    # at S 1,024 and at prefill (the tensor-core route), beside decode's
    host_keys = ("host_us", "library_host_us", "host_self_us",
                 "library_host_self_us", "device_launches",
                 "library_device_launches")
    for row in rows:
        row.update({k: times[f"{row['name']} decode"][k]
                    for k in host_keys + ("device_ms",
                                          "library_device_ms")})
    for label, key in (("decode_s1024", "flash_attention decode S=1024"),
                       ("prefill", "flash_attention prefill"),
                       ("prefill_d128", "flash_attention prefill D=128")):
        r = times[key]
        rows[0][label] = {k: r[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms")}
        if label == "decode_s1024":
            rows[0][label].update({k: r[k] for k in host_keys})
    launches = {k: serve["launches"][k] + fwd["launches"][k]
                for k in serve["launches"]}
    return rows, launches


# ---------------------------------------------------------------------------
# 7. mamba2-2.7b: the SSD scan, the recurrent serve path, the forward
# ---------------------------------------------------------------------------

def ssd_ops_count(b, t, h, p, g, n, chunk) -> float:
    """Operations the SSD scan needs for these shapes: per chunk of q
    steps the lower triangle of C Bᵀ once per group, of its decay and of
    its product with dt·x once per head, the inter-chunk output and the
    state carried to the next chunk (none after the last)."""
    q_list = [min(chunk, t - s) for s in range(0, t, chunk)]
    ops = 0.0
    for i, q in enumerate(q_list):
        tri = q * (q + 1) // 2
        ops += b * g * tri * 2 * n                        # C Bᵀ
        ops += b * h * (tri * (1 + 2 * p) + q * p)        # decay, L·(dt x)
        ops += b * h * 2 * q * n * p                      # C · S_prev
        if i + 1 < len(q_list):
            ops += b * h * (2 * q * n * p + n * p)        # carry
    return ops


def _ssd_operands(case, dtype, gen, dev):
    """x, dt, A, b, c for (b, t, h, p, g, n): x, b and c as column slices
    of one [b, t, h·p + 2·g·n] buffer, as the model's conv output holds
    them; dt in Mamba-2's initial range [0.001, 0.1] and A = -exp(N(0,
    0.5²)), so the state carried across chunks matters."""
    import torch
    b, t, h, p, g, n = case
    buf = (torch.randn((b, t, h * p + 2 * g * n), generator=gen, device=dev)
           * 0.5).to(dtype)
    x = buf[..., :h * p].reshape(b, t, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(b, t, g, n)
    cm = buf[..., h * p + g * n:].reshape(b, t, g, n)
    dt = torch.rand((b, t, h), generator=gen, device=dev) * 0.099 + 0.001
    a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.5)
    return x, dt, a, bm, cm


def _held(label, got, want, tol) -> float:
    """max |got - want|; fails unless finite and within rtol = atol = tol."""
    import torch
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()) or float(
            (diff - tol * want.float().abs()).max()) > tol:
        fail(f"ssd {label} disagrees with its plain version: max abs "
             f"{float(diff.max())}")
    return float(diff.max())


def _same_bits(label, run) -> None:
    import torch
    if not torch.equal(run(), run()):
        fail(f"ssd {label} gives other bits on a second run")


def ssd_pass_checks(x, dt, a, bm, cm, tol) -> dict:
    """Each pass of the SSD kernel against its plain pass on the same
    inputs (the plain passes' outputs feed the next kernel pass), and the
    same bits on a second run → {pass: max abs error}.  cum and dt by
    chunk are float32 whatever x is and are held to f32's tolerance."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref

    q = 256
    cum, st = ssd_ref._chunk_state_ref(x, dt, a, bm, chunk=q)
    dtc = ssd_ref._dt_chunks(dt, q)
    cum_k, dtc_k, st_k = ssd._chunk_state(x, dt, a, bm, chunk=q)
    errs = {"cum": _held("chunk_state cum", cum_k, cum, SSD_TOL["float32"]),
            "dt": _held("chunk_state dt", dtc_k, dtc, SSD_TOL["float32"]),
            "chunk_state": _held("chunk_state S_c", st_k, st, tol)}
    del cum_k, dtc_k, st_k
    _same_bits("chunk_state", lambda: ssd._chunk_state(x, dt, a, bm,
                                                       chunk=q)[2])
    cb = ssd_ref._cb_ref(bm, cm, chunk=q)
    keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    run = lambda: ssd._cb(bm, cm, chunk=q).masked_fill(~keep, 0)  # noqa: E731
    errs["cb"] = _held("C B^T", run(), cb.masked_fill(~keep, 0), tol)
    _same_bits("C B^T", run)
    prev = ssd_ref._state_pass_ref(st, cum)
    run = lambda: ssd._state_pass(st, cum, x.dtype)  # noqa: E731
    errs["state_pass"] = _held("state pass", run(), prev, tol)
    _same_bits("state pass", run)
    run = lambda: ssd._chunk_scan(x, dtc, cm, cb, cum, prev,  # noqa: E731
                                  chunk=q)
    errs["chunk_scan"] = _held("chunk scan", run(), ssd_ref._chunk_scan_ref(
        x, dt, cm, cb, cum, prev, chunk=q), tol)
    _same_bits("chunk scan", run)
    return errs


def ssd_kernel_checks(dev) -> tuple:
    """The SSD kernel, and each of its passes, against its plain version
    on the card → (max abs error of the scan, {case: per-pass errors});
    prints each case's errors and the share of y that the state carried
    across chunks makes."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    worst, per_pass = 0.0, {}
    cases = [((SSM_B, SSM_T, 80, 64, 1, 128), "the forward's shape"),
             ((SSM_B, 1000, 80, 64, 1, 128), "ragged T=1000"),
             ((SSM_B, 512, 80, 64, 2, 128), "G=2")]
    for dtype in (torch.float32, torch.bfloat16):
        tol = SSD_TOL[str(dtype).split(".")[1]]
        for case, label in cases:
            x, dt, a, bm, cm = _ssd_operands(case, dtype, gen, dev)
            out = ssd.ssd_scan(x, dt, a, bm, cm, chunk=256)
            torch.cuda.synchronize()
            want = ssd_ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
            err = _held(f"{label} {dtype}", out, want, tol)
            own = torch.cat([ssd_ref.ssd_scan_ref(
                x[:, i:i + 256], dt[:, i:i + 256], a, bm[:, i:i + 256],
                cm[:, i:i + 256], chunk=256) for i in range(0, case[1], 256)],
                dim=1)
            carried = float((want.float() - own.float()).abs().max()
                            / want.float().abs().max())
            if not torch.equal(out, ssd.ssd_scan(x, dt, a, bm, cm,
                                                 chunk=256)):
                fail("ssd gives other bits on a second run")
            del out, want, own
            torch.cuda.empty_cache()
            errs = ssd_pass_checks(x, dt, a, bm, cm, tol)
            per_pass[f"{label} {dtype}"] = errs
            log(f"[7] ssd {label} {list(case)} {dtype}: max abs err "
                f"{err:.3e} (tolerance rtol=atol={tol}); the carried state "
                f"moves y by {carried:.3f} of max |y|; passes against their "
                f"plain passes: " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in errs.items()))
            worst = max(worst, err)
            del x, dt, a, bm, cm
            torch.cuda.empty_cache()
    return worst, per_pass


def _cuobjdump():
    """cuobjdump of the CUDA toolkit or of Triton's package, or None."""
    import importlib.util
    import os
    import shutil
    found = shutil.which("cuobjdump")
    cands = [Path(found)] if found else []
    cands.append(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                 / "bin" / "cuobjdump")
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        cands.append(Path(list(spec.submodule_search_locations)[0])
                     / "backends" / "nvidia" / "bin" / "cuobjdump")
    return next((str(c) for c in cands if c.is_file()), None)


def kernel_build_report(built, source, key) -> dict:
    """Registers and spills of each kernel instance of ``source``
    (``-Xptxas=-v`` in the build log) and its tensor-core instructions
    (HMMA in ``cuobjdump -sass``, where found) → {key(symbol): {...}} over
    the mangled symbols that ``key`` names (None skips one)."""
    import re

    lib, build_log = built[source]
    report, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = key(m.group(1))
            if cur:
                report[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[cur]["spill_stores"] = int(m.group(1))
            report[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[cur]["registers"] = int(m.group(1))
    if not report:
        log(f"    {source} build log empty (library built earlier): "
            f"registers and spills not read")
    tool = _cuobjdump()
    if tool is None:
        log(f"    cuobjdump not found: HMMA instructions of {source} not "
            f"counted")
        return report
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = key(m.group(1))
            if cur:
                report.setdefault(cur, {})["hmma"] = 0
        elif cur and "HMMA" in line:
            report[cur]["hmma"] += 1
    return report


def ssd_build_report(built) -> dict:
    """Registers and spills of each SSD pass, its block's dynamic shared
    memory, the blocks an SM holds, and its tensor-core instructions →
    {"pass dtype": {...}}."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd

    kernels = {f"ssd_{name}_kernel": name for name in ssd.PASSES}

    def key(symbol):
        for kern, name in kernels.items():
            if kern in symbol:
                return f"{name} {'bf16' if 'bfloat16' in symbol else 'f32'}"
        return None

    report = kernel_build_report(built, "ssd.cu", key)
    for name in ssd.PASSES:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            r = report.setdefault(f"{name} {tag}", {})
            r["smem_bytes"], r["blocks_per_sm"] = ssd.pass_resources(name,
                                                                     dtype)
    if _cuobjdump() is not None:
        no_tc = [k for k in ("chunk_state bf16", "cb bf16", "chunk_scan bf16")
                 if not report.get(k, {}).get("hmma")]
        if no_tc:
            fail(f"ssd passes with no tensor-core instruction: {no_tc}")
    for k, r in sorted(report.items()):
        log(f"[7] ssd pass {k}: {r.get('registers', '?')} registers, spill "
            f"stores/loads {r.get('spill_stores', '?')}/"
            f"{r.get('spill_loads', '?')} bytes, {r['smem_bytes']} bytes of "
            f"dynamic shared memory a block, {r['blocks_per_sm']} blocks an "
            f"SM, HMMA instructions {r.get('hmma', 'not counted')}")
    return report


def flash_build_report(built) -> dict:
    """Registers and spills of each flash-attention kernel instance, the
    mma and split routes' shared memory and blocks an SM, and HMMA
    instructions: the tensor-core instances must have them, the CUDA-core
    ones (fma and split, f32 among them) none → {"route D dtype": {...}}."""
    import re
    import torch
    from repro_torch.kernels.flash_attention import ops as fa

    def key(symbol):
        m = re.search(r"flash_mma_kernelILi(\d+)E", symbol)
        if m:
            return f"mma D{m.group(1)} bf16"
        m = re.search(r"flash_(split_)?kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      symbol)
        if m:
            dtype = "f32" if m.group(2) == "f" else "bf16"
            return f"{'split' if m.group(1) else 'fma'} D{m.group(3)} {dtype}"
        return None

    report = kernel_build_report(built, "flash_attention.cu", key)
    for d in fa.HEAD_DIMS:
        r = report.setdefault(f"mma D{d} bf16", {})
        r["smem_bytes"], r["blocks_per_sm"] = fa.mma_resources(d)
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            r = report.setdefault(f"split D{d} {tag}", {})
            r["static_smem_bytes"], regs, r["blocks_per_sm"] = \
                fa.split_resources(dtype, d)
            r.setdefault("registers", regs)   # where the build log is empty
    if _cuobjdump() is not None:
        wrong = [k for k, r in report.items()
                 if bool(r.get("hmma")) != k.startswith("mma")]
        if wrong:
            fail(f"flash instances with HMMA on the CUDA-core route or none "
                 f"on the tensor-core route: {wrong}")
    for k, r in sorted(report.items()):
        smem = (f", {r['smem_bytes']} bytes of dynamic shared memory a "
                f"block, {r['blocks_per_sm']} blocks an SM"
                if "smem_bytes" in r else
                f", {r['static_smem_bytes']} bytes of static shared memory "
                f"a block, {r['blocks_per_sm']} blocks an SM"
                if "static_smem_bytes" in r else "")
        log(f"[3] flash_attention {k}: {r.get('registers', '?')} registers, "
            f"spill stores/loads {r.get('spill_stores', '?')}/"
            f"{r.get('spill_loads', '?')} bytes{smem}, HMMA instructions "
            f"{r.get('hmma', 'not counted')}")
    return report


def rmsnorm_build_report(built) -> dict:
    """Registers and spills of each RMSNorm instance (build log), and its
    registers, local memory and blocks an SM at the block size of the
    main path's rows (D 896, 2560, 5120; D 1001 and 5121 for the
    one-element width) → {"route vecN dtype DN": {...}}."""
    import re
    import torch
    from repro_torch.kernels.rmsnorm import ops as rms

    def key(symbol):
        m = re.search(
            r"rmsnorm_(warp|block)_kernelI(f|13__nv_bfloat16)Li(\d+)E", symbol)
        if m:
            dtype = "f32" if m.group(2) == "f" else "bf16"
            return f"{m.group(1)} vec{m.group(3)} {dtype}"
        return None

    logged = kernel_build_report(built, "rmsnorm.cu", key)
    report = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in (896, 1001, 2560, 5120, 5121):
            plan = rms._plan(dtype, d, True)
            name = f"{plan.route} vec{plan.vec} {tag}"
            r = dict(logged.get(name, {}), d=d, threads=plan.threads)
            regs, local, r["blocks_per_sm"] = rms.resources(dtype, plan)
            r.setdefault("registers", regs)   # where the build log is empty
            r["local_bytes"] = local
            report[f"{name} D{d}"] = r
            log(f"[3] rmsnorm {name} at D {d} ({plan.threads} threads a "
                f"block): {r['registers']} registers, spill stores/loads "
                f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} "
                f"bytes, {local} bytes of local memory, "
                f"{r['blocks_per_sm']} blocks an SM")
    if len({k.rsplit(" ", 1)[0] for k in report}) != 8:
        fail(f"rmsnorm build report covers {sorted(report)}, not the 8 "
             f"instances")
    return report


def ssm_path(dev, card, rms_err, built) -> tuple:
    """mamba2-2.7b: phase 7 → (kernel rows, launches per kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref
    from repro_torch.models import mamba2
    from repro_torch.models import model_zoo as Z

    ssd_err, ssd_pass_err = ssd_kernel_checks(dev)
    ssd_build = ssd_build_report(built)
    rms_err = max(rms_err, rmsnorm_checks(
        "7", (((SLOTS, 2560), 0), ((SLOTS, 5120), 0),
              ((SSM_B * SSM_T, 5120), 0)), dev))

    # ---- serve at full width from the recurrent state ----------------------
    cfg = get_config("mamba2-2.7b")
    model = Z.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params, param_bytes = describe(model)
    di = cfg.d_model * cfg.ssm_expand
    log(f"[7] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"inner {di}, {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, groups {cfg.ssm_groups}, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab}; {n_params} parameters, {param_bytes / 1e9:.3f} "
        f"GB (bf16 weights; f32 A_log, D, dt_bias, gate_norm, norm scales)")
    serve, eng_k, last = serve_check(
        "7", cfg, model, dev, card, {"rmsnorm": 2 * cfg.n_layers + 1},
        floor=True)
    step_ms, prof_decode = decode_times("7", cfg, model, eng_k, last, card,
                                        param_bytes)
    serve["decode_step_ms"] = step_ms
    state_bytes = eng_k.cache["state"].numel() * 4
    del eng_k
    torch.cuda.empty_cache()

    # ---- prefill forward at B 2, T 4096 -------------------------------------
    # The init's dt_bias 0 makes dt about 0.7 (softplus of ~N(0, 1)), so the
    # state decays within a few steps; and its conv_w of std 0.02 leaves x,
    # B and C near 0.02, where the scan adds little to y.  Redraw both from
    # a seed (dt in Mamba-2's initial range) so the scan and its carry move
    # the logits this phase compares; the phase checks that they do.
    g2 = torch.Generator(device=dev).manual_seed(6)
    for blk in model.layers:
        dt0 = torch.rand(blk.dt_bias.shape, generator=g2, device=dev)
        dt0 = dt0 * 0.099 + 0.001
        blk.dt_bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
        blk.conv_w.copy_(torch.randn(blk.conv_w.shape, generator=g2,
                                     device=dev) * 0.5)
    log("[7] forward weights: dt_bias = softplus^-1 of U[0.001, 0.1] and "
        "conv_w ~ N(0, 0.5^2), redrawn from seed 6 (the reference's init "
        "has dt_bias 0 and conv_w std 0.02)")
    batch = Z.make_batch(cfg, seq_len=SSM_T, global_batch=SSM_B,
                         generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    fwd, prof_fwd = forward_check(
        "7", cfg, model, dev, card, batch,
        {"ssd": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}, floor=True,
        match=("ssd_",) + tuple(f"ssd_{k}_kernel" for k in ssd.PASSES))
    tol = max(2e-2, 2 * fwd["rounding_floor"])
    ssd_dev = prof_fwd["matched_ms"]["ssd_"]
    fwd_pass_ms = {k: prof_fwd["matched_per_launch_ms"][f"ssd_{k}_kernel"]
                   for k in ssd.PASSES}
    log(f"[7] forward drift {fwd['max_rel_logit_diff']:.3e} of max |logit| "
        f"against a tolerance of {tol:.3e} (max(2e-2, 2 x rounding floor "
        f"{fwd['rounding_floor']:.3e})); the SSD's passes take "
        f"{ssd_dev:.2f} ms of the traced forward's {prof_fwd['device_ms']:.2f}"
        f" ms of device time ({100 * ssd_dev / prof_fwd['device_ms']:.1f}%); "
        f"per launch there: " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in fwd_pass_ms.items()))
    plain = mamba2._SSD["torch"]
    try:
        mamba2._SSD["torch"] = lambda x, *a, **k: torch.zeros_like(x)
        dropped = Z.forward(model, cfg, batch, backend="torch")
    finally:
        mamba2._SSD["torch"] = plain
    with_ssd = Z.forward(model, cfg, batch, backend="torch")
    moved = float(((dropped.float() - with_ssd.float()).abs()
                   / with_ssd.float().abs().amax((-2, -1), keepdim=True))
                  .max())
    fwd["ssd_moves_logits"] = moved
    log(f"[7] dropping the SSD's output moves the forward's logits by "
        f"{moved:.3e} of max |logit|; the comparison's tolerance is "
        f"{tol:.3e} of it (plus 2e-2 of each logit)")
    if moved <= tol:
        fail("the SSD's output moves the forward's logits less than the "
             "comparison's tolerance: the forward would not test the kernel")
    del dropped, with_ssd
    torch.cuda.empty_cache()
    log_profiles("7", cfg.name, {"decode": prof_decode, "forward": prof_fwd},
                 card)

    # ---- kernel times ---------------------------------------------------------
    bf16 = torch.bfloat16
    case = (SSM_B, SSM_T, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state)
    x, dt, a, bm, cm = _ssd_operands(case, bf16, torch.Generator(
        device=dev).manual_seed(7), dev)
    b_, t_, h, p, g, n = case
    n_bytes = (2 * b_ * t_ * h * p * 2 + b_ * t_ * h * 4 + h * 4
               + 2 * b_ * t_ * g * n * 2)
    n_ops = ssd_ops_count(*case, cfg.ssm_chunk)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS)
    times = {"ssd forward": dict(
        shape=list(case), chunk=cfg.ssm_chunk,
        ms=cuda_ms(lambda: ssd.ssd_scan(x, dt, a, bm, cm, chunk=256)),
        plain_ms=cuda_ms(lambda: ssd_ref.ssd_scan_ref(x, dt, a, bm, cm,
                                                      chunk=256)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
        ops=n_ops)}
    # each pass alone on the same operands
    cum, dtc, st = ssd._chunk_state(x, dt, a, bm, chunk=256)
    cb = ssd._cb(bm, cm, chunk=256)
    prev = ssd._state_pass(st, cum, bf16)
    pass_ms = {
        "chunk_state": cuda_ms(lambda: ssd._chunk_state(x, dt, a, bm,
                                                        chunk=256)),
        "cb": cuda_ms(lambda: ssd._cb(bm, cm, chunk=256)),
        "state_pass": cuda_ms(lambda: ssd._state_pass(st, cum, bf16)),
        "chunk_scan": cuda_ms(lambda: ssd._chunk_scan(x, dtc, cm, cb, cum,
                                                      prev, chunk=256))}
    # the device's own time of each pass within scan calls (the events
    # above also hold the host's launch work wherever the card waits on it)
    prof = profile_ms(lambda: ssd.ssd_scan(x, dt, a, bm, cm, chunk=256),
                      steps=20, match=tuple(f"ssd_{k}_kernel"
                                            for k in ssd.PASSES))
    dev_ms = {k: prof["matched_per_launch_ms"][f"ssd_{k}_kernel"]
              for k in ssd.PASSES}
    times["ssd forward"].update(passes_ms=pass_ms, passes_device_ms=dev_ms,
                                device_ms=sum(dev_ms.values()))
    log(f"[7] ssd forward {list(case)} bf16: scan call "
        f"{times['ssd forward']['ms']:.4f} ms by events, "
        f"{sum(dev_ms.values()):.4f} ms on the device in "
        f"{len(ssd.PASSES)} launches; each pass alone by events: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in pass_ms.items())
        + "; on the device within the call: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items())
        + f" ({card})")
    del x, dt, a, bm, cm, cum, dtc, st, cb, prev
    times["rmsnorm decode"] = rmsnorm_times(SLOTS, cfg.d_model, dev)
    times["rmsnorm gated decode"] = rmsnorm_times(SLOTS, di, dev)
    times["rmsnorm prefill"] = rmsnorm_times(SSM_B * SSM_T, cfg.d_model, dev)
    times["rmsnorm gated prefill"] = rmsnorm_times(SSM_B * SSM_T, di, dev)
    log_times("7", times, card)

    log("lm " + json.dumps({
        "card": card, "model": cfg.name, "params": n_params,
        "param_bytes": param_bytes, "state_bytes": state_bytes,
        "serve": serve, "forward": fwd,
        "profile": {"decode": prof_decode, "forward": prof_fwd},
        "kernels": times, "max_abs_err": {"ssd": ssd_err,
                                          "rmsnorm": rms_err},
        "ssd_passes": {"max_abs_err": ssd_pass_err, "build": ssd_build,
                       "forward_device_ms": ssd_dev,
                       "forward_per_launch_ms": fwd_pass_ms}}))
    r = times["ssd forward"]
    rows = [dict(name="ssd", route="cuda", source=SOURCES["ssd"],
                 replaces=REPLACES["ssd"], launches=0, max_abs_err=ssd_err,
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=None,
                 shape=f"mamba2-2.7b forward {r['shape']} bf16")]
    launches = {k: serve["launches"][k] + fwd["launches"][k]
                for k in serve["launches"]}
    return rows, launches, rms_err


# ---------------------------------------------------------------------------
# 8. train qwen2-0.5b: the backward kernels, a step on both backends, the
#    trainer with a failure and its replay
# ---------------------------------------------------------------------------

#: Full-width training of qwen2-0.5b: seq_len, global batch (the config's 2
#: microbatches of 4), steps through the trainer, a checkpoint every 4 and
#: one injected failure at step 5.
TRAIN_T, TRAIN_B, TRAIN_STEPS = 1024, 8, 8
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 5
#: The trainer's final loss after a failure and its replay, against a clean
#: run's: the JAX package's own tolerance (``tests/test_system.py:29``).
RECOVERY_RTOL = 1e-4
#: Flash backward cases (b, t, h, kv, d, causal, window, label); each runs
#: in f32 (the fma route) and bf16 (the mma route).
FLASH_BWD_CASES = (
    (4, 1024, 14, 2, 64, True, 0, "train shape T=1024 causal"),
    (2, 512, 16, 2, 128, True, 0, "D=128 T=512 causal"),
    (2, 512, 14, 2, 64, True, 96, "window T=512 w=96"),
    (2, 512, 14, 2, 64, True, 40, "window T=512 w=40 (below a key tile)"),
    (2, 80, 14, 2, 64, True, 0, "T=80 causal (a ragged second tile)"),
    (2, 1000, 14, 2, 64, True, 0, "ragged T=1000 causal"),
    (2, 256, 4, 4, 64, True, 0, "G=1 T=256 causal"),
    (2, 256, 14, 2, 64, False, 0, "T=256 full"),
    (2, 8, 14, 2, 64, True, 0, "T=8 causal (below the split route's rows)"))
#: RMSNorm backward cases (rows, D, operand offset by one element): the
#: train shape, a ragged row count, the block route at mamba2's widths, one
#: element an access (D 1,001; an offset view of g, then of x, so that
#: each pointer's alignment picks the width).
RMSNORM_BWD_CASES = ((4096, 896, None), (4095, 896, None),
                     (2560, 2560, None), (1000, 5120, None), (5, 1001, None),
                     (4096, 896, "g"), (64, 2560, "x"))
#: mamba2-2.7b's widths (d_model, d_inner) at its train_4k rows, timed
#: beside the train shape; not yet on a main path.
RMSNORM_BWD_WIDE = ((8192, 2560), (8192, 5120))
#: Substrings of the RMSNorm backward's device kernels' names: the row
#: kernel of either route, then the dscale sum.
RMSNORM_BWD_KERNELS = ("rmsnorm_bwd_warp", "rmsnorm_bwd_block",
                       "rmsnorm_bwd_dscale")


def _offset_view(t, on):
    """t, or where ``on`` a copy of it one element into a fresh buffer: a
    contiguous view whose pointer is not 16-byte aligned."""
    import torch
    if not on:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def _grad_held(label, got, want, tol) -> float:
    """``got`` within tol·max|want| + tol·|want| of ``want`` → max abs
    error; fails otherwise."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(g).all()) or float(
            (diff - tol * w.abs().amax() - tol * w.abs()).max()) > 0:
        fail(f"{label} disagrees with its plain version: max abs {err}, max "
             f"|plain| {float(w.abs().max())}")
    return err


def train_kernel_checks(dev) -> dict:
    """Each backward kernel against its plain backward on the card, the
    same bits on a second call; the log-sum-exp forward's O against the
    same route without it (bit for bit) and its LSE against the plain one
    → max abs errors."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.rmsnorm import ops as rms, ref as rms_ref

    gen = torch.Generator(device=dev).manual_seed(8)
    errs = {"flash_attention_bwd": 0.0, "rmsnorm_bwd": 0.0, "lse": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = LM_TOL[str(dtype).split(".")[1]]
        for b, t, h, kvh, d, causal, window, label in FLASH_BWD_CASES:
            q = _rand((b, t, h, d), gen, dtype, dev)
            k = _rand((b, t, kvh, d), gen, dtype, dev)
            v = _rand((b, t, kvh, d), gen, dtype, dev)
            dout = _rand((b, t, h, d), gen, dtype, dev)
            route = fa._grad_route(dtype, d)
            out, lse = fa._launch(q, k, v, causal, window, 0, route, True)
            plain_o, _ = fa._launch(q, k, v, causal, window, 0, route, False)
            if not torch.equal(out, plain_o):
                fail(f"flash_attention {label} {dtype}: the {route} route's "
                     f"O differs with the log-sum-exp written")
            _, want_lse = fa_ref.attention_fwd_ref(q, k, v, causal=causal,
                                                   window=window)
            lse_err = float((lse - want_lse).abs().max())
            if lse_err > tol * (1 + float(want_lse.abs().max())):
                fail(f"flash_attention {label} {dtype}: log-sum-exp off by "
                     f"{lse_err}")
            run = lambda: fa.flash_attention_bwd(                # noqa: E731
                q, k, v, out, lse, dout, causal=causal, window=window)
            fa.reset_backward_route_counts()
            got = run()
            torch.cuda.synchronize()
            bwd_route = fa._bwd_route(dtype, d)
            if fa.backward_route_counts() != {"fma": 0, "mma": 0,
                                              bwd_route: 1}:
                fail(f"flash_attention_bwd {label} {dtype}: backward routes "
                     f"{fa.backward_route_counts()}, expected one {bwd_route}")
            want = fa_ref.attention_bwd_ref(q, k, v, out, lse, dout,
                                            causal=causal, window=window)
            err = max(_grad_held(f"flash_attention_bwd {label} {dtype} {n}",
                                 g, w, tol)
                      for n, g, w in zip(("dq", "dk", "dv"), got, want))
            again = run()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"flash_attention_bwd {label} {dtype} gives other bits "
                     f"on a second call")
            log(f"[8] flash_attention_bwd {label} {dtype}: forward route "
                f"{route} (O bit-equal without the log-sum-exp; lse max abs "
                f"err {lse_err:.3e}), backward route {bwd_route}, dq/dk/dv "
                f"max abs err {err:.3e} "
                f"(tolerance {tol} x max|g| + {tol} x |g|), same bits twice")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
            errs["lse"] = max(errs["lse"], lse_err)
            del q, k, v, dout, out, lse, plain_o, got, want, again
        for rows, d, off in RMSNORM_BWD_CASES:
            x = _offset_view(_rand((rows, d), gen, dtype, dev), off == "x")
            sc = torch.randn(d, generator=gen, device=dev)
            g = _offset_view(_rand((rows, d), gen, dtype, dev), off == "g")
            label = (f"rmsnorm_bwd [{rows}, {d}]"
                     f"{f' ({off} offset)' if off else ''} {dtype}")
            dx, dsc = rms.rmsnorm_bwd(x, sc, g)
            torch.cuda.synchronize()
            wdx, wdsc = rms_ref.rmsnorm_bwd_ref(x, sc, g)
            err = max(_grad_held(f"{label} dx", dx, wdx, tol),
                      _grad_held(f"{label} dscale", dsc, wdsc, tol))
            dx2, dsc2 = rms.rmsnorm_bwd(x, sc, g)
            if not (torch.equal(dx, dx2) and torch.equal(dsc, dsc2)):
                fail(f"{label} gives other bits on a second call")
            plan = rms.bwd_plan(dtype, rows, d, not (
                x.data_ptr() | sc.data_ptr() | g.data_ptr() | dx.data_ptr())
                & 15)
            if off and plan.vec != 1:
                fail(f"{label}: an unaligned operand took {plan.vec}-element "
                     f"vectors")
            log(f"[8] {label}: {plan.route} route, {plan.vec} elements an "
                f"access, {plan.threads} threads x {plan.blocks} blocks, "
                f"dscale over {plan.reduce_blocks} blocks; dx/dscale max abs "
                f"err {err:.3e} (tolerance {tol} x max|g| + {tol} x |g|), "
                f"same bits twice")
            errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], err)
    return errs


_PLAIN = (("flash_attention", "attention_ref"),
          ("flash_attention", "attention_fwd_ref"),
          ("flash_attention", "attention_bwd_ref"),
          ("rmsnorm", "rmsnorm_ref"), ("rmsnorm", "rmsnorm_bwd_ref"),
          ("ssd", "ssd_scan_ref"), ("ssd", "ssd_scan_bwd_ref"))


@contextlib.contextmanager
def counting_plain_versions(calls: dict):
    """Within: every call of a kernel's plain version (through its module or
    the model's backend tables) adds one to ``calls[name]``."""
    import importlib
    from repro_torch.models import layers, mamba2

    saved = []
    for kernel, name in _PLAIN:
        mod = importlib.import_module(f"repro_torch.kernels.{kernel}.ref")
        fn = getattr(mod, name)
        calls.setdefault(name, 0)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    # the model's backend tables hold the plain forwards themselves
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    plain_tables = [(layers._ATTENTION, layers._ATTENTION["torch"]),
                    (layers._RMSNORM, layers._RMSNORM["torch"]),
                    (mamba2._SSD, mamba2._SSD["torch"])]
    layers._ATTENTION["torch"] = fa_ref.attention_ref
    layers._RMSNORM["torch"] = rms_ref.rmsnorm_ref
    mamba2._SSD["torch"] = ssd_ref.ssd_scan_ref
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for t, fn in plain_tables:
            t["torch"] = fn


def _leaf_names(tree, path="") -> list:
    """Leaf paths of a tree in ``repro_torch.tree``'s order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path[1:]]


def _leaf_rel(got, want) -> list:
    """max |got - want| / max |want| of each leaf pair."""
    return [float((g.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


def train_step_check(cfg, dev, card, tag, want) -> dict:
    """One train step's loss and gradients at full width on the kernels
    (counts set to 0 just before, read just after, and held to ``want``;
    every plain version counted) and on the plain versions, from the same
    parameters and batch, held to max(2e-2, 2 x the rounding floor): how
    far the plain bf16 step lies from its float32 twin.  The kernels'
    gradients are compared and dropped before the twin runs; the peak
    device memory of the three steps is reported."""
    import torch
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.launch import steps as ST
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P
    from repro_torch.optim.clip import global_norm
    from repro_torch.tree import leaves, tree_map

    torch.cuda.reset_peak_memory_stats()
    params = P.init_tree(Z.spec(cfg), torch.Generator(device=dev)
                         .manual_seed(0), dev)
    pipe = DataPipeline(SyntheticLM(cfg.vocab, 0), global_batch=TRAIN_B,
                        seq_len=TRAIN_T)
    try:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe._make_batch(0).items()}
    finally:
        pipe.close()
    m = cfg.microbatches
    reset_lm_counts()
    with counting_plain_versions({}) as plain_calls:
        loss_k, grads_k = ST.loss_and_grads(params, cfg, batch,
                                            microbatches=m, backend="cuda")
        torch.cuda.synchronize()
    counts = dict(lm_counts(), **{f"flash_{r}": n
                                  for r, n in flash_routes().items()},
                  **{f"flash_bwd_{r}": n for r, n in
                     _lm_kernel_ops()[0].backward_route_counts().items()})
    loss_t, grads_t = ST.loss_and_grads(params, cfg, batch, microbatches=m,
                                        backend="torch")
    gk, gt = leaves(grads_k), leaves(grads_t)
    norms = [float(global_norm(g)) for g in (grads_k, grads_t)]
    rel_k = _leaf_rel(gk, gt)
    finite = bool(torch.isfinite(loss_k)) and all(
        bool(torch.isfinite(g).all()) for g in gk)
    names = _leaf_names(grads_t)
    del grads_k, gk
    torch.cuda.empty_cache()
    params32 = tree_map(lambda p: p.float(), params)
    del params
    loss_f, grads_f = ST.loss_and_grads(params32, cfg, batch,
                                        microbatches=m, backend="torch")
    del params32
    gf = leaves(grads_f)
    norms.append(float(global_norm(grads_f)))
    floor_leaf = _leaf_rel(gt, gf)
    del grads_t, grads_f, gt, gf
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    loss_rel = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    loss_floor = abs(float(loss_t) - float(loss_f)) / abs(float(loss_f))
    norm_rel = abs(norms[0] - norms[1]) / norms[1]
    norm_floor = abs(norms[1] - norms[2]) / norms[2]
    floor = max(floor_leaf + [loss_floor, norm_floor])
    over = [i for i, (e, f) in enumerate(zip(rel_k, floor_leaf))
            if e > max(2e-2, 2 * f)]
    # the leaves nearest their tolerance: error / max(2e-2, 2 x floor)
    margin = [e / max(2e-2, 2 * f) for e, f in zip(rel_k, floor_leaf)]
    nearest = sorted(range(len(margin)), key=lambda i: -margin[i])[:4]
    log(f"[{tag}] {cfg.name} one step (B {TRAIN_B}, T {TRAIN_T}, {m} "
        f"microbatches): loss cuda {float(loss_k):.6f} torch "
        f"{float(loss_t):.6f} f32 twin {float(loss_f):.6f}; grad norm cuda "
        f"{norms[0]:.6f} torch {norms[1]:.6f} twin {norms[2]:.6f}; cuda vs "
        f"torch: loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e}, "
        f"largest leaf error / max|g| {max(rel_k):.3e}; rounding floor "
        f"(torch bf16 vs its f32 twin): loss {loss_floor:.3e}, grad norm "
        f"{norm_floor:.3e}, leaves up to {max(floor_leaf):.3e}; tolerance "
        f"max(2e-2, 2 x floor) per quantity; launches {counts}; plain "
        f"versions called on the cuda step {plain_calls}; peak device memory "
        f"of the three steps {peak / 1e9:.2f} GB ({card})")
    log(f"[{tag}] the leaves nearest their tolerance (error / max(2e-2, 2 x "
        "floor)): " + "; ".join(
            f"{names[i]} {rel_k[i]:.3e} / max(2e-2, 2 x {floor_leaf[i]:.3e})"
            f" = {margin[i]:.3f}" for i in nearest))
    if not finite:
        fail("the kernels' train step gave a non-finite loss or gradient")
    if over or loss_rel > max(2e-2, 2 * loss_floor) \
            or norm_rel > max(2e-2, 2 * norm_floor):
        fail(f"the kernels' train step disagrees with the plain versions' "
             f"beyond max(2e-2, 2 x floor): loss {loss_rel}, grad norm "
             f"{norm_rel}, leaves {[(i, rel_k[i], floor_leaf[i]) for i in over]}")
    if any(plain_calls.values()):
        fail(f"the cuda backend's train step called plain versions: "
             f"{plain_calls}")
    want = dict({k: 0 for k in counts}, **want)
    if counts != want:
        fail(f"train step launch counts {counts}, expected {want}")
    return dict(loss_cuda=float(loss_k), loss_torch=float(loss_t),
                loss_f32_twin=float(loss_f), grad_norm_cuda=norms[0],
                grad_norm_torch=norms[1], grad_norm_f32_twin=norms[2],
                loss_rel=loss_rel, grad_norm_rel=norm_rel,
                max_leaf_rel=max(rel_k), rounding_floor=floor,
                floor_loss=loss_floor, floor_grad_norm=norm_floor,
                floor_leaf_max=max(floor_leaf),
                leaves_nearest_tolerance=[(names[i], margin[i])
                                          for i in nearest],
                launches=counts, plain_calls=plain_calls, peak_bytes=peak)


def trainer_runs(tag, cfg, card, replay_layers=0, lr=None) -> dict:
    """Eight steps through ``repro_torch.launch.train.main`` at full width
    on the card, clean and with a failure at step 5 after a checkpoint at
    step 4: the loss falls, and the replayed run ends on the clean run's
    final loss within ``RECOVERY_RTOL``.  With ``replay_layers`` the pair
    that is compared (a clean run and the failure's) runs at that depth,
    after the clean run at the config's; ``lr`` replaces the trainer's
    default learning rate."""
    import shutil
    import tempfile
    from repro_torch.launch import train

    common = ["--arch", cfg.name, "--no-smoke", "--steps", str(TRAIN_STEPS),
              "--seq-len", str(TRAIN_T), "--global-batch", str(TRAIN_B)]
    if lr is not None:
        common += ["--lr", str(lr)]
    t0 = time.perf_counter()
    clean = train.main(common)
    t1 = time.perf_counter()
    pair = common + (["--layers", str(replay_layers)] if replay_layers else [])
    base = train.main(pair) if replay_layers else clean
    t2 = time.perf_counter()
    failed = train.main(pair + ["--ckpt-every", str(TRAIN_CKPT_EVERY),
                                "--inject-failure-at", str(TRAIN_FAIL_AT)])
    t3 = time.perf_counter()
    rel = abs(failed[-1] - base[-1]) / abs(base[-1])
    same = failed[-1] == base[-1]
    depth = replay_layers or cfg.n_layers
    log(f"[{tag}] trainer, {TRAIN_STEPS} steps, {cfg.n_layers} layers: losses "
        f"{clean}; wall {t1 - t0:.1f} s"
        + (f"; at {depth} layers: losses {base}, wall {t2 - t1:.1f} s"
           if replay_layers else "")
        + f"; with a checkpoint every {TRAIN_CKPT_EVERY} and a failure at "
        f"step {TRAIN_FAIL_AT} ({depth} layers): {len(failed)} step runs, "
        f"final loss {failed[-1]!r} vs {base[-1]!r} (rel {rel:.3e}, "
        f"tolerance {RECOVERY_RTOL}; bit-identical: {same}); wall "
        f"{t3 - t2:.1f} s; disk free under the checkpoints' directory "
        f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f} GB "
        f"({card})")
    if not clean[-1] < clean[0]:
        fail(f"the trainer's loss did not fall over {TRAIN_STEPS} steps: "
             f"{clean}")
    if rel > RECOVERY_RTOL:
        fail(f"the replayed run's final loss {failed[-1]} is {rel} from the "
             f"clean run's {base[-1]}")
    return dict(losses=clean, losses_replay_depth=base,
                losses_with_failure=failed, replay_layers=depth,
                recovery_rel=rel, recovery_bit_identical=same,
                wall_s_clean=t1 - t0, wall_s_replay_depth=t2 - t1,
                wall_s_failure=t3 - t2)


def train_times(cfg, dev, card) -> tuple:
    """The step's time by CUDA events (median of steps 3-8 of 8) and its
    tokens/s, one step traced (device busy share, largest kernels), and
    each backward kernel's time beside its plain version, its library call
    (the autograd backward of SDPA and of ``F.rms_norm``) and its bound, at
    the step's shapes (the RMSNorm backward also at ``RMSNORM_BWD_WIDE``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.launch import steps as ST
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P

    step_fn, opt = ST.build_train_step(cfg, seq_len=TRAIN_T,
                                       global_batch=TRAIN_B, lr=3e-3,
                                       device=dev, backend="cuda")
    params = P.init_tree(Z.spec(cfg), torch.Generator(device=dev)
                         .manual_seed(0), dev)
    state = opt.init(params)
    pipe = DataPipeline(SyntheticLM(cfg.vocab, 0), global_batch=TRAIN_B,
                        seq_len=TRAIN_T)
    try:
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in pipe._make_batch(i).items()}
                   for i in range(TRAIN_STEPS + 2)]
    finally:
        pipe.close()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, metrics = step_fn(params, state, batches[i])
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[2:])
    tokens = TRAIN_B * TRAIN_T
    prof = profile_ms(lambda: step_fn(params, state, batches[TRAIN_STEPS]),
                      steps=1, warmup=False,
                      match=("flash_bwd", "flash_mma", "rmsnorm_bwd",
                             "rmsnorm_warp", "gemm", "Kernel2")
                      + FLASH_BWD_KERNELS)
    log(f"[8] train step on the kernels: {[round(x, 3) for x in step_ms]} ms "
        f"by events; median of steps 3-{TRAIN_STEPS} {med:.3f} ms, "
        f"{tokens / med * 1e3:.1f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB, {held / 1e9:.2f} GB of it held before the "
        f"first step ({card})")
    rb = prof["matched_ms"]["rmsnorm_bwd"]
    rb_launch = prof["matched_per_launch_ms"]["rmsnorm_bwd"]
    log(f"[8] the RMSNorm backward in the traced step: {rb:.3f} ms of "
        f"{prof['device_ms']:.3f} ms on the device in "
        f"{round(rb / rb_launch) if rb_launch else 0} device launches, "
        f"{rb_launch:.5f} ms a launch ({card})")
    fb = prof["matched_ms"]["flash_bwd"]
    log(f"[8] the flash backward in the traced step: {fb:.3f} ms of "
        f"{prof['device_ms']:.3f} ms on the device "
        f"({100 * fb / max(prof['device_ms'], 1e-9):.1f}%; device busy "
        f"{100 * prof['busy_share']:.1f}%): "
        + ", ".join(f"{m} {prof['matched_ms'][m]:.3f} ms"
                    for m in FLASH_BWD_KERNELS) + f" ({card})")
    log_profiles("8", cfg.name, {"train step": prof}, card)
    del params, state, batches
    torch.cuda.empty_cache()

    # each backward kernel at the step's shapes
    bf16 = torch.bfloat16
    b, t, h, kvh, d = (TRAIN_B // cfg.microbatches, TRAIN_T, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v, dout = (_rand((b, t, n, d), g, bf16, dev)
                     for n in (h, kvh, kvh, h))
    out, lse = fa._launch(q, k, v, True, 0, 0, "mma", True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    lib_dout = dout.transpose(1, 2)
    pairs = b * h * t * (t + 1) // 2
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    n_bytes = 2 * (4 * b * t * h * d + 4 * b * t * kvh * d) + 4 * b * h * t
    b_ms, b_by = bound(n_bytes, 10 * d * pairs, BF16_FLOPS)
    kern = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa
    lib = lambda: torch.autograd.grad(                             # noqa
        lib_out, (qt, kt, vt), lib_dout, retain_graph=True)
    # the device time of a call by kernel (each launches once a call), and
    # SDPA's backward on the device: its event time holds autograd's host work
    split = profile_ms(kern, steps=20, match=FLASH_BWD_KERNELS)
    lib_prof = traced_call(lib, steps=20)
    per = split["matched_per_launch_ms"]
    grids = fa.bwd_plan(fa._bwd_route(bf16, d), b, t, t, h, kvh, d)["grids"]
    times = {"flash_attention_bwd": dict(
        shape=[b, t, h, kvh, d], causal=True, route=fa._bwd_route(bf16, d),
        ms=cuda_ms(kern),
        plain_ms=cuda_ms(lambda: fa_ref.attention_bwd_ref(q, k, v, out, lse,
                                                          dout)),
        library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes, ops=10 * d * pairs,
        device_ms=sum(per[m] for m in FLASH_BWD_KERNELS
                      if split["matched_ms"][m] > 0),
        device_split={m: per[m] for m in FLASH_BWD_KERNELS},
        # each kernel of the plan launches once a call (the tracer can miss
        # launches of a window; a time per launch does not depend on it)
        grids=grids, device_launches=len(grids),
        library_device_ms=lib_prof["device_ms"],
        library_device_launches=lib_prof["kernel_launches"])}
    del q, k, v, dout, out, lse, qt, kt, vt, lib_out, lib_dout
    shapes = {"rmsnorm_bwd": (b * t, cfg.d_model)}
    shapes.update({f"rmsnorm_bwd {r}x{w}": (r, w)
                   for r, w in RMSNORM_BWD_WIDE})
    for name, (rows, dm) in shapes.items():
        plan = rms.bwd_plan(bf16, rows, dm, True)
        times[name] = dict(rmsnorm_bwd_times(rows, dm, g, dev),
                           route=plan.route,
                           grids=[plan.blocks, plan.reduce_blocks])
    log_times("8", times, card)
    r = times["flash_attention_bwd"]
    log(f"[8] flash_attention_bwd {r['route']} route on the device, ms a "
        f"launch: " + ", ".join(f"{m} {ms:.4f}"
                                for m, ms in r["device_split"].items())
        + f"; {r['device_launches']:.0f} device launches a call (grids "
        f"{r['grids']}); SDPA's "
        f"backward {r['library_device_ms']:.4f} ms on the device in "
        f"{r['library_device_launches']:.0f} launches ({card})")
    for name, r in times.items():
        if name.startswith("rmsnorm_bwd"):
            log(f"[8] {name} {r['shape']} bf16, {r['route']} route (grids "
                f"{r['grids']}) on the device, ms a launch: "
                + ", ".join(f"{m} {ms:.5f}"
                            for m, ms in r["device_split"].items())
                + f"; {r['device_ms'] / r['bound_ms']:.2f}x the bound; "
                f"F.rms_norm's autograd backward {r['library_device_ms']:.5f}"
                f" ms on the device in {r['library_device_launches']:.0f} "
                f"launches (" + ", ".join(f"{k} {ms:.5f}" for k, ms
                                          in r["library_split"].items())
                + f") ({card})")
    step = dict(step_ms=step_ms, median_step_ms=med,
                tokens_per_s=tokens / med * 1e3, peak_bytes=peak,
                held_bytes=held)
    return step, prof, times


def cold_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` runs of fn's device time by CUDA events, with
    L2 flushed by a 256 MB write before each run."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rmsnorm_bwd_times(rows, d, gen, dev) -> dict:
    """The RMSNorm backward, its plain version and ``F.rms_norm``'s
    autograd backward at [rows, d] bf16 (x and g drawn from ``gen``, a
    scale of ones), with the bound: the x and g read and dx written once
    over the HBM rate.  The kernel is held against its plain version (bf16
    tolerance, the same bits on a second call) first.  Beside the
    CUDA-event times (operands warm in L2 from the call before; the
    kernel's also with L2 flushed, :func:`cold_ms`): each device launch's
    traced time, the kernel's and the library's (their sum is the device
    time of a call), and host µs a call of both (:func:`host_us` and the
    profiler's CPU self time)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms, ref as rms_ref

    bf16 = torch.bfloat16
    x = _rand((rows, d), gen, bf16, dev)
    gy = _rand((rows, d), gen, bf16, dev)
    sc = torch.ones(d, device=dev)
    kern = lambda: rms.rmsnorm_bwd(x, sc, gy)                 # noqa: E731
    label = f"rmsnorm_bwd [{rows}, {d}] bf16"
    (dx, dsc), want = kern(), rms_ref.rmsnorm_bwd_ref(x, sc, gy)
    err = max(_grad_held(f"{label} {n}", got, w, LM_TOL["bfloat16"])
              for n, got, w in zip(("dx", "dscale"), (dx, dsc), want))
    if not all(torch.equal(a, b) for a, b in zip((dx, dsc), kern())):
        fail(f"{label} gives other bits on a second call")
    xl = x.detach().requires_grad_()
    sl = sc.to(bf16).requires_grad_()
    y = F.rms_norm(xl, (d,), sl, 1e-6)
    lib = lambda: torch.autograd.grad(y, (xl, sl), gy,       # noqa: E731
                                      retain_graph=True)
    n_bytes = 3 * rows * d * 2 + 2 * 4 * d
    b_ms, b_by = bound(n_bytes, 10 * rows * d, FP32_FLOPS)
    split = profile_ms(kern, steps=50, match=RMSNORM_BWD_KERNELS)
    per = {m: split["matched_per_launch_ms"][m] for m in RMSNORM_BWD_KERNELS
           if split["matched_ms"][m] > 0}
    # the library's two kernels launch once a call each: their times a
    # launch, which do not depend on how many launches the tracer saw
    lib_prof = profile_ms(lib, steps=50)
    lib_per = lib_prof["per_launch_ms"]
    (enq_k, end_k), (enq_l, end_l) = host_us(kern), host_us(lib)
    return dict(
        shape=[rows, d], max_abs_err=err, ms=cuda_ms(kern),
        cold_ms=cold_ms(kern),
        plain_ms=cuda_ms(lambda: rms_ref.rmsnorm_bwd_ref(x, sc, gy)),
        library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes, device_ms=sum(per.values()), device_split=per,
        # each kernel launches once a call (the tracer can miss launches of
        # a window; a time per launch does not depend on it)
        device_launches=len(per), library_device_ms=sum(lib_per.values()),
        library_device_launches=len(lib_per), library_split=lib_per,
        host_us=enq_k, host_end_us=end_k, library_host_us=enq_l,
        library_host_end_us=end_l, host_self_us=split["host_self_ms"] * 1e3,
        library_host_self_us=lib_prof["host_self_ms"] * 1e3)


def rmsnorm_bwd_build_report(built) -> dict:
    """Registers and spills of each RMSNorm backward instance (build log),
    and its registers, local memory, static shared memory and blocks an SM
    at the block size of the rows it serves (D 896, 2560 and 5120 in
    vectors; D 1001 and 5121 one element an access), and the dscale
    kernel's → {"route vecN dtype DN" | "dscale": {...}}."""
    import re
    import torch
    from repro_torch.kernels.rmsnorm import ops as rms

    def key(symbol):
        m = re.search(r"rmsnorm_bwd_(warp|block)_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)E", symbol)
        if m:
            dtype = "f32" if m.group(2) == "f" else "bf16"
            return f"{m.group(1)} vec{m.group(3)} {dtype}"
        return "dscale" if "rmsnorm_bwd_dscale_kernel" in symbol else None

    logged = kernel_build_report(built, "rmsnorm_bwd.cu", key)
    report = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in (896, 1001, 2560, 5120, 5121):
            plan = rms.bwd_plan(dtype, 1, d, True)
            for kern, r in rms.bwd_resources(dtype, d).items():
                name = ("dscale" if "dscale" in kern
                        else f"{plan.route} vec{plan.vec} {tag}")
                r = dict(logged.get(name, {}), **r)
                report[name if name == "dscale" else f"{name} D{d}"] = r
                log(f"[8] rmsnorm_bwd {name} at D {d} ({r['threads']} "
                    f"threads a block): {r['registers']} registers, spill "
                    f"stores/loads {r.get('spill_stores', '?')}/"
                    f"{r.get('spill_loads', '?')} bytes, {r['spill_bytes']} "
                    f"bytes of local memory, {r['shared']} bytes of static "
                    f"shared memory, {r['blocks_per_sm']} blocks an SM")
    if len({k.rsplit(" ", 1)[0] for k in report if k != "dscale"}) != 8:
        fail(f"rmsnorm_bwd build report covers {sorted(report)}, not the 8 "
             f"row-kernel instances")
    return report


#: Substrings of the flash backward's device kernels' names (either route).
FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce",
                     "flash_bwd_dq")


def train_path(dev, card, built) -> tuple:
    """qwen2-0.5b training: phase 8 → (kernel rows, launches per kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa

    t_phase = time.perf_counter()
    errs = train_kernel_checks(dev)
    cfg = get_config("qwen2-0.5b")
    log(f"[8] {cfg.name} training at full width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"vocab {cfg.vocab}, {cfg.param_count()} parameters (bf16) with f32 "
        f"AdamW m, v and master; seq_len {TRAIN_T}, global batch {TRAIN_B}, "
        f"{cfg.microbatches} microbatches, remat {cfg.remat}")
    L, m = cfg.n_layers, cfg.microbatches
    step = train_step_check(cfg, dev, card, "8", {
        "flash_attention": 2 * L * m, "flash_mma": 2 * L * m,
        "flash_attention_bwd": L * m, "flash_bwd_mma": L * m,
        "rmsnorm": (4 * L + 1) * m, "rmsnorm_bwd": (2 * L + 1) * m})
    runs = trainer_runs("8", cfg, card)
    timing, prof, times = train_times(cfg, dev, card)
    builds = {"flash_attention_bwd": {
        f"{fa._bwd_route(dt, d)} d{d}": fa.bwd_resources(dt, d)
        for dt in (torch.float32, torch.bfloat16) for d in fa.HEAD_DIMS},
        "rmsnorm_bwd": rmsnorm_bwd_build_report(built)}
    for key, kernels in builds["flash_attention_bwd"].items():
        log(f"[8] flash backward {key} (shared bytes, registers, spill "
            f"bytes): " + "; ".join(
                f"{n} {r['shared']}, {r['registers']}, {r['spill_bytes']}"
                for n, r in kernels.items()))
    log("train " + json.dumps({
        "card": card, "model": cfg.name, "seq_len": TRAIN_T,
        "global_batch": TRAIN_B, "microbatches": cfg.microbatches,
        "step": step, "trainer": runs, "timing": timing,
        "profile": prof, "kernels": times, "max_abs_err": errs,
        "build": builds, "phase_s": time.perf_counter() - t_phase}))
    rows = []
    for name, src in (("flash_attention_bwd",
                       "src/repro_torch/csrc/flash_attention_bwd.cu"),
                      ("rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm_bwd.cu")):
        r = times[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=REPLACES[name],
            launches=step["launches"][name], max_abs_err=errs[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"qwen2-0.5b train {r['shape']} bf16"))
    launches = {k: step["launches"][k]
                for k in ("flash_attention", "rmsnorm")}
    return rows, launches


# ---------------------------------------------------------------------------
# 9. train mamba2-2.7b: the SSD backward, a step on both backends, the
#    trainer with a failure and its replay
# ---------------------------------------------------------------------------

#: The failure-and-replay pair of trainer runs of mamba2-2.7b runs at full
#: width and this depth: at 64 layers one checkpoint is ~38 GB of .npy
#: (bf16 parameters, f32 master, m and v), copied to host memory
#: synchronously, and the run writes two (steps 4 and 8).
SSM_REPLAY_LAYERS = 8
#: mamba2-2.7b's trainer runs take the optimizers' own default learning
#: rate (``optim.make_optimizer``, as the reference's), not the launcher's
#: 3e-3, at which the 64-layer loss rises over 8 steps on the kernels and
#: on their plain versions alike (11.34 to a peak of 18.4-18.5 at step 3;
#: PERF.md §6).
SSM_LR = 3e-4
#: SSD backward cases (b, t, h, p, g, n, label): the training shape, a
#: ragged T, two groups and the prefill shape.
SSD_BWD_CASES = (
    (TRAIN_B // 4, TRAIN_T, 80, 64, 1, 128, "the training shape T=1024"),
    (2, 1000, 80, 64, 1, 128, "ragged T=1000"),
    (2, 512, 80, 64, 2, 128, "G=2 T=512"),
    (SSM_B, SSM_T, 80, 64, 1, 128, "the prefill shape T=4096"))
#: Substrings of the SSD backward's device kernels' names: the forward's
#: passes 1-3 (the recompute), then the "fma" route's five (float32) and
#: the "mma" route's six (bfloat16).
SSD_BWD_KERNELS = ("ssd_chunk_state_kernel", "ssd_cb_kernel",
                   "ssd_state_pass_kernel", "ssd_bwd_chunk_out_kernel",
                   "ssd_bwd_state_kernel", "ssd_bwd_state_side_kernel",
                   "ssd_bwd_diag_kernel", "ssd_bwd_reduce_kernel",
                   "ssd_bwd_chunk_out_mma_kernel",
                   "ssd_bwd_state_slices_kernel",
                   "ssd_bwd_state_side_mma_kernel", "ssd_bwd_diag_mma_kernel",
                   "ssd_bwd_group_kernel", "ssd_bwd_reduce_slices_kernel")


def ssd_bwd_ops_count(b, t, h, p, g, n, chunk) -> float:
    """Operations that the SSD backward needs for these shapes, counted on
    the least work its decomposition allows: the recompute (cum and each
    chunk's state per head, C Bᵀ's lower triangle per group, the carry),
    the inter-chunk term (dS_local, dC, dcum), the reverse state pass, the
    chunk state's terms (du, dB, dcum), the intra-chunk term over the lower
    triangle (per head dM, du, L, C Bᵀ ⊙ L, dCB, its share of dcum and the
    sum of dCB over the group's heads; per group dC and dB from that sum),
    dx, ddt and dA's terms, and dA's sum over the chunks.  The per-head dB
    and dC of the inter-chunk and state terms sum over a group's heads in
    the same multiply-adds that form them.  The bf16 kernel ("mma") does
    more than this count: each float32 operand of a product is two bf16
    products, C S_prevᵀ is formed per head for dcum, and the group pass's
    per-head products run over the whole chunk; the f32 kernel ("fma")
    forms the diag's dB and dC per head and sums them in its reduce
    pass."""
    q_list = [min(chunk, t - s) for s in range(0, t, chunk)]
    ops = 0.0
    for i, q in enumerate(q_list):
        tri = q * (q + 1) // 2
        carry = 2 * p * n if i + 1 < len(q_list) else 0
        ops += b * h * (2 * q * p * n + 2 * q + carry)        # recompute
        ops += b * g * 2 * tri * n                             # C Bᵀ
        ops += b * h * (4 * q * p * n + 2 * q * n + q * p)     # chunk out
        ops += b * h * 3 * p * n                               # state
        ops += b * h * (4 * q * p * n + 2 * q * n + q * p)     # state side
        ops += b * h * tri * (4 * p + 7) + b * g * tri * 4 * n  # diag
        ops += b * h * (3 * q * p + 4 * q)                     # dx, ddt, dA
    ops += b * h * len(q_list)                                 # dA's sum
    return ops


def ssd_bwd_bytes(b, t, h, p, g, n, elem) -> float:
    """x and dY read and dx written, dt read and ddt written (float32), A
    read and dA written, b and c read and db, dc written: each once."""
    return 3 * b * t * h * p * elem + 2 * b * t * h * 4 + 2 * h * 4 \
        + 4 * b * t * g * n * elem


def ssd_bwd_pass_checks(x, dt, a, bm, cm, dy, tol) -> dict:
    """Each pass of the SSD backward's route for x's dtype against its
    plain pass on the same inputs (the plain passes' outputs feed the next
    kernel pass), and the same bits on a second run → {pass: max abs
    error}."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref

    q = min(256, x.shape[1])
    cum, states = ssd_ref._chunk_state_ref(x, dt, a, bm, chunk=q)
    cb = ssd_ref._cb_ref(bm, cm, chunk=q)
    prev = ssd_ref._state_pass_ref(states, cum)
    dtc = ssd_ref._dt_chunks(dt, q)
    del states
    errs = {}

    def held(name, run, want):
        got = run()
        torch.cuda.synchronize()
        errs[name] = max(_grad_held(f"ssd_bwd {name} pass", g, w, tol)
                         for g, w in zip(got, want))
        if not all(torch.equal(u, v) for u, v in zip(got, run())):
            fail(f"ssd_bwd {name} pass gives other bits on a second run")

    if ssd._bwd_route(x.dtype) == "mma":
        want = ssd_ref._bwd_chunk_out_mma_ref(dy, cm, cum, prev, chunk=q)
        held("chunk_out_mma", lambda: ssd._bwd_chunk_out_mma(
            dy, cm, cum, prev, chunk=q), want)
        dsl, dcum = want
        want = ssd_ref._bwd_state_slices_ref(dsl, prev, cum)
        held("state_slices", lambda: ssd._bwd_state_slices(dsl, prev, cum),
             want)
        ds, part = want
        del dsl
        want = ssd_ref._bwd_state_side_mma_ref(x, dt, bm, cum, ds, dcum,
                                               part, chunk=q)
        held("state_side_mma", lambda: ssd._bwd_state_side_mma(
            x, dtc, bm, cum, ds, dcum, part, chunk=q), want)
        du, dcum, dtot = want
        want = ssd_ref._bwd_diag_mma_ref(x, dt, a, dy, cb, cum, du, dcum,
                                         dtot, chunk=q)
        held("diag_mma", lambda: ssd._bwd_diag_mma(
            x, dtc, a, bm, dy, cb, cum, du, dcum, dtot, chunk=q), want)
        _, _, da, dcb = want
        del want, du
        want = ssd_ref._bwd_group_ref(x, dt, bm, cm, dy, cum, prev, ds, dcb,
                                      chunk=q)
        held("group", lambda: ssd._bwd_group(x, dtc, bm, cm, dy, cum, prev,
                                             ds, dcb, chunk=q), want)
        pdb, pdc = want
        t = x.shape[1]
        held("reduce_slices", lambda: ssd._bwd_reduce_slices(
            pdb, pdc, da, t, x.dtype),
            ssd_ref._bwd_reduce_slices_ref(pdb, pdc, da, t))
        return errs
    want = ssd_ref._bwd_chunk_out_ref(dy, cm, cum, prev, chunk=q)
    held("chunk_out", lambda: ssd._bwd_chunk_out(dy, cm, cum, prev, chunk=q),
         want)
    dsl, dc, dcum = want
    want = ssd_ref._bwd_state_ref(dsl, prev, cum)
    held("state", lambda: ssd._bwd_state(dsl, prev, cum), want)
    ds, dtot = want
    del dsl, prev
    want = ssd_ref._bwd_state_side_ref(x, dt, bm, cum, ds, dcum, dtot,
                                       chunk=q)
    held("state_side", lambda: ssd._bwd_state_side(x, dtc, bm, cum, ds, dcum,
                                                   dtot, chunk=q), want)
    du, db, dcum, dtot = want
    del ds
    want = ssd_ref._bwd_diag_ref(x, dt, a, bm, cm, dy, cb, cum, du, db, dc,
                                 dcum, dtot, chunk=q)
    held("diag", lambda: ssd._bwd_diag(x, dtc, a, bm, cm, dy, cb, cum, du,
                                       db, dc, dcum, dtot, chunk=q), want)
    _, _, da, db, dc = want
    g, t = bm.shape[2], x.shape[1]
    held("reduce", lambda: ssd._bwd_reduce(db, dc, da, g, t, x.dtype),
         ssd_ref._bwd_reduce_ref(db, dc, da, g, t))
    return errs


def ssd_bwd_checks(dev) -> tuple:
    """The SSD backward, and each of its passes, against its plain version
    on the card (``SSD_BWD_CASES``, f32 through the "fma" route and bf16
    through "mma", tolerance tol x max|g| + tol x |g| with the scan's tol),
    the same bits on a second call, one launch counted a call on the
    dtype's route → (max abs error, {case: per-pass errors})."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref

    gen = torch.Generator(device=dev).manual_seed(10)
    worst, per_pass = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = SSD_TOL[str(dtype).split(".")[1]]
        for b, t, h, p, g, n, label in SSD_BWD_CASES:
            x, dt, a, bm, cm = _ssd_operands((b, t, h, p, g, n), dtype, gen,
                                             dev)
            dy = _rand((b, t, h, p), gen, dtype, dev)
            ssd.reset_backward_launch_counts()
            ssd.reset_backward_route_counts()
            got = ssd.ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=256)
            torch.cuda.synchronize()
            route = "mma" if dtype == torch.bfloat16 else "fma"
            if ssd.backward_launch_counts() != {"ssd_bwd": 1} or \
                    ssd.backward_route_counts() != {
                        r: int(r == route) for r in ssd.BWD_ROUTES}:
                fail(f"ssd_bwd {label} {dtype}: launch counts "
                     f"{ssd.backward_launch_counts()}, by route "
                     f"{ssd.backward_route_counts()} (want one on {route})")
            want = ssd_ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk=256)
            err = max(_grad_held(f"ssd_bwd {label} {dtype} {nm}", u, w, tol)
                      for nm, u, w in zip(("dx", "ddt", "dA", "db", "dc"),
                                          got, want))
            if not all(torch.equal(u, v) for u, v in zip(
                    got, ssd.ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=256))):
                fail(f"ssd_bwd {label} {dtype} gives other bits on a second "
                     f"call")
            del got, want
            torch.cuda.empty_cache()
            errs = ssd_bwd_pass_checks(x, dt, a, bm, cm, dy, tol)
            per_pass[f"{label} {dtype}"] = dict(errs, all=err)
            log(f"[9] ssd_bwd {label} {[b, t, h, p, g, n]} {dtype} on "
                f"\"{route}\": dx/ddt/dA"
                f"/db/dc max abs err {err:.3e} (tolerance {tol} x max|g| + "
                f"{tol} x |g|), same bits twice; passes against their plain "
                f"passes: " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs.items()))
            worst = max(worst, err)
            del x, dt, a, bm, cm, dy
            torch.cuda.empty_cache()
    return worst, per_pass


def ssd_bwd_build_report(built) -> dict:
    """Registers and spills of each SSD backward pass (build log; the fma
    passes are built for f32, the mma passes for bf16), its dynamic shared
    memory, registers, local bytes and blocks an SM, and its HMMA count →
    {"route pass": {...}}; fails where a pass spills."""
    from repro_torch.kernels.ssd import ops as ssd

    names = [n for r in ssd.BWD_ROUTES for n in ssd.BWD_PASSES[r]]

    def key(symbol):
        for name in sorted(names, key=len, reverse=True):
            if f"ssd_bwd_{name}_kernel" in symbol:
                return name
        return None

    logged = kernel_build_report(built, "ssd_bwd.cu", key)
    report = {}
    for route in ssd.BWD_ROUTES:
        for name in ssd.BWD_PASSES[route]:
            k = f"{route} {name}"
            r = report[k] = dict(logged.get(name, {}),
                                 **ssd.bwd_resources(name))
            log(f"[9] ssd_bwd pass {k}: {r['registers']} registers, spill "
                f"stores/loads {r.get('spill_stores', '?')}/"
                f"{r.get('spill_loads', '?')} bytes, {r['local_bytes']} "
                f"bytes of local memory, {r['smem_bytes']} bytes of dynamic "
                f"shared memory a block, {r['blocks_per_sm']} blocks an SM, "
                f"{r.get('hmma', '?')} HMMA")
            if r.get("spill_stores") or r["local_bytes"]:
                fail(f"ssd_bwd pass {k} spills registers: {r}")
    return report


def ssd_bwd_workspace_report() -> dict:
    """The float32 scratch bytes of one SSD backward call on each route at
    each ``SSD_BWD_CASES`` shape (beyond the recompute's buffers) →
    {"route label": bytes}; fails where the "mma" route holds a per-head
    [B, H, nc, Q, N] buffer."""
    from repro_torch.kernels.ssd import ops as ssd

    out = {}
    for b, t, h, p, g, n, label in SSD_BWD_CASES:
        nc = -(-t // 256)
        for route in ssd.BWD_ROUTES:
            shapes = ssd.bwd_workspace(route, b, t, h, p, g, n, 256)
            if route == "mma" and (b, h, nc, min(256, t), n) in \
                    shapes.values():
                fail(f"ssd_bwd mma scratch holds a per-head buffer: {shapes}")
            out[f"{route} {label}"] = sum(4 * math.prod(v)
                                          for v in shapes.values())
    log("[9] ssd_bwd float32 scratch a call: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in out.items()))
    return out


def ssd_bwd_times(cfg, dev, card) -> dict:
    """The SSD backward at the training shape (one microbatch), bf16: its
    time by events, each device launch's traced time (the recompute's three
    and its route's own), host µs a call, its plain version's time and its
    bound; no single PyTorch call computes it (library "none").  Uses only
    what every version of the wrapper has, so that
    examples/ssd_bwd_torch.py can time an earlier checkout with it."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd, ref as ssd_ref

    bf16 = torch.bfloat16
    case = (TRAIN_B // cfg.microbatches, TRAIN_T, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state)
    gen = torch.Generator(device=dev).manual_seed(11)
    x, dt, a, bm, cm = _ssd_operands(case, bf16, gen, dev)
    dy = _rand(case[:4], gen, bf16, dev)
    kern = lambda: ssd.ssd_scan_bwd(x, dt, a, bm, cm, dy,  # noqa: E731
                                    chunk=cfg.ssm_chunk)
    n_bytes = ssd_bwd_bytes(*case, 2)
    n_ops = ssd_bwd_ops_count(*case, cfg.ssm_chunk)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS)
    split = profile_ms(kern, steps=20, match=SSD_BWD_KERNELS)
    per = {k: v for k, v in split["matched_per_launch_ms"].items()
           if split["matched_ms"][k] > 0}
    enqueue_us, done_us = host_us(kern, calls=200)
    r = dict(shape=list(case), chunk=cfg.ssm_chunk, ms=cuda_ms(kern),
             plain_ms=cuda_ms(lambda: ssd_ref.ssd_scan_bwd_ref(
                 x, dt, a, bm, cm, dy, chunk=cfg.ssm_chunk), reps=5),
             library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
             ops=n_ops, device_split=per, device_ms=sum(per.values()),
             host_us=enqueue_us, host_done_us=done_us,
             fp32_cuda_core_ms=n_ops / FP32_FLOPS * 1e3)
    log(f"[9] ssd_bwd {list(case)} bf16: a call {r['ms']:.4f} ms by events, "
        f"{r['device_ms']:.4f} ms on the device in {len(per)} "
        f"launches ("
        + ", ".join(f"{k} {v:.4f}" for k, v in r["device_split"].items())
        + f" ms a launch); plain {r['plain_ms']:.3f} ms; bound "
        f"{b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.2f} GFLOP on the bf16 tensor cores; "
        f"{r['fp32_cuda_core_ms']:.3f} ms at the CUDA cores' fp32 rate); "
        f"host {enqueue_us:.1f} µs a call to enqueue, {done_us:.1f} to the "
        f"end of the device's work; library none ({card})")
    return r


def ssm_train_times(cfg, dev, card) -> tuple:
    """mamba2-2.7b's step by CUDA events (median of steps 3-8 of 8), its
    tokens/s and peak memory, one step traced (device busy share, kernel
    launches, the SSD backward's share of the device time)."""
    import torch
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.launch import steps as ST
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import params as P

    step_fn, opt = ST.build_train_step(cfg, seq_len=TRAIN_T,
                                       global_batch=TRAIN_B, lr=SSM_LR,
                                       device=dev, backend="cuda")
    params = P.init_tree(Z.spec(cfg), torch.Generator(device=dev)
                         .manual_seed(0), dev)
    state = opt.init(params)
    pipe = DataPipeline(SyntheticLM(cfg.vocab, 0), global_batch=TRAIN_B,
                        seq_len=TRAIN_T)
    try:
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in pipe._make_batch(i).items()}
                   for i in range(TRAIN_STEPS + 1)]
    finally:
        pipe.close()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, metrics = step_fn(params, state, batches[i])
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[2:])
    tokens = TRAIN_B * TRAIN_T
    prof = profile_ms(lambda: step_fn(params, state, batches[TRAIN_STEPS]),
                      steps=1, warmup=False,
                      match=("ssd_bwd", "ssd_", "rmsnorm_bwd", "rmsnorm_",
                             "gemm", "Kernel2") + SSD_BWD_KERNELS)
    sb, sa = prof["matched_ms"]["ssd_bwd"], prof["matched_ms"]["ssd_"]
    log(f"[9] {cfg.name} train step on the kernels: "
        f"{[round(x, 3) for x in step_ms]} ms by events; median of steps "
        f"3-{TRAIN_STEPS} {med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s; "
        f"peak device memory {peak / 1e9:.2f} GB, {held / 1e9:.2f} GB of it "
        f"held before the first step ({card})")
    log(f"[9] the SSD backward's own passes in the traced step: "
        f"{sb:.3f} ms of {prof['device_ms']:.3f} ms on the device "
        f"({100 * sb / max(prof['device_ms'], 1e-9):.1f}%); every SSD kernel "
        f"(the forward, its remat and the backward's recompute too) "
        f"{sa:.3f} ms ({100 * sa / max(prof['device_ms'], 1e-9):.1f}%); "
        f"device busy {100 * prof['busy_share']:.1f}%, "
        f"{prof['kernel_launches']:.0f} kernel launches a step; by kernel: "
        + ", ".join(f"{m} {prof['matched_ms'][m]:.3f} ms"
                    for m in SSD_BWD_KERNELS if prof['matched_ms'][m] > 0)
        + f" ({card})")
    log_profiles("9", cfg.name, {"train step": prof}, card)
    del params, state, batches
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, median_step_ms=med,
                tokens_per_s=tokens / med * 1e3, peak_bytes=peak,
                held_bytes=held, ssd_bwd_device_ms=sb,
                ssd_all_device_ms=sa), prof


def ssm_train_path(dev, card, built) -> tuple:
    """mamba2-2.7b training: phase 9 → (kernel rows, launches per kernel)."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    err, per_pass = ssd_bwd_checks(dev)
    build = ssd_bwd_build_report(built)
    workspace = ssd_bwd_workspace_report()
    cfg = get_config("mamba2-2.7b")
    log(f"[9] {cfg.name} training at full width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab}, {cfg.param_count()} parameters (bf16) with f32 "
        f"AdamW m, v and master; seq_len {TRAIN_T}, global batch {TRAIN_B}, "
        f"{cfg.microbatches} microbatches, remat {cfg.remat}")
    L, m = cfg.n_layers, cfg.microbatches
    step = train_step_check(cfg, dev, card, "9", {
        "ssd": 2 * L * m, "ssd_bwd": L * m, "rmsnorm": (4 * L + 1) * m,
        "rmsnorm_bwd": (2 * L + 1) * m})
    meminfo = Path("/proc/meminfo").read_text().split("\n")[:3]
    ckpt_gb = cfg.param_count() * (2 + 4 + 4 + 4) / 1e9
    log(f"[9] one {cfg.n_layers}-layer checkpoint holds ~{ckpt_gb:.1f} GB "
        f"(bf16 parameters, f32 master, m, v), the failure run writes two "
        f"and copies each to host memory first; host {'; '.join(meminfo)}: "
        f"the failure and replay run at {SSM_REPLAY_LAYERS} layers")
    runs = trainer_runs("9", cfg, card, replay_layers=SSM_REPLAY_LAYERS,
                        lr=SSM_LR)
    timing, prof = ssm_train_times(cfg, dev, card)
    times = {"ssd_bwd": ssd_bwd_times(cfg, dev, card)}
    log("train " + json.dumps({
        "card": card, "model": cfg.name, "seq_len": TRAIN_T,
        "global_batch": TRAIN_B, "microbatches": m, "step": step,
        "trainer": runs, "timing": timing, "profile": prof, "kernels": times,
        "max_abs_err": {"ssd_bwd": err}, "ssd_bwd_passes": per_pass,
        "build": {"ssd_bwd": build}, "ssd_bwd_workspace_bytes": workspace,
        "phase_s": time.perf_counter() - t_phase}))
    r = times["ssd_bwd"]
    rows = [dict(name="ssd_bwd", route="cuda", source=SOURCES["ssd_bwd"],
                 replaces=REPLACES["ssd_bwd"],
                 launches=step["launches"]["ssd_bwd"], max_abs_err=err,
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=None,
                 shape=f"mamba2-2.7b train {r['shape']} bf16")]
    launches = {k: step["launches"][k]
                for k in ("ssd", "rmsnorm", "rmsnorm_bwd")}
    return rows, launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {torch.cuda.get_device_name(0)} ({card}); TF32 off")

    t0 = time.perf_counter()
    built = build_all()
    rows = dse_path(dev, card, built)
    lm_rows, lm_launches = lm_path(dev, card, built)
    rms_row = lm_rows[1]
    ssm_rows, ssm_launches, rms_row["max_abs_err"] = ssm_path(
        dev, card, rms_row["max_abs_err"], built)
    train_rows, train_launches = train_path(dev, card, built)
    ssm_train_rows, ssm_train_launches = ssm_train_path(dev, card, built)
    for row in lm_rows + ssm_rows:
        row["launches"] = (lm_launches[row["name"]] + ssm_launches[row["name"]]
                           + train_launches.get(row["name"], 0)
                           + ssm_train_launches.get(row["name"], 0))
    for row in train_rows:
        row["launches"] += ssm_train_launches.get(row["name"], 0)
    rows += lm_rows + ssm_rows + train_rows + ssm_train_rows
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
