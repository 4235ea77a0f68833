#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each fatal on any error:

1. build the count-terms kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold each kernel against its plain torch version on the card, on the
   operands the engine gives it at ``extended_grid()`` and ``mega_grid()``
   x 18 networks (max relative error <= 1e-12, atol 0, zeros exact);
3. drive the main path through the port's entry points — the batched
   engine (aggregate, per-layer, chunked mega), the quickstart steps and
   the §IV.A chip — with the launch counts set to 0 just before and read
   just after; then check its outputs against the plain path on the card
   and, for the quickstart and the chip, against a CPU run;
4. time each kernel and its plain version with CUDA events, and the
   engine end to end, and print the ``kernels`` lines.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a card, or away from the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RTOL = 1e-12
REPS = 10

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 34 TFLOP/s FP64 outside the
# tensor cores (the count-terms arithmetic is scalar FP64).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

REPLACES = {
    "count_terms": "src/repro/kernels/count_terms/kernel.py:99",
    "count_layers": "src/repro/kernels/count_terms/kernel.py:146",
}


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


def wall_ms(fn, reps: int = REPS) -> float:
    """Median host wall time of fn, which ends on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ops_per_pair() -> float:
    """Elementwise operations of the plain count-terms program for one
    (config row, layer) pair, counted on a small CPU input: every aten op
    whose output covers the whole [n_u, L] tile counts once (a floor
    division is one operation here, so the bound is a lower bound)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import accelerator, energymodel, topology
    from repro_torch.kernels.count_terms import ref

    lay_np, _ = energymodel._stack_networks(
        {"AlexNet": topology.get_network("AlexNet")})
    lay = {k: torch.as_tensor(v)[None, :] for k, v in lay_np.items()}
    _, cfg_u, _, _, _ = energymodel._prepare_fields(
        accelerator.ConfigGrid.product().fields, torch.device("cpu"), "cuda")
    n_u, n_l = cfg_u["rows"].shape[0], lay["m"].shape[1]
    skip = ("view", "expand", "unsqueeze", "stack", "cat", "select", "slice",
            "clone", "copy", "empty", "ones_like", "zeros_like", "lift",
            "detach", "_to_copy", "alias", "as_strided", "unbind", "sum")
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__
            if (isinstance(out, torch.Tensor) and out.numel() == n_u * n_l
                    and not any(s in name for s in skip)):
                count[0] += 1
            return out

    with Count():
        ref.count_term_layers_ref(cfg_u, lay)
    return float(count[0])


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
    import numpy as np
    from repro_torch.core import (accelerator, dse, energymodel as em,
                                  hetero, partition, topology)
    from repro_torch.kernels.count_terms import ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {torch.cuda.get_device_name(0)} ({card})")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, build_log = ops.build()
    ops._lib()
    log(f"[1] built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            log(f"    {line.strip()}")

    nets = {n: topology.get_network(n) for n in topology.NETWORKS}
    grids = {"extended": accelerator.extended_grid(),
             "mega": accelerator.mega_grid()}
    lay_np, seg = em._stack_networks(nets)
    lay = {k: torch.as_tensor(v).to(dev)[None, :] for k, v in lay_np.items()}
    n_l, n_net = lay["m"].shape[1], len(seg)

    def operands(fields):
        return em._prepare_fields(fields, dev, "cuda")[1]

    kernels = {
        "count_terms": (lambda c: ops.count_term_sums(c, lay, seg),
                        lambda c: ref.count_term_sums_ref(c, lay, seg)),
        "count_layers": (lambda c: ops.count_term_layers(c, lay),
                         lambda c: ref.count_term_layers_ref(c, lay)),
    }

    # ---- 2. kernels against their plain versions on the card --------------
    per_grid = {k: {} for k in kernels}
    for gname, grid in grids.items():
        cfg_u = operands(grid.fields)
        n_u = cfg_u["rows"].shape[0]
        for kname, (kern, plain) in kernels.items():
            out = torch.stack(kern(cfg_u))
            torch.cuda.synchronize()
            want = plain(cfg_u)
            torch.cuda.synchronize()
            diff = (out - want).abs()
            rel = float((diff / want.abs().clamp_min(1e-300)).max())
            zeros = bool(((out == 0) == (want == 0)).all())
            exact = float((out == want).double().mean())
            finite = bool(torch.isfinite(out).all())
            per_grid[kname][gname] = dict(
                n_u=n_u, shape=list(out.shape), max_rel_err=rel,
                max_abs_err=float(diff.max()), exact_share=exact)
            log(f"[2] {kname} at {gname} {tuple(out.shape)}: max_rel_err "
                f"{rel:.3e}, zeros match {zeros}, bit-equal share {exact}")
            if not (rel <= RTOL and zeros and finite):
                fail(f"{kname} disagrees with its plain version at {gname}")
            del out, want, diff
            torch.cuda.empty_cache()

    # ---- 3. main path --------------------------------------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    e_ext, t_ext = em.evaluate_networks(grids["extended"], nets)
    e_pl, t_pl = em.evaluate_networks(grids["extended"], nets, per_layer=True)
    e_mega, t_mega = em.evaluate_networks(grids["mega"], nets,
                                          chunk_size=9800)
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
    log(f"[3] main path in {time.perf_counter() - t0:.1f} s: backend "
        f"{backend}, launches {launches}")
    if backend != "cuda":
        fail(f"main path ran on backend {backend!r}")
    if not all(launches[k] > 0 for k in kernels):
        fail(f"a kernel of the main path was never launched: {launches}")

    n_e, n_m = grids["extended"].n, grids["mega"].n
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
    e_plain, t_plain = em.evaluate_networks(grids["extended"], nets,
                                            device=dev, backend="torch")
    np.testing.assert_allclose(e_ext, e_plain, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_ext, t_plain, rtol=RTOL, atol=0)
    sub = np.arange(0, n_m, 7)
    e_sub, t_sub = em.evaluate_networks(grids["mega"].take(sub), nets,
                                        device=dev, backend="torch")
    np.testing.assert_allclose(e_mega[sub], e_sub, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_mega[sub], t_sub, rtol=RTOL, atol=0)
    log("[3] engine outputs finite, of the expected shapes, per-layer sums "
        "= aggregate, cuda = plain torch on the card (rtol 1e-12)")

    report_cpu = em.simulate_network(cfg, nets["ResNet50"], "ResNet50",
                                     device="cpu")
    np.testing.assert_allclose(report.layer_latencies,
                               report_cpu.layer_latencies, rtol=RTOL)
    if partition.partition_network(report_cpu, 3) != part:
        fail("Algorithm II split differs between the card and the CPU")
    log(f"[3] quickstart: ResNet50 {cfg.label()} energy {report.energy:.6e} "
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
    log(f"[3] §IV.A chip (same on card and CPU): "
        f"{[chip.core_label(i) for i in range(len(chip.core_types))]}; "
        f"savings vs worst single core: energy up to {max(es):.1f}% "
        f"(mean {np.mean(es):.1f}%), EDP up to {max(ed):.1f}% "
        f"(mean {np.mean(ed):.1f}%)  [paper: up to 36% / 67%]")

    # ---- 4. times --------------------------------------------------------------
    flops_pair = ops_per_pair()
    for gname, grid in grids.items():
        cfg_u = operands(grid.fields)
        n_u = cfg_u["rows"].shape[0]
        in_bytes = (len(ops.CFG_COLUMNS) * n_u + len(ops.LAYER_FIELDS) * n_l) * 8
        for kname, (kern, plain) in kernels.items():
            if kname == "count_terms":
                out_bytes = 14 * n_u * n_net * 8 + 2 * n_net * 8
                flops = (flops_pair + 14) * n_u * n_l
            else:
                out_bytes = 14 * n_u * n_l * 8
                flops = flops_pair * n_u * n_l
            t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP64_FLOPS * 1e3
            k_ms = cuda_ms(lambda: kern(cfg_u))
            p_ms = cuda_ms(lambda: plain(cfg_u))
            per_grid[kname][gname].update(
                kernel_ms=k_ms, plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=in_bytes + out_bytes, fp64_ops=flops)
            log(f"[4] {kname} at {gname}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                f"({per_grid[kname][gname]['bound_by']})")
            torch.cuda.empty_cache()

    # end to end: host wall time, and the kernel's device time on the
    # operands of each chunk the call launches it on
    e2e = {}
    for gname, chunk in (("extended", None), ("mega", 9800)):
        grid = grids[gname]
        w_ms = wall_ms(lambda: em.evaluate_networks(grid, nets,
                                                    chunk_size=chunk))
        step = chunk or grid.n
        k_ms = 0.0
        for start in range(0, grid.n, step):
            fc = {k: v[start:start + step] for k, v in grid.fields.items()}
            c = operands(fc)
            k_ms += cuda_ms(lambda: ops.count_term_sums(c, lay, seg))
        e2e[gname] = dict(wall_ms=w_ms, kernel_ms=k_ms,
                          kernel_share=k_ms / w_ms, chunk_size=chunk)
        log(f"[4] evaluate_networks at {gname} x 18 (chunk {chunk}): wall "
            f"{w_ms:.2f} ms, count_terms kernel {k_ms:.4f} ms = "
            f"{100 * k_ms / w_ms:.2f}% of it")

    log("kernels " + json.dumps({"card": card, "grids": per_grid,
                                 "launches": launches,
                                 "evaluate_networks": e2e}))
    log(card)
    contract = []
    for kname in kernels:
        ext = per_grid[kname]["extended"]
        contract.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/csrc/count_terms.cu",
            replaces=REPLACES[kname], launches=launches[kname],
            max_abs_err=max(g["max_abs_err"] for g in per_grid[kname].values()),
            max_rel_err=max(g["max_rel_err"] for g in per_grid[kname].values()),
            ms=ext["kernel_ms"], plain_ms=ext["plain_ms"],
            bound_ms=ext["bound_ms"], bound_by=ext["bound_by"],
            library_ms=None, shape="extended_grid x 18 networks"))
    log(json.dumps({"kernels": contract}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
