"""The port stands alone: ``repro_torch`` imports with JAX absent and loads
nothing of the ``repro`` package, and no code path moves to the CPU or to
a plain version when the card or a kernel is missing."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import accelerator, dse, energymodel, topology
from repro_torch.kernels import _build
from repro_torch.kernels.count_terms import ops

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_imports_without_jax_and_without_repro():
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"          # any `import jax` now raises
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "      if k == 'repro' or k.startswith(('repro.', 'jax')))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == ["jax"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    grid = accelerator.ConfigGrid.product()
    nets = {"AlexNet": topology.get_network("AlexNet")}
    for call in (lambda: energymodel.evaluate_networks(grid, nets),
                 lambda: energymodel.evaluate_networks(grid, nets,
                                                       device="cuda"),
                 lambda: energymodel.simulate_network(
                     accelerator.AcceleratorConfig(), nets["AlexNet"]),
                 lambda: dse.sweep_networks(nets),
                 lambda: dse.layer_metrics(nets)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_serving_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.serving import ServeEngine

    cfg = get_config("qwen2-0.5b").smoke()
    model = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for call in (lambda: ServeEngine(cfg, model),
                 lambda: ServeEngine(cfg, model, device="cuda"),
                 lambda: serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ServeEngine(cfg, model, device="cpu", backend="cuda")


#: The fault layer and the DSE service: each imports with jax absent and
#: nothing of ``repro`` (the two tests above walk every module).
SERVICE_MODULES = ("repro_torch.ft.faults", "repro_torch.ft.verify",
                   "repro_torch.serving.store",
                   "repro_torch.serving.dse_service",
                   "repro_torch.launch.serve_dse")


def test_service_modules_are_walked():
    assert set(SERVICE_MODULES) <= set(_modules())
    assert {PKG.parent / (m.replace(".", "/") + ".py")
            for m in SERVICE_MODULES} <= set(PORT_FILES)


def test_dse_service_entry_points_raise_without_a_card(no_card):
    from repro_torch.launch import serve_dse
    from repro_torch.serving import DSEService

    grid = accelerator.ConfigGrid.product()
    nets = {"AlexNet": topology.get_network("AlexNet")}
    for call in (lambda: DSEService(grid, nets),
                 lambda: DSEService(grid, nets, device="cuda"),
                 lambda: serve_dse.main(["--requests", "1"]),
                 lambda: energymodel.evaluate_networks(grid, nets,
                                                       shard=True),
                 lambda: energymodel.stream_layer_topk(grid, nets,
                                                       shard=True)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        DSEService(grid, nets, device="cpu", backend="cuda")


def test_cuda_backend_on_cpu_raises():
    grid = accelerator.ConfigGrid.product()
    nets = {"AlexNet": topology.get_network("AlexNet")}
    before = energymodel.last_backend()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        energymodel.evaluate_networks(grid, nets, device="cpu",
                                      backend="cuda")
    assert energymodel.last_backend() == before


def test_missing_kernel_raises_instead_of_falling_back(monkeypatch):
    """A CUDA operand whose kernel cannot be built raises out of the
    wrapper; nothing retries on the plain version."""
    grid = accelerator.ConfigGrid.product()
    lay, segments = energymodel._stack_networks(
        {"AlexNet": topology.get_network("AlexNet")})
    lay = {k: torch.as_tensor(v)[None, :] for k, v in lay.items()}
    cfg_m, cfg_u, inv_m, _, _ = energymodel._prepare_fields(
        grid.fields, torch.device("cpu"))

    def not_built():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(ops, "_device_of",
                        lambda *a: torch.device("cuda"))
    monkeypatch.setattr(ops, "_lib", not_built)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.count_term_sums(segments, cfg_m, cfg_u, lay, inv_m)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.count_term_layers(cfg_u, lay)
    assert ops.launch_counts() == {"count_terms": 0, "count_layers": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.build()


def test_wrappers_reject_other_devices():
    cfg_u = {k: torch.ones(3, 1, dtype=torch.float64, device="meta")
             for k in ops.CFG_COLUMNS}
    lay = {k: torch.ones(1, 4, dtype=torch.float64, device="meta")
           for k in ops.LAYER_FIELDS}
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ops.count_term_layers(cfg_u, lay)
    mixed = dict(cfg_u, rows=torch.ones(3, 1, dtype=torch.float64))
    inv_m = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.count_term_sums(((0, 4),), mixed, cfg_u, lay, inv_m)
    with pytest.raises(ValueError, match="several devices"):
        ops.count_term_sums(((0, 4),), cfg_u, cfg_u, lay,
                            torch.zeros(3, dtype=torch.int64))


class _FakeNvcc:
    """Stands in for ``subprocess.Popen`` of nvcc: writes the library."""
    calls = []

    def __init__(self, cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_text("lib")
        self.returncode = 0
        _FakeNvcc.calls.append(cmd)

    def communicate(self):
        return "ptxas info", None


def test_build_key_follows_source(monkeypatch, tmp_path):
    """The library is keyed by a hash of the source and the flags, so an
    edited source never loads a stale build."""
    src = tmp_path / "k.cu"
    src.write_text("// a")
    monkeypatch.setattr(ops, "SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.calls = []
    seen = _FakeNvcc.calls
    lib_a, log_a = ops.build()
    assert log_a == "ptxas info" and lib_a.is_file()
    assert ops.build() == (lib_a, "")           # cached: no second compile
    src.write_text("// b")
    lib_b, _ = ops.build()
    assert lib_b != lib_a and len(seen) == 2
    assert "--fmad=false" in seen[0] and "arch=compute_90a,code=sm_90a" in \
        seen[0]
    assert not list((tmp_path / "build").rglob("*.tmp"))


#: The training path: each imports with jax absent and nothing of ``repro``
#: (the two tests at the top walk every module).
TRAIN_MODULES = ("repro_torch.tree", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
                 "repro_torch.optim.clip", "repro_torch.optim.schedule",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
                 "repro_torch.ft.supervisor", "repro_torch.launch.steps",
                 "repro_torch.launch.train")


def test_train_modules_are_walked():
    assert set(TRAIN_MODULES) <= set(_modules())
    files = {PKG.parent / (m.replace(".", "/") + ".py") for m in TRAIN_MODULES}
    files = {f if f.exists() else f.with_suffix("") / "__init__.py"
             for f in files}
    assert files <= set(PORT_FILES)


def test_train_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train

    cfg = get_config("qwen2-0.5b").smoke()
    for call in (lambda: steps.build_train_step(cfg, seq_len=8,
                                                global_batch=2),
                 lambda: steps.build_train_step(cfg, seq_len=8,
                                                global_batch=2,
                                                device="cuda"),
                 lambda: train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        steps.build_train_step(cfg, seq_len=8, global_batch=2, device="cpu",
                               backend="cuda")


def test_backward_wrappers_reject_other_devices():
    """A backward on operands off the CPU that no kernel takes raises; it
    never runs the plain backward instead."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms

    meta = dict(device="meta")
    q = torch.empty(1, 16, 2, 64, dtype=torch.bfloat16, **meta)
    lse = torch.empty(1, 2, 16, **meta)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    x = torch.empty(4, 32, **meta)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        rms.rmsnorm_bwd(x, torch.empty(32, **meta), x)
    assert fa.backward_launch_counts() == {"flash_attention_bwd": 0}
    assert rms.backward_launch_counts() == {"rmsnorm_bwd": 0}
