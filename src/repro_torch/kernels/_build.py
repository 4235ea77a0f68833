"""Build and load every CUDA source of the port.

Each ``src/repro_torch/csrc/*.cu`` is compiled with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, which
the kernel's wrapper loads with ``ctypes``.  The library goes under
``build/repro_torch_kernels/<hash>/`` in the checkout, keyed by a hash of
the source and the flags, so an edited source builds anew and an
unchanged one loads what is there.  :func:`build_many` starts one ``nvcc``
per source at once and waits for all of them; :func:`load` builds one
source and declares its C launchers for ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: Flags of every build.  ``-Xptxas=-v`` puts the registers and spills of
#: each kernel into the build log; a wrapper adds its own flags after them.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _target(source: Path, flags: Sequence[str]) -> Tuple[Path, Tuple[str, ...]]:
    flags = BASE_FLAGS + tuple(flags)
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{source.stem}.so", flags


def build_many(jobs: Sequence[Tuple[Path, Sequence[str]]]
               ) -> Dict[Path, Tuple[Path, str]]:
    """Compile each ``(source, extra flags)`` that has no library yet, all
    at once.  → ``{source: (library path, compiler log)}``, the log ""
    where the library was already built.  Each compiler writes to a
    temporary name that is renamed when it succeeds, so processes that
    build at once never load a half-written file."""
    out: Dict[Path, Tuple[Path, str]] = {}
    running = []
    for source, flags in jobs:
        lib, all_flags = _target(Path(source), flags)
        if lib.is_file():
            out[source] = (lib, "")
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *all_flags, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[source] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(source: Path, flags: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile one source if no library for it exists yet → (library
    path, compiler log)."""
    return build_many([(source, flags)])[source]


def load(source: Path, flags: Sequence[str],
         signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Build ``source`` if needed and load it, declaring each C launcher
    of ``signatures`` ({name: argtypes}) as returning a CUDA error code."""
    path, _ = build(source, flags)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
