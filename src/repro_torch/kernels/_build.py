"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` -- no PyTorch headers, so a
build takes seconds.  Libraries go to ``build/repro_torch/<hash>/`` at
the root of the checkout (``.gitignore`` lists ``build/``), keyed by a
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags,
on first use.  All sources are compiled at once, one ``nvcc`` process
each.

This module is imported only by the kernel wrappers, inside the call
that launches a kernel, so importing the package or running the plain
CPU path never looks for ``nvcc``.  Nothing here falls back: a missing
compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("feature_window.cu", "dt_traverse.cu", "feature_update.cu")
# -fmad=false: no multiply-add contraction anywhere (docs/PARITY.md §1);
# the kernels also spell their float ops with __fmul_rn/__fadd_rn
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch/<hash>/`` in the checkout, keyed by the flags,
    every source and every shared header (a header edit rebuilds all)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    root = pathlib.Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch" / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc on first use and need the "
                       "CUDA toolkit")


def build_all() -> pathlib.Path:
    """Compile every source that has no library yet, all in parallel.

    Returns the build directory.  Each library is written to a temporary
    name and renamed into place, so concurrent builders never load a
    half-written file.  ``nvcc``'s resource report (``-Xptxas -v``) is
    kept beside each library as ``<name>.log``.
    """
    out = build_dir()
    todo = [n for n in SOURCES if not (out / _lib_name(n)).exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out / f"{_lib_name(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{pathlib.Path(name).stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out / _lib_name(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def _lib_name(source: str) -> str:
    return f"lib{pathlib.Path(source).stem}.so"


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / _lib_name(source)))
        _LIBS[source] = lib
    return lib
