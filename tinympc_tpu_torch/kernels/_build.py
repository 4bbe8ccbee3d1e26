"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``tinympc_tpu_torch/_build/`` and loaded with ``ctypes``. The library's file
name carries a hash of its source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. Only the package's own sources are built. Nothing here runs at
import time.

``-fmad=false`` keeps the compiler from contracting a product and a sum
into one fused multiply-add: the kernels' elementwise terms such as
``q - rho * (v - g)`` then round twice, as PyTorch's separate operations
round them in the plain versions. The matrix-vector sums call ``fmaf``
explicitly and stay fused. ``-split-compile=8`` lets the compiler work on
a source's kernels in 8 parallel parts: csrc/admm_fused.cu, with its many
instantiations, then builds in about a quarter of the time. It changes no
arithmetic (the rounding is fixed by the source and ``-fmad=false``); a
kernel's register count may move by one between builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-split-compile=8", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

# The kernel sources, csrc/<name>.cu: the resident box-only fixed-rho solve
# (a problem a thread group), the resident solve's other instantiations,
# the fused closed loop on thread groups and on one thread a plant, the
# streamed long-horizon solve and the roofline probes.
SOURCES = ("admm_group", "admm_fused", "closed_loop_fused",
           "closed_loop_thread", "admm_stream", "roofline")

# Loaded libraries of this process, by source name.
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: its name hashes the source, every
    shared header ``csrc/*.cuh`` and the flags, so that an edit to any of
    them builds a new library."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together. Returns each compiled source's compiler
    output (ptxas register and spill report); raises ``RuntimeError`` with
    the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def loaded(name: str):
    """The library of ``csrc/<name>.cu`` if this process has loaded it,
    else None (nothing is built)."""
    return _LOADED.get(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
