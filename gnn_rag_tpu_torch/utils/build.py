"""Build the port's native sources at first use.

Each source under ``gnn_rag_tpu_torch/csrc/`` compiles into its own shared
library with a plain C interface in ``build/gnn_rag_tpu_torch/``, named
after the hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads the library already there. CUDA sources go
through nvcc for Hopper (``sm_90a``), ``graphpath.cpp`` through g++.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gnn_rag_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

# library stem -> compiler output of the build this process made
logs: dict = {}


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "gnn_rag_tpu_torch/csrc/ at first use on a CUDA "
                           "machine")
    return found


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found")
    return found


def library(source: str) -> str:
    """Compile ``csrc/<source>`` (``.cu`` with nvcc, ``.cpp`` with g++)
    unless its library exists; returns the library's path. Raises with the
    compiler's output when the build fails."""
    stem, ext = os.path.splitext(source)
    cuda = ext == ".cu"
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out):
        return out
    compiler = _nvcc() if cuda else _cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    logs[stem] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}) on {source}:\n{logs[stem]}")
    os.replace(tmp, out)
    return out
