"""Build the port's native sources at first use.

Each source under ``gnn_rag_tpu_torch/csrc/`` compiles into its own shared
library with a plain C interface in ``build/gnn_rag_tpu_torch/``, named
after the hash of the source, the ``csrc/`` headers it includes (such as
``sm90.cuh``) and the flags, so a changed source or header rebuilds and an
unchanged one loads the library already there. CUDA sources go
through nvcc for Hopper (``sm_90a``), ``graphpath.cpp`` through g++;
nvcc runs its device optimisation on up to 8 threads (``-split-compile``:
the same machine code; flash_attention.cu's 72 kernels build in ~33 s in
place of ~74 on an H100 host's 8 cores).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gnn_rag_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=8"]
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


def _with_headers(path: str) -> list:
    """``path`` and every file it includes with ``#include "..."`` that
    exists beside it, recursively, each once."""
    files, todo = [], [path]
    while todo:
        current = todo.pop()
        if current in files:
            continue
        files.append(current)
        with open(current) as f:
            for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read(),
                                   re.M):
                dep = os.path.join(os.path.dirname(current), name)
                if os.path.exists(dep):
                    todo.append(dep)
    return files


def digest(src: str, flags: list) -> str:
    """Hash of the compiler flags, the source and its included headers."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _with_headers(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library(source: str) -> str:
    """Compile ``csrc/<source>`` (``.cu`` with nvcc, ``.cpp`` with g++)
    unless its library exists; returns the library's path. Raises with the
    compiler's output when the build fails."""
    stem, ext = os.path.splitext(source)
    cuda = ext == ".cu"
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    src = os.path.join(CSRC, source)
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest(src, flags)}.so")
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
