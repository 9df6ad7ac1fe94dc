"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>_<hash of the source>.so`` and loaded
with ``ctypes``. Nothing here runs at import time: the CPU-only tests import
every module of the package on machines with no ``nvcc``.
"""

from __future__ import annotations

import os
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, object] = {}


def find_nvcc() -> str:
    import shutil
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME, "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is not there yet; return the
    library's path. Raises with the compiler's output when the build fails."""
    import hashlib
    import subprocess

    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def load_library(name: str):
    """``ctypes.CDLL`` of ``csrc/<name>.cu``, built at first use and loaded once."""
    if name not in _loaded:
        import ctypes
        _loaded[name] = ctypes.CDLL(build_library(name))
    return _loaded[name]
