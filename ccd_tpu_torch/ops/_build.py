"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>_<hash of the sources>.so`` (the hash
covers the shared ``csrc/*.cuh`` headers too) and loaded with ``ctypes``. Nothing here runs at import time: the CPU-only tests import
every module of the package on machines with no ``nvcc``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

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


def _paths(name: str, csrc_dir: Optional[str] = None, build_dir: Optional[str] = None):
    """(source, library) paths of ``<csrc_dir>/<name>.cu`` (by default the
    package's ``csrc/``, built into its ``_build/``)."""
    import glob
    import hashlib

    csrc_dir, build_dir = csrc_dir or CSRC_DIR, build_dir or BUILD_DIR
    src = os.path.join(csrc_dir, f"{name}.cu")
    digest = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(csrc_dir, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(build_dir, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_libraries(names: Sequence[str], csrc_dir: Optional[str] = None,
                    build_dir: Optional[str] = None) -> List[str]:
    """Compile every ``<csrc_dir>/<name>.cu`` (the package's own sources by
    default) whose library is not in ``build_dir`` yet, all ``nvcc`` runs
    started together; return the libraries' paths. Raises with the
    compiler's output when a build fails."""
    import subprocess

    libs, running = [], []
    for name in names:
        src, lib = _paths(name, csrc_dir, build_dir)
        libs.append(lib)
        if os.path.isfile(lib):
            continue
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        running.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, tmp, lib, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is not there yet; return the
    library's path."""
    return build_libraries([name])[0]


def load_library(name: str):
    """``ctypes.CDLL`` of ``csrc/<name>.cu``, built at first use and loaded once."""
    if name not in _loaded:
        import ctypes
        _loaded[name] = ctypes.CDLL(build_library(name))
    return _loaded[name]


ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads")


def kernel_attributes(library: str, entry: str, *args: int) -> dict:
    """``entry(*args, out)`` of ``csrc/<library>.cu``: a kernel's launch
    resources on the current card (``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), named as
    :data:`ATTRIBUTES`."""
    import ctypes

    fn = getattr(load_library(library), entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(ATTRIBUTES))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return dict(zip(ATTRIBUTES, out))
