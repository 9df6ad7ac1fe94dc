"""The native (C++) LMDB reader, loaded through ctypes.

Counterpart of ``ccd_tpu/native/__init__.py``. ``lmdb_reader.cc`` (a
self-contained mmap + B-tree walk of the LMDB 0.9 format, no liblmdb) is
compiled by ``g++ -O2 -shared -fPIC`` at first use into the package's
git-ignored ``_build/`` directory, as ``libccd_lmdb_<hash of the source>.so``,
not next to the source. Loader threads and test processes may all ask for it
at once: the build runs under a thread lock and an exclusive file lock, into a
temporary name that ``os.replace`` then moves into place, so no process loads
half a file. Nothing is built at import.

:func:`open_reader` prefers the native reader, as the JAX package's does, and
falls back to the pure-Python :class:`~ccd_tpu_torch.data.lmdb.LmdbReader`
where it cannot be built; the compiler's message then goes to stderr (once a
process), not into silence. Both readers name themselves in ``kind``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

from ccd_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lmdb_reader.cc")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libccd_lmdb_{digest}.so")


def build() -> str:
    """Compile ``lmdb_reader.cc`` unless its library is there; return the
    library's path. Raises ``RuntimeError`` with the compiler's output when
    the build fails."""
    import fcntl

    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libccd_lmdb.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler at a time across processes
        if os.path.isfile(lib):          # another process built it meanwhile
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no g++ on the machine
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The native library, built at first use and loaded once a process.
    Raises ``RuntimeError`` (the compiler's message) when it cannot be built;
    a failed build is not retried in the same process."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            path = build()
        except RuntimeError as e:
            _build_error = str(e)
            raise
        lib = ctypes.CDLL(path)
        lib.ccd_lmdb_open.restype = ctypes.c_void_p
        lib.ccd_lmdb_open.argtypes = [ctypes.c_char_p]
        lib.ccd_lmdb_entries.restype = ctypes.c_uint64
        lib.ccd_lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.ccd_lmdb_get.restype = ctypes.c_int
        lib.ccd_lmdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.ccd_lmdb_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeLmdbReader:
    """ctypes wrapper with the interface of ``data.lmdb.LmdbReader``: ``get``
    copies the value out of the mmap into ``bytes`` (None for a missing key)."""

    kind = "native"

    def __init__(self, path: str):
        self._lib = load()
        self._env = self._lib.ccd_lmdb_open(path.encode())
        if not self._env:
            raise ValueError(f"cannot open LMDB environment at {path}")
        self.entries = int(self._lib.ccd_lmdb_entries(self._env))
        self.path = path

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        hit = self._lib.ccd_lmdb_get(self._env, key, len(key),
                                     ctypes.byref(val), ctypes.byref(vlen))
        if not hit:
            return None
        return ctypes.string_at(val.value, vlen.value)

    def __len__(self) -> int:
        return self.entries

    def close(self) -> None:
        if getattr(self, "_env", None):
            self._lib.ccd_lmdb_close(self._env)
            self._env = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


_reported = False


def open_reader(path: str):
    """The native reader where it builds, else the pure-Python one (with the
    compiler's message on stderr, once a process). A path that the native
    reader cannot open goes to the Python reader too, whose error names the
    cause."""
    global _reported
    from ccd_tpu_torch.data.lmdb import LmdbReader
    try:
        return NativeLmdbReader(path)
    except RuntimeError as e:
        if not _reported:
            _reported = True
            print(f"ccd_tpu_torch.native: the C++ LMDB reader could not be built; reading "
                  f"with the Python reader instead:\n{e}", file=sys.stderr, flush=True)
    except ValueError:
        pass
    return LmdbReader(path)
