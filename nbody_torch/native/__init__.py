"""The emulator's threaded ``.npy`` volume loader (C++, bound with ctypes).

Counterpart of :mod:`nbody.native`, with its own copy of
``npy_loader.cpp``: a thread pool parses each file's ``.npy`` header and
reads (``<f4``) or converts (``<f8``) the volumes into one preallocated
float32 buffer, where the reference's data generator loaded one volume
per item in Python.

The library is built with ``g++ -O3 -fPIC -shared -pthread -std=c++17``
at first use, into ``nbody_torch/_build/`` (git ignores it), keyed on a
hash of the source and flags, as :mod:`nbody_torch._kernels` builds the
CUDA kernels.  A failed build raises with g++'s output; nothing falls
back to numpy (the JAX package does).  :func:`read_volumes_plain` is the
numpy loop the tests hold the loader to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "npy_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: "cannot open file",
    -2: "bad .npy magic",
    -3: "unparseable .npy header",
    -4: "unsupported dtype (need <f4 or <f8)",
    -5: "fortran-order arrays unsupported",
    -6: "element count mismatch / capacity exceeded",
    -7: "short read",
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libnpyloader_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run ({e}): the .npy loader is "
                           f"built from source at first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if its source changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.npy_read_f32.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long]
        lib.npy_read_f32.restype = ctypes.c_int
        lib.npy_batch_read_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                           ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_long, ctypes.c_int]
        lib.npy_batch_read_f32.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def read_volumes(paths, shape, n_threads: int | None = None) -> np.ndarray:
    """Read len(paths) ``.npy`` files of ``shape`` (``<f4`` or ``<f8``,
    C order) into one (M, *shape) float32 array with the C++ thread pool.
    Raises ``ValueError`` on a missing, malformed or mismatched file."""
    paths = list(paths)
    per_item = int(np.prod(shape))
    out = np.empty((len(paths), *shape), dtype=np.float32)
    if not paths:
        return out
    lib = get_lib()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 4)
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    rc = lib.npy_batch_read_f32(
        arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        per_item, n_threads)
    if rc != 0:
        raise ValueError(f"native npy read failed: {_ERRORS.get(rc, rc)} "
                         f"(reading {len(paths)} files of shape "
                         f"{tuple(shape)})")
    return out


def read_volumes_plain(paths, shape) -> np.ndarray:
    """The numpy loop :func:`read_volumes` replaces: the same array."""
    paths = list(paths)
    out = np.empty((len(paths), *shape), dtype=np.float32)
    for i, p in enumerate(paths):
        out[i] = np.load(p).reshape(shape).astype(np.float32)
    return out
