"""Builds and loads the port's CUDA kernels.

Every ``*.cu`` file under ``nbody_torch/forces/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The build happens at first use, into
``nbody_torch/_build/`` (git ignores it), and is keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  A failed build raises with nvcc's output; nothing falls back to a
plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "forces" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
#: what the last build or load in this process did: path, seconds, log
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use"
        )
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbody_torch_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds, log=log, built=True)


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, log="", built=False)
    else:
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.p3m_short_tile.argtypes = []
    lib.p3m_short_tile.restype = ctypes.c_int
    lib.p3m_short_acc_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.p3m_short_acc_f32.restype = ctypes.c_int
    _lib = lib
    return lib
