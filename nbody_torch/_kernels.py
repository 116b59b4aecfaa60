"""Builds and loads the port's CUDA kernels.

Every ``*.cu`` file under ``nbody_torch/forces/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together)
and linked into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The build happens at first use, into
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out.strip())
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out.strip()}")
    tmp = so.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      log="\n".join(logs), built=True)


# argument types of the C entry points: p = pointer (and the stream),
# i = int, d = double; every entry point returns a CUDA error code
_ENTRY_POINTS = {
    "p3m_short_keys": "pidpp",
    "p3m_short_f32": "pppiidddddiiiippppp",
    "p3m_short_info": "iip",
    "p3m_short_reach": "ddp",
    "p3m_columns_f32": "pppiiiiiiiiddddpiipp",
    "p3m_columns_masked_f32": "ppppiiiiiiiiddddpiipp",
    "column_pairs_info": "ppp",
    "p3m_cells_f32": "ppppiiiiidddiiipp",
    "p3m_cells_info": "iip",
    "pm_supercell_deposit_f32": "ppiiiiiiiiiiddppp",
    "pm_supercell_fused_f32": "ppppiiiiiiiiidiiiiiddddpiipp",
    "pp_allpairs_f32": "pippiddiippp",
    "pp_allpairs_f64": "pippiddiippp",
    "pp_allpairs_info": "iip",
    "pp_gram_f32": "ppiiddppp",
    "pp_gram_info": "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}


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
    for name, sig in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
