"""Where K2's time goes, on one GPU: the deposit against variants of itself.

    python scripts/torch_k2_ablation.py [--variants a,b] [--sites a,b]
        [--rounds 3] [--parent DIR] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/`` with
``pm_supercell.cu`` patched by this script, or replaced by one of the
designs kept under ``scripts/``, built with nvcc (one process a variant,
all started together) into ``output/k2_ablation/`` (git-ignored) and
loaded with ctypes.  The kernel carries only the redesign; every other
design lives here, and a patch that no longer applies stops the script.
Variants:

* ``redesign``: the source as it is (a thread a real slot; its 8 corner
  masses in 64-bit integer fixed point, added with integer atomics, the
  node masses written by a last pass; the integer mesh zeroed by a
  memset in the same call);
* ``float atomics``: the design before it
  (``scripts/torch_k2_float4.cu``: each node line's z pair of corners as
  one float4 atomic on the aligned four nodes that hold both, else two
  scalar atomics, into the float mesh; not bit for bit), and ``scalar
  atomics``, that design with 8 scalar float atomics a slot;
* ``128 threads``: the redesign with 128 threads a block;
* ``original``: K2 before its redesign for Hopper
  (``scripts/torch_k2_original.cu``: 8 scalar atomics a slot into a
  mesh the wrapper zeroes), through its own wrapper (the parent's: the
  plane checked, ``torch.zeros``, one launch in a device context);
* ``tile``: the shared-memory tile design (``scripts/torch_k2_tile.cu``:
  a block a column and z range of ``tile_geometry``, the tile in
  fixed-point integers with shared-memory atomics, the core stored, the
  ring gathered by a second kernel; bit for bit), and its forms
  ``tile float atomics`` (the tile in float32, float atomics to shared
  memory: a compare-and-swap loop on this card), ``tile Z x2``, and
  time-only ones (wrong sums) ``tile no scan`` (no slot read) and
  ``tile no gather`` (no second kernel).

Sites (``--sites``), ``chip_smoke.py``'s K2 inputs: ``ics64`` and
``ics64-half`` ([7]: cfg64's ICs on the supercell plane at the driver's
pre-warmed geometry, shift 0 and 0.5), ``final64`` ([7]: the final state
of the cfg64 run, run here, at its healed geometry), ``frozen`` ([11]:
the plane of a plan frozen at the ICs, the positions drifted by 0.999
skin/2), ``slab`` ([19]: the four shards' slab planes of the ICs, shift
0).  Each variant is timed in each of ``--rounds`` rounds, in turn with
the others, and the median kept, twice: the whole call (the wrapper's
host work included; CUDA events around a run of calls) and the kernel
alone (the library call on prepared buffers: the memset in it where the
variant has one, the original's ``torch.zeros`` fill not).  Each prints
its largest node error against the float32 plain version over the
largest node, and whether two calls are equal bit for bit; and the
atomic instructions of its SASS.  Then ``redesign`` and ``original``
under ``torch.profiler``: the device time of each kernel a call (the
fill and memset among them), against the call's time by CUDA events and
the host's enqueue.  With ``--parent DIR`` (a checkout of the parent) it
compares K3's SASS (``fused_kernel``, in the same file) built from both
trees.  JSON to ``--out`` (default ``output/k2_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_torch import _kernels  # noqa: E402
from nbody_torch.forces import pm_supercell as ps  # noqa: E402

BUILD = os.path.join(ROOT, "output", "k2_ablation")
ORIGINAL = os.path.join(ROOT, "scripts", "torch_k2_original.cu")
FLOAT4 = os.path.join(ROOT, "scripts", "torch_k2_float4.cu")
TILE = os.path.join(ROOT, "scripts", "torch_k2_tile.cu")
CU = "pm_supercell.cu"

SCALAR = (CU, "  const bool vec = (nmesh & 3) == 0;", "  const bool vec = false;")
THREADS_128 = (CU, "constexpr int kDepositThreads = 256;",
               "constexpr int kDepositThreads = 128;")
# the tile in float32, added with float atomics to shared memory
FLOAT_TILE = (CU, """using TileWord = unsigned;
__device__ __forceinline__ void tile_add(TileWord* node, float w, float q) {
  atomicAdd(node, __float2uint_rn(w * q));
}
__device__ __forceinline__ float tile_mass(TileWord v, float unit) {
  return __uint2float_rn(v) * unit;
}""", """using TileWord = float;
__device__ __forceinline__ void tile_add(TileWord* node, float w, float) {
  atomicAdd(node, w);
}
__device__ __forceinline__ float tile_mass(TileWord v, float) { return v; }""")
# time only (wrong sums): the tile kernel without its slot scan, the ring
# kernel without its gather
NO_SCAN = (CU, """  bool off = false;
  for (int r = threadIdx.x; r < n; r += kDepositThreads) {""", """  bool off = false;
  for (int r = threadIdx.x; r < 0; r += kDepositThreads) {""")
NO_GATHER = (CU, "  const int inner = S > 2 * kDepositHalo ? S - 2 * kDepositHalo : 0;",
             "  if (!around[4][0]) return;\n"
             "  const int inner = S > 2 * kDepositHalo ? S - 2 * kDepositHalo : 0;")


class Variant(NamedTuple):
    """The source (``port``: csrc/ as it is; ``float4``, ``original``,
    ``tile``: the designs under scripts/), patches on it (file, old, new, each to match
    once) and, for the tile, the factor on ``tile_geometry``'s Z."""

    source: str
    patches: list = []
    z_scale: float = 1.0


VARIANTS = {
    "redesign": Variant("port"),
    "float atomics": Variant("float4"),
    "scalar atomics": Variant("float4", [SCALAR]),
    "128 threads": Variant("port", [THREADS_128]),
    "original": Variant("original"),
    "tile": Variant("tile"),
    "tile float atomics": Variant("tile", [FLOAT_TILE]),
    "tile Z x2": Variant("tile", z_scale=2.0),
    "tile no scan": Variant("tile", [NO_SCAN]),
    "tile no gather": Variant("tile", [NO_GATHER]),
}
ENTRY = "ppiiiiiiiiiiddppp"
FLOAT_ENTRY = "ppiiiiiiiiiddpp"
TILE_ENTRY = "ppiiiiiiiiiiddppp"
SAME_SOURCE = {"tile Z x2": "tile"}

#: the tile design's launch shape: its ring in nodes each side of a
#: column's core lines; ranges of z nodes cut until the items make
#: TILE_ITEMS_PER_SM an SM (down to TILE_MIN_Z nodes) and the tile takes
#: at most TILE_SMEM bytes
TILE_HALO = 2
TILE_ITEMS_PER_SM = 4
TILE_MIN_Z = 16
TILE_SMEM = 49152


class TileGeometry(NamedTuple):
    Z: int
    nr: int
    items: int
    lines: int
    smem: int


def tile_geometry(nx: int, ncell: int, S: int, nmesh: int, sms: int,
                  z_scale: float = 1.0) -> TileGeometry:
    """The tile design's launch: the fewest z ranges a column (a power of
    two dividing nmesh) whose items make TILE_ITEMS_PER_SM an SM, with
    ranges of at least TILE_MIN_Z nodes, and whose tile (lines at an odd
    stride, Z | 1) takes at most TILE_SMEM bytes; Z scaled by
    ``z_scale``."""
    lines = (S + 2 * TILE_HALO) ** 2

    def smem(z):
        return lines * (z | 1) * 4

    nr = 1
    while nmesh % (2 * nr) == 0 and (
            smem(nmesh // nr) > TILE_SMEM
            or (nx * ncell * nr < TILE_ITEMS_PER_SM * sms
                and nmesh // (2 * nr) >= TILE_MIN_Z)):
        nr *= 2
    Z = max(1, min(nmesh, int(nmesh // nr * z_scale)))
    nr = nmesh // Z
    return TileGeometry(Z, nr, nx * ncell * nr, lines, smem(Z))


def source_tag(name: str) -> str:
    return "k2_" + re.sub(r"\W+", "_", name).strip("_")


def build_all(names) -> dict:
    """{name: (so, ptxas log)}, the builds started together; variants of
    one source and launch shape share a build."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in {SAME_SOURCE.get(n, n) for n in names}:
        v = VARIANTS[name]
        out = os.path.join(BUILD, source_tag(name))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_kernels.SOURCE_DIR, out)
        if v.source != "port":
            shutil.copy({"original": ORIGINAL, "float4": FLOAT4,
                         "tile": TILE}[v.source], os.path.join(out, CU))
        for fname, old, new in v.patches:
            path = os.path.join(out, fname)
            src = open(path).read()
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the patch does not apply to "
                                   f"{fname}: {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        so = os.path.join(BUILD, source_tag(name) + ".so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(out, CU)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (so, log)
    return {n: built[SAME_SOURCE.get(n, n)] for n in names}


def load(name: str, so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    sig = {"tile": TILE_ENTRY, "port": ENTRY}.get(VARIANTS[name].source,
                                                 FLOAT_ENTRY)
    f = lib.pm_supercell_deposit_f32
    f.argtypes = [_kernels._CTYPES[c] for c in sig]
    f.restype = ctypes.c_int
    return lib


def load_variants(names) -> dict:
    """{name: (library, ptxas log)} of the variants ``names``, built now."""
    return {name: (load(name, so), log)
            for name, (so, log) in build_all(names).items()}


def variant_geometry(name: str, kw: dict) -> TileGeometry | None:
    """The tile variants' launch shape for ``kw`` (a site's call)."""
    v = VARIANTS[name]
    if v.source != "tile":
        return None
    sms = torch.cuda.get_device_properties(
        kw["plane"].device).multi_processor_count
    return tile_geometry(kw["nx"], kw["ncell"], kw["nmesh"] // kw["ncell"],
                         kw["nmesh"], sms, v.z_scale)


def _args(kw: dict) -> dict:
    S = kw["nmesh"] // kw["ncell"]
    return dict(nx=kw["nx"], ncell=kw["ncell"], S=S, nmesh=kw["nmesh"],
                stride=kw["stride"], gz=kw["gz"],
                scale=float(kw["nmesh"] / kw["box"]),
                shift=float(kw["shift"]), row0=kw["row0"])


def _original_call(lib, kw: dict):
    """K2 before its redesign, through its own wrapper (the parent's:
    the plane checked, the mesh zero-filled, one launch)."""
    a = _args(kw)
    plane, counts = kw["plane"], kw["counts"]
    CK = a["stride"] - 2 * a["gz"]
    ps.check_plane_args("original", plane, {"counts": counts},
                        maxch=CK // 256, ncell=a["ncell"],
                        stride=a["stride"], nx=a["nx"])
    slab = a["nx"] != a["ncell"]
    rho = torch.zeros((a["nx"] * a["S"] + 3 if slab else a["nmesh"],
                       a["nmesh"], a["nmesh"]), dtype=torch.float32,
                      device=plane.device)
    with torch.cuda.device(plane.device):
        err = lib.pm_supercell_deposit_f32(
            plane.data_ptr(), counts.data_ptr(), a["nx"], a["ncell"],
            int(slab), a["row0"], a["S"], a["nmesh"], a["stride"], a["gz"],
            CK, a["scale"], a["shift"], rho.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"original K2: launch failed (error {err})")
    return rho


def _head(kw: dict, port: bool = False) -> tuple:
    """The deposit's leading arguments; the port's source takes the
    member count (one) after the counts."""
    a = _args(kw)
    slab = int(a["nx"] != a["ncell"])
    members = (1,) if port else ()
    return (kw["plane"].data_ptr(), kw["counts"].data_ptr(), *members,
            a["nx"], a["ncell"], slab, a["row0"], a["S"], a["nmesh"],
            a["stride"], a["gz"], a["stride"] - 2 * a["gz"])


def _mesh(kw: dict, fill: bool):
    a = _args(kw)
    shape = (a["nx"] * a["S"] + 3 if a["nx"] != a["ncell"] else a["nmesh"],
             a["nmesh"], a["nmesh"])
    make = torch.zeros if fill else torch.empty
    return make(shape, dtype=torch.float32, device=kw["plane"].device)


def _sums(rho):
    """The port's scratch: the integer sums and the largest mass."""
    return torch.empty((rho.numel() + 1,), dtype=torch.int64,
                       device=rho.device)


def _scratch(geo: TileGeometry, device):
    words = 1 + -(-geo.lines // 32)
    return torch.empty(geo.items * (geo.lines * geo.Z + words),
                       dtype=torch.float32, device=device)


def variant_call(name: str, lib, kw: dict):
    """One call of variant ``name`` (library ``lib``) on the card, through
    a wrapper as the port's (the original: through its own, the parent's)."""
    if name == "original":
        return _original_call(lib, kw)
    a = _args(kw)
    ps.check_plane_args("variant", kw["plane"], {"counts": kw["counts"]},
                        maxch=(a["stride"] - 2 * a["gz"]) // 256,
                        ncell=a["ncell"], stride=a["stride"], nx=a["nx"])
    rho = _mesh(kw, False)
    geo = variant_geometry(name, kw)
    stream = torch.cuda.current_stream().cuda_stream
    if VARIANTS[name].source == "port":
        sums = _sums(rho)
        err = lib.pm_supercell_deposit_f32(*_head(kw, True), a["scale"],
                                           a["shift"],
                                           rho.data_ptr(), sums.data_ptr(),
                                           stream)
    elif geo is None:
        err = lib.pm_supercell_deposit_f32(*_head(kw), a["scale"], a["shift"],
                                           rho.data_ptr(), stream)
    else:
        scratch = _scratch(geo, rho.device)
        err = lib.pm_supercell_deposit_f32(*_head(kw), geo.Z, a["scale"],
                                           a["shift"], rho.data_ptr(),
                                           scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed (error {err})")
    return rho


def kernel_launch(name: str, lib, kw: dict):
    """(a function that launches variant ``name``'s kernels alone: one
    ctypes call on prepared buffers, no torch op, so its time is the
    device's (the original's mesh fill is not in it); what it keeps
    alive)."""
    a = _args(kw)
    rho = _mesh(kw, True)
    stream = torch.cuda.current_stream().cuda_stream
    head = _head(kw)
    geo = variant_geometry(name, kw)
    if VARIANTS[name].source == "port":
        sums = _sums(rho)
        head = _head(kw, True)
        return (lambda: lib.pm_supercell_deposit_f32(
            *head, a["scale"], a["shift"], rho.data_ptr(), sums.data_ptr(),
            stream), (rho, sums))
    if geo is None:
        return (lambda: lib.pm_supercell_deposit_f32(
            *head, a["scale"], a["shift"], rho.data_ptr(), stream), (rho,))
    scratch = _scratch(geo, rho.device)
    return (lambda: lib.pm_supercell_deposit_f32(
        *head, geo.Z, a["scale"], a["shift"], rho.data_ptr(),
        scratch.data_ptr(), stream), (rho, scratch))


def plain(kw: dict):
    """The float32 plain version at ``kw``: deposit + fold."""
    a = _args(kw)
    S, ZP = ps.supercell_geometry(a["nmesh"], a["ncell"])
    nodes = ps.deposit_node_masses_plain(
        kw["plane"], kw["counts"], ncell=a["ncell"], S=S, ZP=ZP,
        stride=a["stride"], gz=a["gz"], scale=a["scale"], shift=a["shift"],
        nx=a["nx"], row0=a["row0"])
    if a["nx"] != a["ncell"]:
        return ps.fold_slab_node_masses(nodes, nx=a["nx"], ncell=a["ncell"],
                                        S=S, ZP=ZP, nmesh=a["nmesh"])
    return ps.fold_node_masses(nodes, ncell=a["ncell"], S=S, ZP=ZP,
                               nmesh=a["nmesh"])


def time_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def registers(log: str) -> dict:
    """ptxas's registers of each deposit kernel."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "deposit" in fn:
            out[fn] = int(m.group(1))
    return out


def chip_smoke():
    """``chip_smoke.py``, the module (its site builders)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sites(names) -> dict:
    """{site: [the calls' keywords, one a launch]}, the inputs of
    ``chip_smoke.py``'s K2 checks."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation
    from nbody_torch.forces.p3m import supercell_ncell
    from nbody_torch.forces.p3m_columns import (
        column_window,
        frozen_plane,
        plane_geometry,
    )

    cs = chip_smoke()
    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    box, nmesh = cfg64.box, cfg64.mesh_size
    ics = realize_ics(cfg64, 0)
    out = {}

    def one(plane, counts, geo, shift=0.0):
        return dict(plane=plane, counts=counts, box=box, nmesh=nmesh,
                    ncell=geo["ncell"], nx=geo["ncell"], stride=geo["stride"],
                    gz=geo["gz"], shift=shift, row0=0)

    if names & {"ics64", "ics64-half"}:
        _, plane, _, _, counts, geo = cs.driver_plane(ics, cfg64, cfg64, True)
        out["ics64"] = [one(plane, counts, geo)]
        out["ics64-half"] = [one(plane, counts, geo, 0.5)]
    if "final64" in names:
        work = os.path.join(ROOT, "output", "k2_ablation_run")
        shutil.rmtree(work, ignore_errors=True)
        res = run_simulation(cfg64, 0, work)
        _, plane, _, _, counts, geo = cs.driver_plane(res.state, cfg64,
                                                      res.config_run, False)
        out["final64"] = [one(plane, counts, geo)]
    if "frozen" in names:
        r64 = cfg64.replace(rungs=3)
        plan, moved, geo, g = cs._frozen_setup(ics, r64, 0.999)
        plane, _, _ = frozen_plane(moved, ics.mass, plan, box, g["r_cut"],
                                   geo["ncell"], g["CK"], geo["gz"],
                                   geo["stride"])
        counts = torch.clamp_max(plan.counts, g["CK"]).to(torch.int32)
        out["frozen"] = [one(plane, counts, geo)]
    if "slab" in names:
        group, geom, shards, ck, cw, _ = cs.domain_setup(ics, cfg64,
                                                         "supercell")
        sc = supercell_ncell(box, nmesh, geom.r_cut)
        nx = sc // group.size
        CK, gz, stride, W, _, chunk = plane_geometry(
            box, geom.r_cut, ck, cw or column_window(box, geom.r_cut, ck))
        built = td.build_local_column_plane(
            [s.pos for s in shards], [s.mass for s in shards], box=box,
            r_cut=geom.r_cut, ncell=sc, group=group, col_capacity=CK,
            window=W, chunk=chunk)
        out["slab"] = [dict(plane=b[0], counts=b[6], box=box, nmesh=nmesh,
                            ncell=sc, nx=nx, stride=stride, gz=gz, shift=0.0,
                            row0=d * nx) for d, b in enumerate(built)]
    return {k: out[k] for k in names if k in out}


def sass_functions(obj: str, pattern: str) -> str:
    """The SASS of the object's functions whose names match ``pattern``,
    with the anonymous-namespace prefix (a hash of the source's path)
    masked."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    parts = [p for p in text.split("Function :")[1:]
             if re.search(pattern, p.split()[0])]
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "_ANON_",
                  "\n".join(parts))


def atomic_ops(so: str) -> dict:
    """{kernel: {opcode: count}} of the atomic and reduction instructions
    (ATOM*, RED*) in the deposit kernels' SASS."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function :")[1:]:
        name = part.split()[0]
        if "deposit" not in name:
            continue
        key = re.sub(r".*?(deposit_\w+?kernel).*", r"\1", name)
        ops = {}
        for m in re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[\w.]+)",
                             part):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        out[key] = ops
    return out


def sass_check(parent: str) -> tuple[bool, list]:
    """K3 (``fused_kernel``) built from this tree and from ``parent``: is
    its SASS the same?  And the first lines that differ."""
    import difflib

    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for tree, root in (("this", str(_kernels.SOURCE_DIR)),
                       ("parent", os.path.join(parent, "nbody_torch",
                                               "forces", "csrc"))):
        obj = os.path.join(BUILD, f"sass_{tree}_{CU}.o")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(root, CU)]
        jobs[tree] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    for key, (obj, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    this, par = (sass_functions(jobs[t][0], "fused_kernel")
                 for t in ("this", "parent"))
    diff = [d for d in difflib.unified_diff(par.splitlines(),
                                            this.splitlines(), lineterm="",
                                            n=0)][:40]
    return bool(this) and this == par, diff


def stage_times(fn, calls: int = 50) -> tuple[dict, float, float]:
    """({kernel: device ms a call}, ms a call by CUDA events, host ms a
    call: the enqueue, with no synchronisation inside) of ``fn`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    stages = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0.0)
        if dev and ev.key and ev.device_type.name == "CUDA":
            stages[ev.key[:60]] = dev / 1e3 / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return stages, time_ms(fn, calls), host


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sites", default="ics64,ics64-half,final64,frozen,"
                                       "slab")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k2_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_ablation: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    names = args.variants.split(",")
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}")
    results = {"card": card, "variants": {}}
    if args.parent:
        same, diff = sass_check(args.parent)
        results["k3_sass_same"] = same
        print(f"K3's SASS against the parent's: "
              f"{'the same' if same else 'DIFFERENT'}", flush=True)
        for line in diff:
            print(f"  {line}", flush=True)
    libs = load_variants(names)
    for name in names:
        ops = atomic_ops(os.path.join(BUILD, source_tag(
            SAME_SOURCE.get(name, name)) + ".so"))
        results["variants"].setdefault(name, {})["sass_atomics"] = ops
        print(f"{name}: registers {registers(libs[name][1])}; atomics in "
              f"its SASS by kernel {ops}", flush=True)
    data = sites(set(args.sites.split(",")))
    for site, kws in data.items():
        refs = [plain(kw) for kw in kws]
        top = max(float(r.abs().max()) for r in refs)
        times = {name: [] for name in names}
        ktimes = {name: [] for name in names}
        rows = {}
        for rnd in range(args.rounds):
            for name in names:
                lib = libs[name][0]

                def call(name=name, lib=lib):
                    return [variant_call(name, lib, kw) for kw in kws]

                times[name].append(time_ms(call, 50) / len(kws))
                kern = [kernel_launch(name, lib, kw) for kw in kws]
                ktimes[name].append(time_ms(
                    lambda: [k[0]() for k in kern], 50) / len(kws))
                if rnd:
                    continue
                got, again = call(), call()
                torch.cuda.synchronize()
                geo = variant_geometry(name, kws[0])
                rows[name] = dict(
                    err=max(float((g - r).abs().max())
                            for g, r in zip(got, refs)) / top,
                    bit_equal=all(torch.equal(g, a)
                                  for g, a in zip(got, again)),
                    geometry=geo._asdict() if geo else None)
                del kern
        kw = kws[0]
        n_real = sum(int(k["counts"].sum()) for k in kws)
        print(f"{site}: {len(kws)} launch(es) of {kw['nx']} x {kw['ncell']} "
              f"columns, shift {kw['shift']}; {n_real} particles", flush=True)
        base = (statistics.median(ktimes["redesign"])
                if "redesign" in ktimes else None)
        for name in names:
            row = rows[name]
            row["ms"] = statistics.median(times[name])
            row["ms_rounds"] = times[name]
            row["kernel_ms"] = statistics.median(ktimes[name])
            row["kernel_ms_rounds"] = ktimes[name]
            geo = row["geometry"]
            shape = (f"Z {geo['Z']}, {geo['items']} items, {geo['smem']} B "
                     f"of shared memory" if geo else
                     "a thread a slot, (columns, CK / 256) blocks")
            vs = (f" ({row['kernel_ms'] / base:.3f}x the redesign's)" if base
                  else "")
            print(f"  {name}: kernel {row['kernel_ms']:.4f} ms{vs}; the whole "
                  f"call {row['ms']:.4f} ms; kernel rounds "
                  f"{', '.join(f'{t:.4f}' for t in ktimes[name])}; max |node "
                  f"- plain f32| / max {row['err']:.3e}; "
                  f"{'bit-equal' if row['bit_equal'] else 'NOT bit-equal'}; "
                  f"{shape}", flush=True)
            results["variants"].setdefault(name, {})[site] = row
        for name in ("redesign", "original"):
            if name not in names:
                continue
            lib = libs[name][0]
            stages, ms, host = stage_times(
                lambda: [variant_call(name, lib, kw) for kw in kws])
            stages = {k: v / len(kws) for k, v in stages.items()}
            results.setdefault("stages", {}).setdefault(site, {})[name] = dict(
                stages=stages, ms=ms / len(kws), host_ms=host / len(kws))
            print(f"  {name} by kernel (torch.profiler, device ms a call; "
                  f"{sum(stages.values()):.4f} of {ms / len(kws):.4f} ms a "
                  f"call by CUDA events, the host's enqueue "
                  f"{host / len(kws):.4f} ms a call): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(
                          stages.items(), key=lambda kv: -kv[1])),
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
