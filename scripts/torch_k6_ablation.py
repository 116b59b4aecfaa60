"""Where K6's time goes, on one GPU: the kernel against variants of itself.

    python scripts/torch_k6_ablation.py [--variants a,b] [--sites a,b]
        [--rounds 3] [--parent DIR] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/`` with
``p3m_cells.cu`` patched by this script, built with nvcc (one process a
variant, all started together) into ``output/k6_ablation/`` (git-ignored),
loaded with ctypes and launched through the port's own wrapper code
(``p3m._k6_run``, the launch shape from ``k6_geometry``).  The kernel
carries only the redesign; every other design lives here as a patch, and
a patch that no longer applies stops the script.  Variants:

* ``redesign``: the source as it is (a block of W warps a target cell,
  W from ``k6_geometry``; the neighbourhood's tiles dealt out to the
  warps; 32 // c lanes a target in a cell of c <= 32 targets; cp.async
  staging, two buffers a warp; the weight under the cutoff branch with
  the one-instruction rsqrt, rcp and exp);
* ``original``: K6 before its redesign for Hopper
  (``scripts/torch_k6_original.cu``: a 64-thread block a cell, one
  synchronous tile and two block barriers per neighbour cell), through
  its own wrapper (the parent's: the planes checked twice in the
  one-plane form, a device context, a zero-filled output);
* ``W 1`` ... ``W 16``: the redesign with that many warps a block;
* ``synchronous staging``: each tile loaded into registers and stored
  before the sum (no cp.async);
* ``no target packing``: one target a lane at every count;
* ``IEEE weight``: the weight's library rsqrtf, division and expf;
* ``two passes``: the weight deferred: a first pass marks each lane's
  sources of a tile inside r_cut, a bit each, a second runs the weight on
  the marked ones;
* ``42 registers``: three 512-thread blocks an SM (``__launch_bounds__``),
  so at most 42 registers a thread;
* ``Newton form``: K1's: with the cubic-spline softening, a pair beyond
  its support h takes the Newton form alone;
* ``cull``: K1's tile cull within the cell pairs: the sources of each
  cell sorted by a Morton key of their place in it (a 4^3 grid; a
  private copy of the source plane, sorted by this script's wrapper on
  every call) and each 8-source sub-tile of a staged tile skipped where
  its box lies farther than r_cut from the box of the warp's targets;
* ``narrowed``: the (+1, +1, +1) neighbour cell left out (a planted
  fault: ``chip_smoke.py`` requires its per-target error to fail the
  limit).

Sites (``--sites``), ``chip_smoke.py``'s: ``ics32``, ``late32``,
``ics64`` ([11] one-plane: the 32^3 ICs, the default run's final state,
the 64^3 ICs), ``late32-two`` ([11] two-plane: the particles above rung
0 at the default run's final state against all of them), ``slab`` ([19]:
the 32^3 ICs on four shards), ``masked-slab`` ([20]: the final state of
the 32^3 ``devices=4, rungs=3, column_skin=0`` run, run here), and
``replicated`` ([21]: the cfg64 ICs, four shards' x-slabs of the whole
plane).  Each variant is timed in each of ``--rounds`` rounds, in turn
with the others (CUDA events around a run of launches after a warm-up),
and the median kept, twice: the whole call (the wrapper's host work
included) and the kernel alone (``kernel_launch``: one ctypes call a
launch on prepared planes, the device's time); each prints its relative
L2 and per-target error against the float64 plain version, whether two
launches are equal bit for bit, its launch shape and registers
(``-Xptxas -v``).  Then ``redesign`` and ``original`` at each site under
``torch.profiler``: the device time of each of their kernels a call,
against the call's time by CUDA events and the host's enqueue.  With
``--parent DIR`` (a checkout of the parent) it also compares the SASS of
K1 and K3-K5 (``p3m_short.cu``, ``p3m_columns.cu``, ``pm_supercell.cu``)
built from both trees (``cuobjdump -sass``).  JSON to ``--out`` (default
``output/k6_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_torch import _kernels  # noqa: E402
from nbody_torch.forces import p3m as P  # noqa: E402

BUILD = os.path.join(ROOT, "output", "k6_ablation")
ORIGINAL = os.path.join(ROOT, "scripts", "torch_k6_original.cu")
CU = "p3m_cells.cu"

SYNC = (CU, """  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d),
               "l"(src));""", "  *dst = __ldg(src);")
NO_PACKING = (CU, "const int L = few ? (c > 0 ? 32 / c : 32) : 1;",
              "const int L = 1;")
IEEE = (CU, "short_weight<SPLIT, SOFT, true>(r2, p)",
        "short_weight<SPLIT, SOFT, false>(r2, p)")
NARROWED = (CU, "      cnt = counts_j[scell];",
            "      cnt = lane == 26 ? 0 : counts_j[scell];")
# the weight deferred: a first pass marks this lane's sources of the tile
# inside r_cut, a bit each, and a second runs the weight on those alone
# (the warp then runs the most marks of its lanes, not every visit where
# some lane is inside)
ONE_PASS = """      if (L == 1) {
#pragma unroll 4
        for (int k = 0; k < n; ++k)
          if (inside(tile[k], xi, yi, zi, rc2))
            add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      } else {
        for (int k = l; k < n; k += L)
          if (inside(tile[k], xi, yi, zi, rc2))
            add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      }
"""
TWO_PASSES = (CU, ONE_PASS, """      unsigned near = 0;
      if (L == 1) {
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          if (k < n) near |= inside(tile[k], xi, yi, zi, rc2) << k;
      } else {
        for (int k = l; k < n; k += L)
          near |= inside(tile[k], xi, yi, zi, rc2) << k;
      }
      if (!live) near = 0;
      while (near) {
        const int k = __ffs(near) - 1;
        near &= near - 1;
        add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      }
""")
# K1's Newton form: with the cubic-spline softening, a pair beyond its
# support h takes the Newton form alone (the same value)
NEWTON = (CU, """  const float w = v.w * nbody_kernels::short_weight<SPLIT, SOFT, true>(r2, p);""",
          """  float w;
  if (SOFT == 1 && r2 >= p.h * p.h) {
    Params q = p;
    q.h = 0.0f;
    w = v.w * nbody_kernels::short_weight<SPLIT, 1, true>(r2, q);
  } else {
    w = v.w * nbody_kernels::short_weight<SPLIT, SOFT, true>(r2, p);
  }""")
REGS_42 = (CU, "__launch_bounds__(32 * kMaxWarps)",
           "__launch_bounds__(32 * kMaxWarps, 3)")
# the cull: the warp's target box once an item, each staged tile's
# 8-source sub-tile boxes by shuffles, and the inside test skipped on the
# sub-tiles out of reach (the sources sorted within their cells by the
# wrapper)
CULL = [
    (CU, """    float ax = 0.0f, ay = 0.0f, az = 0.0f;

    int cur = 0;""", """    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    float tlo[3] = {live ? xi : 3e38f, live ? yi : 3e38f, live ? zi : 3e38f};
    float thi[3] = {live ? xi : -3e38f, live ? yi : -3e38f,
                    live ? zi : -3e38f};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int o = 1; o < 32; o <<= 1) {
        tlo[a] = fminf(tlo[a], __shfl_xor_sync(kFull, tlo[a], o));
        thi[a] = fmaxf(thi[a], __shfl_xor_sync(kFull, thi[a], o));
      }
    const float reach2 = p.r_cut2 * (1.0f + 1e-4f);

    int cur = 0;"""),
    (CU, ONE_PASS, """      unsigned keep;
      {
        const float4 v = tile[min(lane, n - 1)];
        float lo[3] = {v.x, v.y, v.z}, hi[3] = {v.x, v.y, v.z};
        float g2 = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          for (int o = 1; o < 8; o <<= 1) {
            lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
            hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
          }
          const float gap = fmaxf(fmaxf(lo[a] - thi[a], tlo[a] - hi[a]), 0.0f);
          g2 += gap * gap;
        }
        keep = __ballot_sync(kFull, lane % 8 == 0 && lane < n && g2 < reach2);
      }
      for (int st = 0; st < n; st += 8) {
        if (!((keep >> st) & 1u)) continue;
        const int end = min(n, st + 8);
        for (int k = st + (L == 1 ? 0 : (l + L - st % L) % L); k < end;
             k += L)
          if (inside(tile[k], xi, yi, zi, rc2))
            add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      }
"""),
]


class Variant(NamedTuple):
    """Patches (file, old, new, each to match once; None:
    ``scripts/torch_k6_original.cu``), the warps a block (None: the
    geometry's), and whether the wrapper sorts the sources in their cells
    (the cull)."""

    patches: list | None
    warps: int | None = None
    sorted_sources: bool = False


VARIANTS = {
    "redesign": Variant([]),
    "original": Variant(None),
    **{f"W {w}": Variant([], warps=w) for w in P.K6_WARPS},
    "synchronous staging": Variant([SYNC]),
    "no target packing": Variant([NO_PACKING]),
    "IEEE weight": Variant([IEEE]),
    "two passes": Variant([TWO_PASSES]),
    "42 registers": Variant([REGS_42]),
    "Newton form": Variant([NEWTON]),
    "cull": Variant(CULL, sorted_sources=True),
    "narrowed": Variant([NARROWED]),
}
ENTRY = {"p3m_cells_f32": "ppppiiiiidddiiipp", "p3m_cells_info": "iip"}
ORIGINAL_ENTRY = {"p3m_cells_f32": "ppppiiiidddiipp"}
# variants that share the redesign's source build once
SAME_SOURCE = {name for name, v in VARIANTS.items()
               if v.patches == [] and name != "redesign"}


def source_tag(name: str) -> str:
    return "k6_" + re.sub(r"\W+", "_", name).strip("_")


def variant_dir(name: str) -> str:
    """A copy of csrc/ with the variant's patches applied."""
    out = os.path.join(BUILD, source_tag(name))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_kernels.SOURCE_DIR, out)
    patches = VARIANTS[name].patches
    if patches is None:
        shutil.copy(ORIGINAL, os.path.join(out, CU))
        return out
    for fname, old, new in patches:
        path = os.path.join(out, fname)
        src = open(path).read()
        hits = src.count(old)
        if hits != 1:
            raise RuntimeError(f"{name}: the patch does not apply to "
                               f"{fname}: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return out


def build_all(names) -> dict:
    """{name: (so, ptxas log)}, the builds started together; the launch
    shape variants share the redesign's build."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in {("redesign" if n in SAME_SOURCE else n) for n in names}:
        d = variant_dir(name)
        so = os.path.join(BUILD, source_tag(name) + ".so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(d, CU)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (so, log)
    return {n: built["redesign" if n in SAME_SOURCE else n] for n in names}


def load(name: str, so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for fn, sig in (ORIGINAL_ENTRY if name == "original" else ENTRY).items():
        f = getattr(lib, fn)
        f.argtypes = [_kernels._CTYPES[c] for c in sig]
        f.restype = ctypes.c_int
    return lib


def load_variants(names) -> dict:
    """{name: (library, ptxas log)} of the variants ``names``, built now."""
    return {name: (load(name, so), log)
            for name, (so, log) in build_all(names).items()}


def _common(kw: dict) -> tuple:
    """(plane, counts, plane_j, counts_j, K_j) of ``run_cell_plane``'s
    keywords ``kw``."""
    plane, counts = kw["plane"], kw["counts"]
    if "plane_j" in kw:
        return plane, counts, kw["plane_j"], kw["counts_j"], kw["K_j"]
    return plane, counts, plane, counts, kw["K"]


def sort_in_cells(plane_j, counts_j, K_j: int, cell: float):
    """A copy of the source plane whose stored sources of each cell are
    sorted by the Morton key of their place in the cell (a 4^3 grid of
    side ``cell`` / 4), the cull's order; the sentinels stay behind."""
    slots = plane_j.shape[1]
    rank = torch.arange(slots, device=plane_j.device) % K_j
    cid = torch.arange(slots, device=plane_j.device) // K_j
    live = rank < counts_j.to(torch.int64).repeat_interleave(K_j)
    sub = torch.clamp((torch.remainder(plane_j[0:3] / cell, 1.0) * 4).to(
        torch.int64), 0, 3)
    key = torch.zeros(slots, dtype=torch.int64, device=plane_j.device)
    for b in range(2):
        for a in range(3):
            key |= ((sub[a] >> b) & 1) << (3 * b + 2 - a)
    key = torch.where(live, key, 64 + rank)
    order = torch.argsort(cid * (K_j + 64) + key, stable=True)
    return plane_j[:, order].contiguous()


def variant_geometry(name: str, lib, kw: dict) -> P.K6Geometry:
    """The variant's launch shape: ``k6_geometry``'s, with its own warps
    a block where it sets them."""
    info = P._k6_info(lib, kw["plane"].device.index,
                      P._SPLITS[kw["split"]], P._SOFTENINGS[kw["softening"]])
    geo = P.k6_geometry(kw["nx"], kw["ncell"], info)
    w = VARIANTS[name].warps
    if w is None:
        return geo
    return geo._replace(warps=w, blocks_per_sm=info[2 + P.K6_WARPS.index(w)])


def _original_call(lib, kw: dict):
    """K6 before its redesign, through its own wrapper (the parent's
    ``run_cell_plane``: each plane's geometry checked, the plane's twice
    in the one-plane form, a device context, the output zero-filled)."""
    plane, counts, plane_j, counts_j, K_j = _common(kw)
    M = kw["ncell"] + 2
    ncells = (kw["nx"] + 2) * M * M
    for name, p, c, k in (("plane", plane, counts, kw["K"]),
                          ("plane_j", plane_j, counts_j, K_j)):
        P._check_cell_plane(f"original {name}", p, c, ncells, k,
                            plane.device, 1)
    out = torch.zeros_like(plane)
    with torch.cuda.device(plane.device):
        err = lib.p3m_cells_f32(
            plane.data_ptr(), plane_j.data_ptr(), counts.data_ptr(),
            counts_j.data_ptr(), kw["nx"], kw["ncell"], kw["K"], K_j,
            math.sqrt(float(kw["eps2"])), float(kw["r_s"]),
            float(kw["r_cut"]), P._SPLITS[kw["split"]],
            P._SOFTENINGS[kw["softening"]], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"original K6: launch failed (error {err})")
    return out


def variant_call(name: str, lib, kw: dict, box: float | None = None):
    """One call of variant ``name`` (library ``lib``) on the card, through
    the port's wrapper code: ``run_cell_plane``'s work (the cull's also
    sorts the sources in their cells of side ``box`` / ncell)."""
    if name == "original":
        return _original_call(lib, kw)
    plane, counts, plane_j, counts_j, K_j = _common(kw)
    if VARIANTS[name].sorted_sources:
        plane_j = sort_in_cells(plane_j, counts_j, K_j, box / kw["ncell"])
    M = kw["ncell"] + 2
    ncells = (kw["nx"] + 2) * M * M
    P._check_cell_plane("variant plane", plane, counts, ncells, kw["K"],
                        plane.device, 1)
    geo = variant_geometry(name, lib, kw)
    return P._k6_run(lib, geo, plane, counts, plane_j, counts_j,
                     **{k: kw[k] for k in ("nx", "ncell", "K", "eps2", "r_s",
                                           "r_cut", "split", "softening")},
                     K_j=K_j)


def kernel_launch(name: str, lib, kw: dict, box: float | None = None):
    """(a function that launches variant ``name``'s kernel alone: one
    ctypes call on prepared planes and output, no torch op, so its time
    is the device's; the launch shape; what it keeps alive)."""
    plane, counts, plane_j, counts_j, K_j = _common(kw)
    stream = torch.cuda.current_stream().cuda_stream
    args = (kw["nx"], kw["ncell"], kw["K"], K_j,
            math.sqrt(float(kw["eps2"])), float(kw["r_s"]),
            float(kw["r_cut"]), P._SPLITS[kw["split"]],
            P._SOFTENINGS[kw["softening"]])
    if name == "original":
        out = torch.zeros_like(plane)
        ptrs = (plane.data_ptr(), plane_j.data_ptr(), counts.data_ptr(),
                counts_j.data_ptr())
        return (lambda: lib.p3m_cells_f32(*ptrs, *args, out.data_ptr(),
                                          stream), None, (out,))
    if VARIANTS[name].sorted_sources:
        plane_j = sort_in_cells(plane_j, counts_j, K_j, box / kw["ncell"])
    geo = variant_geometry(name, lib, kw)
    out = torch.empty_like(plane)
    ptrs = (plane.data_ptr(), plane_j.data_ptr(), counts.data_ptr(),
            counts_j.data_ptr())
    return (lambda: lib.p3m_cells_f32(*ptrs, 1, *args, geo.warps,
                                      out.data_ptr(), stream), geo,
            (out, plane_j))


def target_err(got, ref) -> float:
    d = (got[:3].double() - ref[:3]).norm(dim=0)
    r = ref[:3].norm(dim=0)
    return float(d.max() / r[r > 0].square().mean().sqrt())


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
    """ptxas's registers of each cell_kernel instance."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "cell_kernel" in fn:
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
    """{site: ([run_cell_plane's keywords, one a launch], box)}, the
    inputs of ``chip_smoke.py``'s K6 checks."""
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation

    cs = chip_smoke()
    cfg = SimulationConfig(output=OutputConfig(snapshot=False))
    r32 = cfg.replace(rungs=3)
    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    out = {}
    ics32 = realize_ics(cfg, 0)
    box = {"ics64": cfg64.box, "replicated": cfg64.box}
    if names & {"late32", "late32-two"}:
        work = os.path.join(ROOT, "output", "k6_ablation_run")
        shutil.rmtree(work, ignore_errors=True)
        late = run_simulation(cfg, 0, work).state
        act = cs.rung_mask(late, r32)
        one = cs.k6_one_device_launches(late, act, r32)
        out["late32"] = one["one-plane"]
        out["late32-two"] = one["two-plane"]
    if "ics32" in names:
        out["ics32"] = cs.k6_one_device_launches(
            ics32, torch.zeros(cfg.n_particles, dtype=torch.bool,
                               device="cuda"), r32)["one-plane"]
    if "ics64" in names:
        ics64 = realize_ics(cfg64, 0)
        out["ics64"] = cs.k6_one_device_launches(
            ics64, torch.zeros(cfg64.n_particles, dtype=torch.bool,
                               device="cuda"),
            cfg64.replace(rungs=3))["one-plane"]
    if "slab" in names:
        out["slab"] = cs.k6_slab_launches(ics32, cfg)[0]
    if "masked-slab" in names:
        c32c = r32.replace(devices=cs.DOMAIN_SHARDS, column_skin=0.0)
        res, _ = cs.domain_rung_run(c32c, "k6_ablation")
        out["masked-slab"] = cs.k6_masked_slab_launches(
            res.state, cs.rung_mask(res.state, c32c.replace(devices=1)),
            c32c, res.config_run.rung_capacity or 128)[0]
    if "replicated" in names:
        out["replicated"] = cs.k6_replicated_launches(
            realize_ics(cfg64, 0), cfg64)[0]
    return {k: (out[k], box.get(k, cfg.box)) for k in names if k in out}


def sass(obj: str) -> str:
    """The object's SASS from its first function on, with the mangled
    anonymous-namespace prefix (a hash of the source's path) masked."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    text = text[text.find("Function :"):]
    return re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                  "_ANON_", text)


def sass_check(parent: str) -> dict:
    """K1's and K3-K5's sources built from this tree and from ``parent``:
    is each object's SASS the same?"""
    os.makedirs(BUILD, exist_ok=True)
    srcs = ("p3m_short.cu", "p3m_columns.cu", "pm_supercell.cu")
    jobs = {}
    for tree, root in (("this", str(_kernels.SOURCE_DIR)),
                       ("parent", os.path.join(parent, "nbody_torch",
                                               "forces", "csrc"))):
        for src in srcs:
            obj = os.path.join(BUILD, f"sass_{tree}_{src}.o")
            cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(root, src)]
            jobs[(tree, src)] = (obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for key, (obj, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    return {src: sass(jobs[("this", src)][0]) == sass(jobs[("parent", src)][0])
            for src in srcs}


def stage_times(fn, calls: int = 20) -> tuple[dict, float, float]:
    """({kernel: device ms a call}, ms a call by CUDA events, host ms a
    call: the enqueue, with no synchronisation inside) of ``fn`` under
    torch.profiler."""
    import time

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
    ap.add_argument("--sites", default="ics32,late32,ics64,late32-two,slab,"
                                       "masked-slab,replicated")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k6_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_ablation: needs a CUDA card")
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
        same = sass_check(args.parent)
        results["k1_k3_k5_sass_same"] = same
        print(f"K1 and K3-K5 SASS against the parent's: {same}", flush=True)
    libs = load_variants(names)
    data = sites(set(args.sites.split(",")))
    for site, (kws, box) in data.items():
        ref = [P.cell_plane_plain(**{**kw, "plane": kw["plane"].double(),
                                     **({"plane_j": kw["plane_j"].double()}
                                        if "plane_j" in kw else {})})
               for kw in kws]
        times = {name: [] for name in names}
        ktimes = {name: [] for name in names}
        rows = {}
        for rnd in range(args.rounds):
            for name in names:
                lib = libs[name][0]

                def call(name=name, lib=lib):
                    return [variant_call(name, lib, kw, box) for kw in kws]

                times[name].append(time_ms(call, 20) / len(kws))
                kern = [kernel_launch(name, lib, kw, box) for kw in kws]
                ktimes[name].append(time_ms(
                    lambda: [k[0]() for k in kern], 20) / len(kws))
                if rnd:
                    continue
                got, again = call(), call()
                torch.cuda.synchronize()
                geo = kern[0][1]
                rows[name] = dict(
                    rel_l2=max(float((g.double() - r).norm() / r.norm())
                               for g, r in zip(got, ref)),
                    target_err=max(target_err(g, r)
                                   for g, r in zip(got, ref)),
                    bit_equal=all(torch.equal(g, a)
                                  for g, a in zip(got, again)),
                    registers=registers(libs[name][1]),
                    geometry=geo._asdict() if geo else None)
                del kern
        kw = kws[0]
        targets = sum(int(kw["counts"][P._real_cells(
            kw["nx"], kw["ncell"], kw["counts"].device)].sum()) for kw in kws)
        print(f"{site}: {len(kws)} launch(es) of {kw['nx']} x "
              f"{kw['ncell']}^2 cells, K {kw['K']}"
              + (f", source K {kw['K_j']}" if "K_j" in kw else "")
              + f"; {targets} targets", flush=True)
        base = (statistics.median(ktimes["redesign"])
                if "redesign" in ktimes else None)
        for name in names:
            row = rows[name]
            row["ms"] = statistics.median(times[name])
            row["ms_rounds"] = times[name]
            row["kernel_ms"] = statistics.median(ktimes[name])
            row["kernel_ms_rounds"] = ktimes[name]
            geo = row["geometry"]
            shape = (f"{geo['blocks']} blocks of {geo['warps']} warps, "
                     f"{geo['blocks_per_sm']} resident/SM" if geo else
                     "a 64-thread block a cell")
            vs = (f" ({row['kernel_ms'] / base:.3f}x the redesign's)" if base
                  else "")
            print(f"  {name}: kernel {row['kernel_ms']:.4f} ms{vs}; the whole "
                  f"call {row['ms']:.4f} ms; kernel rounds "
                  f"{', '.join(f'{t:.4f}' for t in ktimes[name])}; rel L2 "
                  f"{row['rel_l2']:.3e}, per target {row['target_err']:.3e}, "
                  f"{'bit-equal' if row['bit_equal'] else 'NOT bit-equal'}; "
                  f"{shape}; registers {row['registers']}", flush=True)
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
            print(f"  {name} by kernel (torch.profiler, device ms a launch; "
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
