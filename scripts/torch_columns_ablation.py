"""Where the column pair sum's time goes, on one GPU: K3 and K5 against
variants of the loop they share.

    python scripts/torch_columns_ablation.py [--reps 10] [--rounds 3]
        [--variants a,b] [--sites a,b] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/`` with one change
(patches of ``column_pairs.cuh`` and, for R, of the two kernel files),
built with nvcc (one process a
variant, all started together) into ``output/columns_ablation/``
(git-ignored), loaded with ctypes and launched through the port's own
launches (``p3m_columns.launch_columns``, ``pm_supercell.launch_fused``).
Variants:

* ``redesign``: the source as it is (128 targets a block, one a thread,
  the reach search, the per-warp culling of 32-source sub-tiles, the
  cutoff branch around the Newton form of the weight beyond the
  softening, 512-source tiles, probes every 32 slots);
* ``original``: the whole window, the shared weight and 128-source
  tiles together: the design before the redesign;
* ``R = 2``, ``R = 4``: two or four targets a thread (64 or 32 threads
  a block);
* ``64 targets``: blocks of 64 targets (a narrower reach, 64 threads);
* ``no search``: the whole window, culled by the z of the sources loaded
  alone (what the search saves over culling);
* ``no cull``: the reach search without the per-warp culling;
* ``marked``, ``predicated``: in place of the cutoff branch, each lane
  marks its sources inside r_cut (a 32-bit mask a sub-tile) and the warp
  works through the marks a lane at a time; or the weight on every visit
  with the result selected;
* ``shared weight``: short_weight.cuh's weight on every pair, not its
  Newton form beyond the softening's support;
* ``tile 128``, ``tile 256``, ``fence 128``: 128- or 256-source tiles;
  probes every 128 slots;
* ``narrowed``: the reach cut by r_cut / 2 (wrong: a planted fault that
  the per-target gate of ``chip_smoke.py`` must catch).

Sites, at the geometry the driver gives each (``chip_smoke.py``'s
helpers): K3 on the cfg64 ICs and on the final state of the cfg64 run;
K5 on the plan of the cfg64 ``rungs=3`` run frozen at the ICs, drifted by
0.999 skin/2, its active chunks those of the run's final state; K3's
slab site on the four shards' planes of the cfg64 ICs and K5's on the
shards' frozen plans of the final state of the cfg64 ``devices=4,
rungs=3`` run at 0.999 skin/2 (times a launch: the mean over the four).
Every variant is timed in each of ``--rounds`` rounds, in turn with the
others (CUDA events around ``--reps`` launches after a warm-up), and the
median is kept; the SM clock and power are sampled while the rounds run.
Each variant's errors against the float64 plain version: relative L2 and
the largest per-target error over the force scale (``chip_smoke.
target_err``), and whether two launches are equal bit for bit.  Prints
one line per site and variant and writes everything as JSON to ``--out``
(default ``output/columns_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_torch import _kernels  # noqa: E402
from nbody_torch.forces import p3m_columns as pc  # noqa: E402
from nbody_torch.forces import pm_supercell as ps  # noqa: E402

BUILD = os.path.join(ROOT, "output", "columns_ablation")
HEADER = "column_pairs.cuh"
ENTRY_POINTS = ("p3m_columns_f32", "p3m_columns_masked_f32",
                "pm_supercell_fused_f32")


def knob(name: str, old: int, new: int) -> tuple[str, str, str]:
    return (HEADER, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


def predicated() -> list:
    """The weight on every visit, the result selected by the cutoff."""
    return [(HEADER, """    if (fmaxf(r2, 1e-30f) < p.r_cut2) {
      const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
      t.ax += w * dx;
      t.ay += w * dy;
      t.az += w * dz;
    }""", """    const float wt = pair_weight<SPLIT, SOFT>(r2, p);
    const float w = fmaxf(r2, 1e-30f) < p.r_cut2 ? v.w * wt : 0.0f;
    t.ax += w * dx;
    t.ay += w * dy;
    t.az += w * dz;""")]


def marked() -> list:
    """Each lane marks its sources inside r_cut in a 32-bit mask, then the
    warp works through the marks a lane at a time."""
    return [(HEADER, """#pragma unroll 8
  for (int u = 0; u < 32; ++u) {
    const float4 v = s[u];
    const float dx = v.x - t.x;""", """  unsigned mask = 0u;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const float dx = s[u].x - t.x;
    const float dy = s[u].y - t.y;
    const float dz = s[u].z - t.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    mask |= (fmaxf(r2, 1e-30f) < p.r_cut2 ? 1u : 0u) << u;
  }
  while (__any_sync(0xffffffffu, mask != 0u)) {
    if (mask == 0u) continue;
    const int u = __ffs(mask) - 1;
    mask &= mask - 1u;
    const float4 v = s[u];
    const float dx = v.x - t.x;"""),
            (HEADER, """    if (fmaxf(r2, 1e-30f) < p.r_cut2) {
      const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
      t.ax += w * dx;
      t.ay += w * dy;
      t.az += w * dz;
    }""", """    {
      const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
      t.ax += w * dx;
      t.ay += w * dy;
      t.az += w * dz;
    }""")]


def per_thread(R: int) -> list:
    """R targets a thread (kColTargets / R threads a block): a source read
    from shared memory serves R pairs, and a warp owns 32 R consecutive
    target slots."""
    return [
        ("p3m_columns.cu", "const size_t i = nbody_kernels::target_slot(first);",
         "const size_t i = first;"),
        ("pm_supercell.cu", "const size_t i = nbody_kernels::target_slot(first);",
         "const size_t i = first;"),
        (HEADER, "constexpr int kColThreads = kColTargets;",
         f"constexpr int kColPerThread = {R};\n"
         "constexpr int kColThreads = kColTargets / kColPerThread;"),
        (HEADER, """struct ColumnTarget {
  float x, y, z;
  float ax, ay, az;
};""", """struct ColumnTarget {
  float x[kColPerThread], y[kColPerThread], z[kColPerThread];
  float ax[kColPerThread], ay[kColPerThread], az[kColPerThread];
};""" ),
        (HEADER, """__device__ __forceinline__ size_t target_slot(size_t first) {
  return first + threadIdx.x;
}""", """__device__ __forceinline__ size_t target_slot(size_t first, int r) {
  return first + (threadIdx.x / 32) * (32 * kColPerThread) + r * 32 +
         threadIdx.x % 32;
}"""),
        (HEADER, """  return ColumnTarget{plane[i], plane[g.row + i], plane[2 * g.row + i],
                      0.0f, 0.0f, 0.0f};""", """  ColumnTarget t;
#pragma unroll
  for (int r = 0; r < kColPerThread; ++r) {
    const size_t j = target_slot(i, r);
    t.x[r] = plane[j];
    t.y[r] = plane[g.row + j];
    t.z[r] = plane[2 * g.row + j];
    t.ax[r] = t.ay[r] = t.az[r] = 0.0f;
  }
  return t;"""),
        (HEADER, """    const float4 v = s[u];
    const float dx = v.x - t.x;
    const float dy = v.y - t.y;
    const float dz = v.z - t.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (fmaxf(r2, 1e-30f) < p.r_cut2) {
      const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
      t.ax += w * dx;
      t.ay += w * dy;
      t.az += w * dz;
    }""", """    const float4 v = s[u];
#pragma unroll
    for (int r = 0; r < kColPerThread; ++r) {
      const float dx = v.x - t.x[r];
      const float dy = v.y - t.y[r];
      const float dz = v.z - t.z[r];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (fmaxf(r2, 1e-30f) < p.r_cut2) {
        const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
        t.ax[r] += w * dx;
        t.ay[r] += w * dy;
        t.az[r] += w * dz;
      }
    }"""),
        (HEADER, """  const bool real = t.z >= g.zlow && t.z <= g.zhigh;
  const float wmin = warp_min(real ? t.z : CUDART_INF_F);
  const float wmax = warp_max(real ? t.z : -CUDART_INF_F);""",
         """  float tmin = CUDART_INF_F, tmax = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < kColPerThread; ++r) {
    if (t.z[r] >= g.zlow && t.z[r] <= g.zhigh) {
      tmin = fminf(tmin, t.z[r]);
      tmax = fmaxf(tmax, t.z[r]);
    }
  }
  const float wmin = warp_min(tmin);
  const float wmax = warp_max(tmax);"""),
        ("p3m_columns.cu", """  out[i] = t.ax;
  out[g.row + i] = t.ay;
  out[2 * g.row + i] = t.az;
}""", """#pragma unroll
  for (int r = 0; r < nbody_kernels::kColPerThread; ++r) {
    const size_t j = nbody_kernels::target_slot(i, r);
    out[j] = t.ax[r];
    out[g.row + j] = t.ay[r];
    out[2 * g.row + j] = t.az[r];
  }
}"""),
        ("pm_supercell.cu", """  // PM force at the target (the TPU kernel's first-neighbour visit)
  const float xr = __fsub_rn(__fmul_rn(t.x, scale),""",
         """  float3 pms[nbody_kernels::kColPerThread];
#pragma unroll
  for (int r = 0; r < nbody_kernels::kColPerThread; ++r) {
  const float xr = __fsub_rn(__fmul_rn(t.x[r], scale),"""),
        ("pm_supercell.cu", """  const float yr = __fsub_rn(__fmul_rn(t.y, scale), static_cast<float>(y0));
  const float zr = __fmul_rn(t.z, scale);""",
         """  const float yr = __fsub_rn(__fmul_rn(t.y[r], scale), static_cast<float>(y0));
  const float zr = __fmul_rn(t.z[r], scale);"""),
        ("pm_supercell.cu", """  if (!SPLIT_OUT) {
    t.ax = pm.x;
    t.ay = pm.y;
    t.az = pm.z;
  }
  nbody_kernels::column_pair_sum<SPLIT, SOFT>(plane, ws, g, ic, k, t, p, sh);
  out[i] = t.ax;
  out[g.row + i] = t.ay;
  out[2 * g.row + i] = t.az;
  if (SPLIT_OUT) {
    out[3 * g.row + i] = pm.x;
    out[4 * g.row + i] = pm.y;
    out[5 * g.row + i] = pm.z;
  }
}""", """  if (!SPLIT_OUT) {
    t.ax[r] = pm.x;
    t.ay[r] = pm.y;
    t.az[r] = pm.z;
  }
  pms[r] = pm;
  }
  nbody_kernels::column_pair_sum<SPLIT, SOFT>(plane, ws, g, ic, k, t, p, sh);
#pragma unroll
  for (int r = 0; r < nbody_kernels::kColPerThread; ++r) {
    const size_t j = nbody_kernels::target_slot(i, r);
    out[j] = t.ax[r];
    out[g.row + j] = t.ay[r];
    out[2 * g.row + j] = t.az[r];
    if (SPLIT_OUT) {
      out[3 * g.row + j] = pms[r].x;
      out[4 * g.row + j] = pms[r].y;
      out[5 * g.row + j] = pms[r].z;
    }
  }
}"""),
    ]


REACH = "g.reach = static_cast<float>(r_cut * (1.0 + 1e-5) + 4.0 * quantum);"
VARIANTS = {
    "redesign": [],
    "original": [knob("kColTile", 512, 128), knob("kColSearch", 1, 0),
                 knob("kColCull", 1, 0), knob("kColNewton", 1, 0)],
    "R = 2": per_thread(2),
    "R = 4": per_thread(4),
    "64 targets": [knob("kColTargets", 128, 64)],
    "no search": [knob("kColSearch", 1, 0)],
    "no cull": [knob("kColCull", 1, 0)],
    "marked": marked(),
    "predicated": predicated(),
    "shared weight": [knob("kColNewton", 1, 0)],
    "tile 128": [knob("kColTile", 512, 128)],
    "tile 256": [knob("kColTile", 512, 256)],
    "fence 128": [knob("kColFence", 32, 128)],
    "narrowed": [(HEADER, REACH,
                  REACH.replace("r_cut * (1.0 + 1e-5)", "r_cut * 0.5"))],
}
#: variants whose numbers are wrong by design (not timed against the rest)
PLANTED = ("narrowed",)


def variant_sources(changes) -> dict:
    """{file name: text} of the kernel sources with ``changes`` (file,
    old, new) applied, each ``old`` exactly once, in order."""
    srcs = {f: open(os.path.join(_kernels.SOURCE_DIR, f)).read()
            for f in os.listdir(_kernels.SOURCE_DIR)
            if f.endswith((".cu", ".cuh"))}
    for name, old, new in changes:
        if srcs[name].count(old) != 1:
            raise RuntimeError(f"the patch does not apply to {name}: {old!r}")
        srcs[name] = srcs[name].replace(old, new)
    return srcs


def source_tag(changes) -> str:
    if not changes:
        return "cols"
    digest = hashlib.sha256(repr(changes).encode()).hexdigest()[:12]
    return f"cols_{digest}"


def build_all(names=VARIANTS) -> dict:
    """The distinct sources of the variants ``names``, built in parallel,
    each into a directory of its own: {tag: (so, ptxas log)}."""
    procs = {}
    for name in names:
        changes = VARIANTS[name]
        tag = source_tag(changes)
        if tag in procs:
            continue
        work = os.path.join(BUILD, tag)
        os.makedirs(work, exist_ok=True)
        for src, text in variant_sources(changes).items():
            with open(os.path.join(work, src), "w") as f:
                f.write(text)
        so = os.path.join(work, f"{tag}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(work, "p3m_columns.cu"),
               os.path.join(work, "pm_supercell.cu")]
        procs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        built[tag] = (so, log)
    return built


def load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [_kernels._CTYPES[c] for c in _kernels._ENTRY_POINTS[name]]
        fn.restype = ctypes.c_int
    return lib


def load_variants(names) -> dict:
    """{name: (library, ptxas log)} of the variants ``names``."""
    built = build_all(names)
    return {name: (load(built[source_tag(VARIANTS[name])][0]),
                   built[source_tag(VARIANTS[name])][1]) for name in names}


def registers(log: str) -> dict:
    """ptxas's registers of the spline/spline K3 (unfused PM form) and
    K5 kernels."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            if "fused_kernelILi1ELi1ELb0ELb0E" in fn:
                out["K3"] = int(m.group(1))
            if "column_kernel_maskedILi1ELi1E" in fn:
                out["K5"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# The sites: each a launch of one library and its float64 plain version
# ---------------------------------------------------------------------------


def k3_site(cs, state, config, cfg_run, prewarm: bool) -> dict:
    """K3 (PM readback + pair sum, rows 0-2) on the supercell plane of
    ``state`` at the driver's geometry, on the real force grids."""
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    box, nmesh = config.box, config.mesh_size
    knobs, plane, ws, nch, counts, geo = cs.driver_plane(state, config,
                                                         cfg_run, prewarm)
    kw = cs._pair_kw(config, geo)
    S, _ = supercell_geometry(nmesh, geo["ncell"])
    rho = supercell_deposit_from_plane(plane, counts, box=box, nmesh=nmesh,
                                       ncell=geo["ncell"],
                                       stride=geo["stride"], gz=geo["gz"])
    mass_sum = torch.sum(state.mass)
    pm = pm_module(box, nmesh, config.deconvolve_p, False,
                   kw["r_s"] if config.force_split == "gaussian" else 0.0,
                   kw["r_cut"] if config.force_split == "spline" else 0.0,
                   config.pm_gradient, 0.0, plane.device, torch.float32)
    grids = pm.force_grids_from_rho(rho, 4.0 * math.pi * mass_sum / box**3,
                                    mass_sum).contiguous()
    fkw = dict(S=S, scale=nmesh / box, split_out=False, interlaced=False,
               row0=0, **kw)
    return dict(
        knobs=knobs, planes=[(plane, ws, nch)],
        launch=lambda lib: [ps.launch_fused(
            lib, plane, ws, nch, grids, nx=geo["ncell"], box=box, drift=None,
            **fkw)],
        plain=lambda: [ps.fused_column_plane_plain(
            plane.double(), ws, nch, grids.double(), nx=geo["ncell"],
            **fkw)],
        reach=[dict(plane=plane, ws=ws, nch=nch, box=box,
                    r_cut=kw["r_cut"], **geo)])


def k5_site(cs, state, act, config, cfg_run, frac: float) -> dict:
    """K5 on the plan frozen at ``state`` (the driver's frozen geometry),
    drifted by frac * skin/2, for the chunks that hold an ``act``
    particle."""
    plan, moved, geo, g = cs._frozen_setup(state, cfg_run, frac)
    box = config.box
    plane, interior, drift = pc.frozen_plane(moved, state.mass, plan, box,
                                             g["r_cut"], geo["ncell"],
                                             g["CK"], geo["gz"], geo["stride"])
    nch_act, cht = pc.active_chunk_table(
        act, plan, interior, CK=g["CK"], ncell=geo["ncell"], gz=geo["gz"],
        maxch=geo["maxch"], chunk=geo["chunk"])
    kw = cs._pair_kw(config, geo)
    knobs = (f"capacity {g['CK']}, window {geo['W']}, skin {g['skin']:.4f} "
             f"Mpc (measured drift {float(drift):.4f}), {int(nch_act.sum())} "
             f"of {int(plan.nch.sum())} chunks active")
    return dict(
        knobs=knobs, planes=[(plane, plan.ws, nch_act)],
        launch=lambda lib: [pc.launch_columns(
            lib, plane, plan.ws, nch_act, cht, nx=geo["ncell"], box=box,
            drift=drift, **kw)],
        plain=lambda: [pc.column_plane_plain(plane.double(), plan.ws,
                                             nch_act, cht=cht, **kw)],
        reach=[dict(plane=plane, ws=plan.ws, nch=nch_act, cht=cht, box=box,
                    drift=drift, r_cut=kw["r_cut"], **geo)])


def k3_slab_site(cs, state, config) -> dict:
    """K3's slab site on every shard's plane of ``state`` at the domain
    driver's supercell geometry, on slices of the whole box's force grids
    from the slab deposit."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m import supercell_ncell
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        extract_local_subgrids,
        slab_halo_fold,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    group, geom, shards, ck, cw, _ = cs.domain_setup(state, config,
                                                     "supercell")
    D, box, nmesh = group.size, config.box, config.mesh_size
    sc = supercell_ncell(box, nmesh, geom.r_cut)
    S, _ = supercell_geometry(nmesh, sc)
    nx = sc // D
    CK, gz, stride, W, maxch, chunk = pc.plane_geometry(
        box, geom.r_cut, ck, cw or pc.column_window(box, geom.r_cut, ck))
    built = td.build_local_column_plane(
        [s.pos for s in shards], [s.mass for s in shards], box=box,
        r_cut=geom.r_cut, ncell=sc, group=group, col_capacity=CK, window=W,
        chunk=chunk)
    rho = torch.cat(slab_halo_fold([supercell_deposit_from_plane(
        b[0], b[6], box=box, nmesh=nmesh, ncell=sc, stride=stride, gz=gz,
        chunk=chunk, nx=nx, row0=d * nx) for d, b in enumerate(built)],
        group))
    geo = dict(ncell=sc, stride=stride, W=W, maxch=maxch, gz=gz, chunk=chunk,
               nx=nx)
    kw = cs._pair_kw(config, geo)
    mass_sum = torch.sum(rho)
    pm = pm_module(box, nmesh, config.deconvolve_p, False,
                   kw["r_s"] if config.force_split == "gaussian" else 0.0,
                   kw["r_cut"] if config.force_split == "spline" else 0.0,
                   config.pm_gradient, 0.0, rho.device, torch.float32)
    grids = pm.force_grids_from_rho(rho, 4.0 * math.pi * mass_sum / box**3,
                                    mass_sum)
    halos = extract_local_subgrids(
        list(torch.chunk(grids.contiguous(), D, dim=1)), group)
    fkw = dict(S=S, scale=nmesh / box, split_out=True, interlaced=False, **kw)
    knobs = (f"{D} shards of {nx} x {sc} columns, capacity {CK}, window "
             f"{W}")
    return dict(
        knobs=knobs, planes=[(b[0], b[1], b[2]) for b in built],
        launch=lambda lib: [ps.launch_fused(lib, b[0], b[1], b[2], h,
                                            row0=d * nx, box=box,
                                            drift=None, **fkw)
                            for d, (b, h) in enumerate(zip(built, halos))],
        plain=lambda: [ps.fused_column_plane_plain(
            b[0].double(), b[1], b[2], h.double(), row0=d * nx, **fkw)
            for d, (b, h) in enumerate(zip(built, halos))],
        reach=[dict(plane=b[0], ws=b[1], nch=b[2], box=box,
                    r_cut=kw["r_cut"], **geo) for b in built])


def k5_slab_site(cs, res, cfg) -> dict:
    """K5's slab site on every shard's frozen local plan of ``res``'s
    final state (the domain rung run's geometry) at 0.999 skin/2, the
    targets the particles above rung 0 there."""
    from nbody_torch.forces.p3m_columns import (
        _frozen_buf,
        _local_plane_from_buf,
    )

    group, geom, shards, plans, knobs, _ = cs.frozen_slab_setup(
        res.state, cfg, res.config_run)
    D, box = group.size, cfg.box
    nxl = geom.ncell // D
    CK, gz, stride, W, maxch, chunk = pc.plane_geometry(
        box, geom.r_cut, knobs["ck"], knobs["cw"])
    act = cs.shard_rows(cs.rung_mask(res.state, cfg.replace(devices=1)),
                        res.state, box, geom.ncell, shards)
    gen = torch.Generator().manual_seed(20)
    moved = []
    for s in shards:
        u = torch.randn(tuple(s.pos.shape), generator=gen,
                        dtype=torch.float64)
        u = (u / u.norm(dim=1, keepdim=True)).to(s.pos)
        moved.append(s.pos + 0.999 * 0.5 * knobs["skin"] * u)
    frozen = [_frozen_buf(p, s.mass, pl, box, geom.r_cut, CK, gz, stride)
              for p, s, pl in zip(moved, shards, plans)]
    planes = [pl for pl, _ in _local_plane_from_buf(
        [b for b, _, _ in frozen], box=box, r_cut=geom.r_cut,
        ncell=geom.ncell, group=group, stride=stride)]
    drifts = group.pmax([f[2] for f in frozen])
    tables = [pc.active_chunk_table(a & (s.mass > 0), pl, f[1], CK=CK,
                                    nx=nxl, ncell=geom.ncell, gz=gz,
                                    maxch=maxch, chunk=chunk)
              for a, s, pl, f in zip(act, shards, plans, frozen)]
    geo = dict(ncell=geom.ncell, stride=stride, W=W, maxch=maxch, gz=gz,
               chunk=chunk, nx=nxl)
    kw = cs._pair_kw(cfg, geo)
    text = (f"{D} shards of {nxl} x {geom.ncell} columns, capacity {CK}, "
            f"window {W}, skin {knobs['skin']:.4f} Mpc (measured drift "
            f"{float(drifts[0]):.4f}), {sum(int(t[0].sum()) for t in tables)} "
            f"of {sum(int(pl.nch.sum()) for pl in plans)} chunks active")
    args = list(zip(planes, plans, tables, drifts))
    return dict(
        knobs=text, planes=[(p, pl.ws, t[0]) for p, pl, t, _ in args],
        launch=lambda lib: [pc.launch_columns(lib, p, pl.ws, t[0], t[1],
                                              box=box, drift=dr, **kw)
                            for p, pl, t, dr in args],
        plain=lambda: [pc.column_plane_plain(p.double(), pl.ws, t[0],
                                             cht=t[1], **kw)
                       for p, pl, t, _ in args],
        reach=[dict(plane=p, ws=pl.ws, nch=t[0], cht=t[1], box=box,
                    drift=dr, r_cut=kw["r_cut"], **geo)
               for p, pl, t, dr in args])


def plan_report(state, cfg_run) -> str:
    """What sets the frozen plans' capacity at ``state`` (the geometry of
    ``cfg_run``): the densest column against the capacity, and the
    largest ghost-band demand (reals within the skin-widened wrap margin
    of a column end) against the band."""
    from nbody_torch.driver.simulate import _frozen_geometry

    _, _, r_cut, ncell, ck, w, skin = _frozen_geometry(cfg_run)
    box = cfg_run.box
    CK, gz, _, _, _, _ = pc.plane_geometry(box, r_cut, ck, w)
    posw = torch.remainder(state.pos, box)
    cell = torch.clamp((posw[:, :2] * (ncell / box)).long(), 0, ncell - 1)
    col = cell[:, 0] * ncell + cell[:, 1]
    zm = 1.0001 * r_cut + 0.5 * skin
    count = [int(torch.bincount(col[sel], minlength=ncell**2).max())
             for sel in (slice(None), posw[:, 2] <= zm,
                         posw[:, 2] >= box - zm)]
    return (f"capacity {CK}, densest column {count[0]}; ghost band {gz} "
            f"slots, largest demand {max(count[1:])} within {zm:.3f} Mpc "
            f"of a column end")


def make_sites(cs, names) -> dict:
    """The sites ``names`` (``k3_ics``, ``k3_final``, ``k5``, ``k3_slab``,
    ``k5_slab``), with the runs they need."""
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation

    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    ics = realize_ics(cfg64, 0)
    out = os.path.join(ROOT, "output", "columns_ablation", "runs")
    sites = {}

    def run(cfg, tag):
        work = os.path.join(out, tag)
        shutil.rmtree(work, ignore_errors=True)
        return run_simulation(cfg, 0, work)

    if "k3_ics" in names:
        sites["k3_ics"] = k3_site(cs, ics, cfg64, cfg64, True)
    if "k3_final" in names:
        res = run(cfg64, "cfg64")
        sites["k3_final"] = k3_site(cs, res.state, cfg64, res.config_run,
                                    False)
    if "k5" in names:
        r64 = cfg64.replace(rungs=3)
        res = run(r64, "cfg64_rungs3")
        for line in cs.run_log(os.path.join(out, "cfg64_rungs3")):
            if "re-running" in line or "pre-warming" in line:
                print(f"cfg64 rungs=3 run.log: {line}", flush=True)
        for tag, st in (("ICs", ics), ("final state", res.state)):
            print(f"cfg64 rungs=3 frozen plans at the {tag}: "
                  f"{plan_report(st, res.config_run)}", flush=True)
        sites["k5"] = k5_site(cs, ics, cs.rung_mask(res.state,
                                                    res.config_run),
                              r64, res.config_run, 0.999)
    if "k3_slab" in names:
        sites["k3_slab"] = k3_slab_site(cs, ics, cfg64)
    if "k5_slab" in names:
        r64d = cfg64.replace(rungs=3, devices=cs.DOMAIN_SHARDS)
        sites["k5_slab"] = k5_slab_site(cs, run(r64d, "cfg64_d4_rungs3"),
                                        r64d)
    return sites


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sites", default="k3_ics,k3_final,k5,k3_slab,k5_slab")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "columns_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_columns_ablation: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from torch_k7_ablation import ClockSampler, time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    names = args.variants.split(",")
    libs = load_variants(names)
    for name in names:
        print(f"{name}: registers {registers(libs[name][1])}", flush=True)
    sites = make_sites(cs, args.sites.split(","))
    results = {"card": card, "sites": {}}
    for site_name, site in sites.items():
        refs = site["plain"]()
        counted = [cs.reach_visits(**r) for r in site["reach"]]
        visits, whole = (sum(c[i] for c in counted) for i in range(2))
        print(f"{site_name}: {site['knobs']}; the reach by column_reach "
              f"{visits:.4e} visits of the windows' {whole:.4e}", flush=True)
        times = {name: [] for name in names}
        errs = {}
        with ClockSampler() as clocks:
            for _ in range(args.rounds):
                for name in names:
                    lib = libs[name][0]
                    times[name].append(time_ms(lambda: site["launch"](lib),
                                               args.reps)
                                       / len(site["planes"]))
                    if name not in errs:
                        a, b = site["launch"](lib), site["launch"](lib)
                        torch.cuda.synchronize()
                        errs[name] = dict(
                            rel_l2=max(cs.rel_l2(g, r)
                                       for g, r in zip(a, refs)),
                            target_err=max(cs.target_err(g, r)
                                           for g, r in zip(a, refs)),
                            bitwise=all(torch.equal(x, y)
                                        for x, y in zip(a, b)))
        mhz = statistics.median(clocks.mhz) if clocks.mhz else float("nan")
        watts = (statistics.median(clocks.watts) if clocks.watts
                 else float("nan"))
        print(f"  SM clock median {mhz:.0f} MHz (min "
              f"{min(clocks.mhz, default=float('nan')):.0f}), power median "
              f"{watts:.1f} W", flush=True)
        base = statistics.median(times["original"]) if "original" in times \
            else float("nan")
        rows = {}
        for name in names:
            ms = statistics.median(times[name])
            # the variant's reach by column_reach, with its build's targets
            # a block and probe spacing (the whole windows without search)
            reach = sum(cs.reach_visits(lib=libs[name][0], **r)[0]
                        for r in site["reach"])
            rows[name] = dict(ms=ms, ms_rounds=times[name],
                              vs_original=base / ms, sm_mhz=mhz,
                              power_w=watts, reach_visits=reach,
                              **errs[name])
            print(f"  {name}: {ms:.4f} ms a launch ({base / ms:.2f}x the "
                  f"original's), rounds "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}; rel L2 "
                  f"{errs[name]['rel_l2']:.3e}, per-target "
                  f"{errs[name]['target_err']:.3e}, two launches "
                  f"{'equal' if errs[name]['bitwise'] else 'DIFFER'}; reach "
                  f"{reach:.4e} visits"
                  + (" (planted)" if name in PLANTED else ""), flush=True)
        results["sites"][site_name] = dict(knobs=site["knobs"],
                                           reach_visits=visits,
                                           window_visits=whole, rows=rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
