"""Where K1's time goes, on one GPU: the kernel against variants of itself.

    python scripts/torch_k1_ablation.py [--variants a,b] [--sites a,b]
        [--rounds 3] [--parent DIR] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/`` with
``p3m_short.cu`` (and, for the weight's variants, ``short_weight.cuh``)
patched by this script, built with nvcc (one process a variant, all
started together) into ``output/k1_ablation/`` (git-ignored), loaded with
ctypes and launched through the port's own wrapper code
(``p3m._k1_run``, the launch shape from ``k1_card_geometry``).  The
kernel carries only the redesign; every other design lives here as a
patch, and a patch that no longer applies stops the script.  Variants:

* ``redesign``: the source as it is (Hilbert order on a 2^5 grid, the
  tile cull, one image a tile, one target a thread, the weight under the
  cutoff branch, one-instruction rsqrt, rcp and exp, the Newton form,
  32-source tiles, 8 warps a block; source slices at the Ewald site);
* ``original``: K1 before its redesign for Hopper
  (``scripts/torch_k1_original.cu``: one target a thread, every source,
  rint on every pair, rsqrtf, the branch), with its own wrapper;
* ``no cull``: every tile visited;
* ``R 2``, ``R 4``, ``R 8``: targets a thread (the pair sum written for R,
  ``R_PAIRS``);
* ``slices x2``, ``slices /2``: twice or half the slices (the Ewald
  site);
* ``rsqrtf``; ``IEEE rcp and expf``: the weight's library calls back;
* ``predicated``, ``R 4 predicated``: the weight computed on every visit
  and selected, with 1 or 4 targets a thread;
* ``rint every pair``: no image a tile;
* ``no Newton form``;
* ``64-source tiles``; ``2 warps``, ``4 warps`` a block;
* ``Morton keys``: a Morton order in place of the Hilbert curve;
  ``2^10 grid``: the Hilbert curve on a 2^10 grid (int32 keys);
* ``narrowed``: the cull's reach cut by r_cut / 2 (a planted fault:
  ``chip_smoke.py`` requires its per-target error to fail the limit).

Sites (``--sites``): ``p3m-ics`` (``chip_smoke.py`` [3]: 32,768 uniform
positions, the default run's masses, spline split and softening),
``p3m-final`` ([5]'s final state: the default run, 142 steps, run here),
``pp-ics`` ([16]: the 32^3 ICs of ``solver='pp'``, Gaussian split, r_cut
0.4999 box).  Each variant is timed in each of ``--rounds`` rounds, in
turn with the others (CUDA events around a run of launches after a
warm-up), and the median kept, twice: the whole call (the wrapper's sort
and torch ops included, whose host time can exceed the device's) and the
pair sum alone (``kernel_launch``: one ctypes call a launch on a sort
made once, the device's time); each prints its relative L2 and
per-target error against the float64 plain version, whether two launches
are equal bit for bit, its launch shape, registers (``-Xptxas -v``) and
resident blocks, and at the P3M sites the visits of the redesign's and
the narrowed cull's plans (``k1_plan``) against the dense N x npad. Then
the redesign's launch at each site under ``torch.profiler``: the device
time of each of its kernels (the keys, the sort's, the pack, the pair
sum, the slice sum) a call, against the call's time by CUDA events (the
rest is the host's). With ``--parent DIR`` (a checkout of the parent) it
also compares the SASS of K3-K6 (``p3m_columns.cu``,
``pm_supercell.cu``, ``p3m_cells.cu``) built from both trees
(``cuobjdump -sass``): identical SASS means ``short_weight.cuh``'s
change left them as they were. JSON to
``--out`` (default ``output/k1_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
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

BUILD = os.path.join(ROOT, "output", "k1_ablation")
ORIGINAL = os.path.join(ROOT, "scripts", "torch_k1_original.cu")
CU, CUH = "p3m_short.cu", "short_weight.cuh"


def knob(name: str, old: str, new: str) -> tuple:
    return (CU, f"constexpr {name} = {old};", f"constexpr {name} = {new};")


MORTON = (CU, "  keys[i] = static_cast<Key>(hilbert3(cx, cy, cz));",
          """  auto spread = [](unsigned v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x30000FFu;
    v = (v | (v << 8)) & 0x300F00Fu;
    v = (v | (v << 4)) & 0x30C30C3u;
    return (v | (v << 2)) & 0x9249249u;
  };
  keys[i] = static_cast<Key>((spread(cx) << 2) | (spread(cy) << 1) |
                             spread(cz));""")
GRID_10 = [knob("int kKeyBits", "5", "10"),
           (CU, "using Key = short;", "using Key = int;"),
           (CU, 'static_assert(3 * kKeyBits < 16, "the keys are int16");', "")]
RSQRTF = (CUH, 'asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
          "r = rsqrtf(x);")
IEEE = [(CUH, 'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
         "r = 1.0f / x;"),
        (CUH, "APPROX ? __expf(-x * x) : expf(-x * x)", "expf(-x * x)")]
NO_CULL = (CU, "  if (!(g2 < c.reach2)) return -1;\n", "")
RINT_EVERY_PAIR = (CU, "    if (hits != 1) {", "    if (true) {")
NO_NEWTON = (CU, "  if constexpr (SOFT == 1) {\n    if (r2 >= p.h * p.h)",
             "  if constexpr (false) {\n    if (r2 >= p.h * p.h)")
PREDICATED = (CU, "    if (r2 < rc2) {\n      const float w = v.w * "
              "k1_weight<SPLIT, SOFT>(r2, p);",
              "    {\n      const float w = r2 < rc2 ? v.w * "
              "k1_weight<SPLIT, SOFT>(r2, p) : 0.0f;")
NARROWED = (CU, "  c.reach2 = static_cast<float>(reach * reach);",
            "  c.reach2 = static_cast<float>((reach - 0.5 * r_cut) *\n"
            "                                (reach - 0.5 * r_cut));")
# R targets a thread (PRED: the weight predicated): the pair sum's tile
# loop, shared memory and kernel written for R, in place of the source's
# one-target-a-thread forms (from its tile loop to k1_sum_slices), and the
# grid of 32 R targets a block
R_PAIRS = """\
// The kTile sources `s` against this thread's R targets (x, y, z), their
// images already applied (RINT: rint on every pair instead).
template <int SPLIT, int SOFT, int R, bool PRED, bool RINT>
__device__ __forceinline__ void tile_pairs(const float4* s,
                                           const float (&x)[R],
                                           const float (&y)[R],
                                           const float (&z)[R], float (&ax)[R],
                                           float (&ay)[R], float (&az)[R],
                                           const Params& p, float rc2) {
#pragma unroll 2
  for (int u = 0; u < kTile; ++u) {
    const float4 v = s[u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dx = v.x - x[r];
      float dy = v.y - y[r];
      float dz = v.z - z[r];
      if constexpr (RINT) {
        dx -= p.box * rintf(dx * p.inv_box);
        dy -= p.box * rintf(dy * p.inv_box);
        dz -= p.box * rintf(dz * p.inv_box);
      }
      const float r2 = dx * dx + dy * dy + dz * dz;
      if constexpr (PRED) {
        const float w = r2 < rc2 ? v.w * k1_weight<SPLIT, SOFT>(r2, p) : 0.0f;
        ax[r] += w * dx;
        ay[r] += w * dy;
        az[r] += w * dz;
      } else if (r2 < rc2) {
        const float w = v.w * k1_weight<SPLIT, SOFT>(r2, p);
        ax[r] += w * dx;
        ay[r] += w * dy;
        az[r] += w * dz;
      }
    }
  }
}

template <int R>
struct K1Shared {
  unsigned mask[kChunk / 32];     // visited tiles of the chunk, a bit each
  int offset[kChunk / 32];        // visited tiles before each mask word
  int count;                      // visited tiles of the chunk
  unsigned char code[kChunk];     // visit code by tile of the chunk
  unsigned short list[kChunk];    // visited tiles, in tile order
  unsigned char lcode[kChunk];    // their visit codes
  float4 buf[kWarps][kTile];      // each warp's current source tile
  float red[kWarps - 1][3][32 * R];  // warps 1.. sums, for warp 0
};

// Block (g, s): targets [g 32 R, (g + 1) 32 R) of the sorted order against
// the source tiles [s slice_tiles, min(ntiles, (s + 1) slice_tiles)).
// Thread lane of every warp holds targets g 32 R + r 32 + lane.  With one
// slice, writes G * sum to out[perm[k]] (n, 3); else the raw sums to
// part[s] (npad, 3).
template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kThreads)
k1_pairs(const float4* __restrict__ packed, const float4* __restrict__ boxes,
         const long long* __restrict__ perm, int n, int npad,
         int slice_tiles, int slices, Params p, CullGeom c,
         float* __restrict__ part, float* __restrict__ out) {
  constexpr int R = kR;
  constexpr bool PRED = kPred;
  __shared__ K1Shared<R> sh;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int first = blockIdx.x * 32 * R;
  const int ntiles = npad / kTile;

  float x[R], y[R], z[R], ax[R], ay[R], az[R];
  float a0[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float a1[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = first + r * 32 + lane;
    const float4 t = k < n ? packed[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[r] = t.x, y[r] = t.y, z[r] = t.z;
    ax[r] = ay[r] = az[r] = 0.0f;
    if (k < n) {
      a0[0] = fminf(a0[0], t.x), a1[0] = fmaxf(a1[0], t.x);
      a0[1] = fminf(a0[1], t.y), a1[1] = fmaxf(a1[1], t.y);
      a0[2] = fminf(a0[2], t.z), a1[2] = fmaxf(a1[2], t.z);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    a0[a] = warp_min(a0[a]);
    a1[a] = warp_max(a1[a]);
  }

  const int t_begin = blockIdx.y * slice_tiles;
  const int t_end = min(ntiles, t_begin + slice_tiles);
  for (int c0 = t_begin; c0 < t_end; c0 += kChunk) {
    const int nc = min(kChunk, t_end - c0);
    // test the chunk's tiles, a ballot a warp
    for (int k = tid; k < kChunk; k += kThreads) {
      const int code =
          k < nc ? visit_code(a0, a1, boxes[2 * (c0 + k)],
                              boxes[2 * (c0 + k) + 1], c)
                 : -1;
      const unsigned m = __ballot_sync(0xffffffffu, code >= 0);
      if (lane == 0) sh.mask[k / 32] = m;
      if (code >= 0) sh.code[k] = static_cast<unsigned char>(code);
    }
    __syncthreads();
    if (warp == 0) {
      const int cnt = __popc(sh.mask[lane]);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      sh.offset[lane] = incl - cnt;
      if (lane == 31) sh.count = incl;
    }
    __syncthreads();
    // list the visited tiles in tile order
    for (int k = tid; k < kChunk; k += kThreads) {
      const unsigned m = sh.mask[k / 32];
      const int bit = k % 32;
      if ((m >> bit) & 1u) {
        const int q = sh.offset[k / 32] + __popc(m & ((1u << bit) - 1u));
        sh.list[q] = static_cast<unsigned short>(k);
        sh.lcode[q] = sh.code[k];
      }
    }
    __syncthreads();
    // this warp's share: list entries warp, warp + kWarps, ...; the next
    // tile's sources are loaded while the current one is summed
    const int cnt = sh.count;
    float4 cur[kTile / 32], nxt[kTile / 32] = {};
    int q = warp;
    if (q < cnt) {
      const size_t t0 = static_cast<size_t>(c0 + sh.list[q]) * kTile;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) cur[u] = packed[t0 + u * 32 + lane];
    }
    for (; q < cnt; q += kWarps) {
      const int code = sh.lcode[q];
      if (q + kWarps < cnt) {
        const size_t t1 =
            static_cast<size_t>(c0 + sh.list[q + kWarps]) * kTile;
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u)
          nxt[u] = packed[t1 + u * 32 + lane];
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) sh.buf[warp][u * 32 + lane] = cur[u];
      __syncwarp();
      if (code & kRint) {
        tile_pairs<SPLIT, SOFT, R, PRED, true>(sh.buf[warp], x, y, z, ax, ay,
                                               az, p, c.rc2);
      } else {
        // the tile's image on each axis, applied to the targets
        const float sx = (code & 1) ? c.box : ((code & 2) ? -c.box : 0.0f);
        const float sy =
            (code & 4) ? c.box : ((code & 8) ? -c.box : 0.0f);
        const float sz =
            (code & 16) ? c.box : ((code & 32) ? -c.box : 0.0f);
        float xs[R], ys[R], zs[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          xs[r] = x[r] - sx;
          ys[r] = y[r] - sy;
          zs[r] = z[r] - sz;
        }
        tile_pairs<SPLIT, SOFT, R, PRED, false>(sh.buf[warp], xs, ys, zs, ax,
                                                ay, az, p, c.rc2);
      }
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) cur[u] = nxt[u];
    }
    __syncthreads();  // the next chunk reuses the mask and the list
  }

  // the warps' sums, added in warp order by warp 0
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sh.red[warp - 1][0][r * 32 + lane] = ax[r];
      sh.red[warp - 1][1][r * 32 + lane] = ay[r];
      sh.red[warp - 1][2][r * 32 + lane] = az[r];
    }
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int w = 1; w < kWarps; ++w) {
      ax[r] += sh.red[w - 1][0][r * 32 + lane];
      ay[r] += sh.red[w - 1][1][r * 32 + lane];
      az[r] += sh.red[w - 1][2][r * 32 + lane];
    }
    const int k = first + r * 32 + lane;
    if (k >= n) continue;
    if (slices == 1) {
      const size_t j = 3 * static_cast<size_t>(perm[k]);
      out[j + 0] = c.G * ax[r];
      out[j + 1] = c.G * ay[r];
      out[j + 2] = c.G * az[r];
    } else {
      const size_t j = 3 * (static_cast<size_t>(blockIdx.y) * npad + k);
      part[j + 0] = ax[r];
      part[j + 1] = ay[r];
      part[j + 2] = az[r];
    }
  }
}

"""
R_REGION = re.compile(r"// The kTile sources `s` against this thread's "
                      r"target.*?(?=// out\[perm\[k\]\] = G)", re.S)


def r_targets(R: int, pred: bool = False) -> list:
    pairs = R_PAIRS.replace("constexpr int R = kR;", f"constexpr int R = {R};")
    pairs = pairs.replace("constexpr bool PRED = kPred;",
                          f"constexpr bool PRED = {str(pred).lower()};")
    return [(CU, R_REGION, pairs),
            (CU, "const dim3 grid((n + 31) / 32, slices, members);",
             f"const dim3 grid((n + {32 * R - 1}) / {32 * R}, slices, "
             f"members);")]


class Variant(NamedTuple):
    """Patches (file, old, new; old a string or a compiled pattern, each
    to match once; None: ``scripts/torch_k1_original.cu``), a factor on
    the slices where there are several, targets a thread, the key type."""

    patches: list | None
    slices: float | None = None
    R: int = 1
    keys: torch.dtype = torch.int16


VARIANTS = {
    "redesign": Variant([]),
    "original": Variant(None),
    "no cull": Variant([NO_CULL]),
    "R 2": Variant(r_targets(2), R=2),
    "R 4": Variant(r_targets(4), R=4),
    "R 8": Variant(r_targets(8), R=8),
    "slices x2": Variant([], slices=2.0),
    "slices /2": Variant([], slices=0.5),
    "rsqrtf": Variant([RSQRTF]),
    "IEEE rcp and expf": Variant(IEEE),
    "predicated": Variant([PREDICATED]),
    "R 4 predicated": Variant(r_targets(4, pred=True), R=4),
    "rint every pair": Variant([RINT_EVERY_PAIR]),
    "no Newton form": Variant([NO_NEWTON]),
    "64-source tiles": Variant([knob("int kTile", "32", "64")]),
    "2 warps": Variant([knob("int kWarps", "8", "2")]),
    "4 warps": Variant([knob("int kWarps", "8", "4")]),
    "Morton keys": Variant([MORTON]),
    "2^10 grid": Variant(GRID_10, keys=torch.int32),
    "narrowed": Variant([NARROWED]),
}
ENTRY = {"p3m_short_keys": "pidpp", "p3m_short_f32": "pppiidddddiiiippppp",
         "p3m_short_info": "iip"}
ORIGINAL_ENTRY = {"p3m_short_acc_f32": "piidddddiipp"}


def source_tag(name: str) -> str:
    return "k1_" + re.sub(r"\W+", "_", name).strip("_")


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
        if isinstance(old, re.Pattern):
            src, hits = old.subn(lambda _: new, src)
        else:
            hits = src.count(old)
            src = src.replace(old, new)
        if hits != 1:
            raise RuntimeError(f"{name}: the patch does not apply to "
                               f"{fname}: {old!r}")
        with open(path, "w") as f:
            f.write(src)
    return out


def build_all(names) -> dict:
    """{name: (so, ptxas log)}, the builds started together."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
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
    return built


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


def original_acc(lib, pos, mass, box, eps, r_s, r_cut, G, split, softening):
    """K1 before its redesign, through its own wrapper: every source, one
    target a thread, the sources packed (4, npad) in the input order."""
    n = pos.shape[0]
    npad = max(128, -(-n // 128) * 128)
    packed = torch.zeros((4, npad), device=pos.device, dtype=torch.float32)
    packed[:3, :n] = torch.remainder(pos, box).T
    packed[3, :n] = mass
    out = torch.empty((n, 3), device=pos.device, dtype=torch.float32)
    with torch.cuda.device(pos.device):
        err = lib.p3m_short_acc_f32(
            packed.data_ptr(), n, npad, float(box), float(eps), float(r_s),
            float(r_cut), float(G), P._SPLITS[split],
            P._SOFTENINGS[softening], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"original K1: launch failed (error {err})")
    return out


def variant_geometry(name, lib, pos, box, r_cut, split, softening):
    """The variant's launch shape: ``k1_card_geometry``'s, its groups and
    slices taken again for R targets a thread as ``k1_geometry`` takes
    them for one, then the slices scaled by the variant's factor."""
    v = VARIANTS[name]
    geo = P.k1_card_geometry(pos, box, r_cut, split, softening, lib)
    n, tiles = pos.shape[0], max(1, -(-pos.shape[0] // geo.tile))
    if v.R != 1:
        groups = -(-n // (32 * v.R))
        per = tiles
        if geo.slices > 1:
            want = -(-P.K1_WAVES * geo.sms * geo.blocks_per_sm // groups)
            per = -(-tiles // min(want, tiles))
        geo = geo._replace(groups=groups, slices=-(-tiles // per),
                           slice_tiles=per)
    if v.slices is None or geo.slices == 1:
        return geo
    slices = max(1, min(tiles, round(v.slices * geo.slices)))
    per = -(-tiles // slices)
    return geo._replace(slices=-(-tiles // per), slice_tiles=per)


def _run_with_keys(lib, geo, pos, mass, box, eps, r_s, r_cut, G, split,
                   softening, key_type):
    """``p3m._k1_run`` with keys of ``key_type`` (the 2^10 grid's 30-bit
    keys are int32)."""
    n = pos.shape[0]
    npad = -(-n // geo.tile) * geo.tile
    f32 = dict(device=pos.device, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    keys = torch.empty((n,), device=pos.device, dtype=key_type)
    out = torch.empty((n, 3), **f32)
    err = lib.p3m_short_keys(pos.data_ptr(), n, float(box), keys.data_ptr(),
                             stream)
    perm = torch.argsort(keys, stable=True)
    packed = torch.empty((npad, 4), **f32)
    boxes = torch.empty((npad // geo.tile, 2, 4), **f32)
    part = torch.empty((geo.slices, npad, 3), **f32)
    err = err or lib.p3m_short_f32(
        pos.data_ptr(), mass.data_ptr(), perm.data_ptr(), n, 1, float(box),
        float(eps), float(r_s), float(r_cut), float(G), P._SPLITS[split],
        P._SOFTENINGS[softening], geo.slice_tiles, geo.slices,
        packed.data_ptr(), boxes.data_ptr(), part.data_ptr(), out.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"K1 variant: launch failed (error {err})")
    return out


def variant_acc(name, lib, pos, mass, box, eps, r_s, r_cut, G, split,
                softening):
    """One launch of variant ``name`` (library ``lib``) on the card."""
    if name == "original":
        return original_acc(lib, pos, mass, box, eps, r_s, r_cut, G, split,
                            softening)
    geo = variant_geometry(name, lib, pos, box, r_cut, split, softening)
    args = (lib, geo, pos, mass, box, eps, r_s, r_cut, G, split, softening)
    if VARIANTS[name].keys != torch.int16:
        return _run_with_keys(*args, VARIANTS[name].keys)
    return P._k1_run(*args)


def kernel_launch(name, lib, pos, mass, box, eps, r_s, r_cut, G, split,
                  softening):
    """A function that launches variant ``name``'s pair sum alone (for the
    redesign's variants the pack, the pairs and the slice sum, on keys and
    an order sorted once here; for ``original`` its one kernel on its
    packed sources): one ctypes call, no torch op, so its time is the
    device's."""
    n = pos.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dict(device=pos.device, dtype=torch.float32)
    out = torch.empty((n, 3), **f32)
    if name == "original":
        npad = max(128, -(-n // 128) * 128)
        packed = torch.zeros((4, npad), **f32)
        packed[:3, :n] = torch.remainder(pos, box).T
        packed[3, :n] = mass
        args = (packed.data_ptr(), n, npad, float(box), float(eps),
                float(r_s), float(r_cut), float(G), P._SPLITS[split],
                P._SOFTENINGS[softening], out.data_ptr(), stream)
        return lambda: lib.p3m_short_acc_f32(*args), (packed, out)
    geo = variant_geometry(name, lib, pos, box, r_cut, split, softening)
    npad = -(-n // geo.tile) * geo.tile
    keys = torch.empty((n,), device=pos.device, dtype=VARIANTS[name].keys)
    lib.p3m_short_keys(pos.data_ptr(), n, float(box), keys.data_ptr(),
                       stream)
    perm = torch.argsort(keys, stable=True)
    packed = torch.empty((npad, 4), **f32)
    boxes = torch.empty((npad // geo.tile, 2, 4), **f32)
    part = torch.empty((geo.slices, npad, 3), **f32)
    args = (pos.data_ptr(), mass.data_ptr(), perm.data_ptr(), n, 1,
            float(box), float(eps), float(r_s), float(r_cut), float(G),
            P._SPLITS[split], P._SOFTENINGS[softening], geo.slice_tiles,
            geo.slices,
            packed.data_ptr(), boxes.data_ptr(), part.data_ptr(),
            out.data_ptr(), stream)
    return lambda: lib.p3m_short_f32(*args), (perm, packed, boxes, part, out)


def target_err(got, ref) -> float:
    d = (got.double() - ref).norm(dim=1)
    r = ref.norm(dim=1)
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
    """ptxas's registers of each k1_pairs / p3m_short_kernel instance."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and ("k1_pairs" in fn or "p3m_short_kernel" in fn):
            out[fn] = int(m.group(1))
    return out


def sites(names):
    """{site: (pos, mass, (box, eps, r_s, r_cut, G, split, softening))}."""
    from nbody_torch.core import units
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation

    cfg = SimulationConfig(output=OutputConfig(snapshot=False))
    box, G = cfg.box, units.COSMO.G
    r_s, r_cut, _, _ = P.p3m_short_params(box, cfg.mesh_size,
                                          cfg.n_particles)
    p3m = (box, cfg.eps, r_s, r_cut, G, cfg.force_split,
           cfg.softening_kernel)
    out = {}
    if "p3m-ics" in names:
        gen = torch.Generator().manual_seed(1)
        pos = (torch.rand((cfg.n_particles, 3), generator=gen,
                          dtype=torch.float64) * box).to("cuda",
                                                         torch.float32)
        out["p3m-ics"] = (pos, realize_ics(cfg, 0).mass, p3m)
    if "p3m-final" in names:
        work = os.path.join(ROOT, "output", "k1_ablation_run")
        shutil.rmtree(work, ignore_errors=True)
        st = run_simulation(cfg, 0, work).state
        out["p3m-final"] = (st.pos.contiguous(), st.mass.contiguous(), p3m)
    if "pp-ics" in names:
        pp = cfg.replace(solver="pp")
        st = realize_ics(pp, 0)
        out["pp-ics"] = (st.pos, st.mass,
                         (box, pp.eps, box / 16.0, 0.4999 * box, G,
                          "gaussian", pp.softening_kernel))
    return out


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


def column_sass_check(parent: str) -> dict:
    """K3-K6's sources built from this tree and from ``parent``: is each
    object's SASS the same?"""
    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for tree, root in (("this", str(_kernels.SOURCE_DIR)),
                       ("parent", os.path.join(parent, "nbody_torch",
                                               "forces", "csrc"))):
        for src in ("p3m_columns.cu", "pm_supercell.cu", "p3m_cells.cu"):
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
            for src in ("p3m_columns.cu", "pm_supercell.cu", "p3m_cells.cu")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sites", default="p3m-ics,p3m-final,pp-ics")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k1_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ablation: needs a CUDA card")
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
        same = column_sass_check(args.parent)
        results["k3_k6_sass_same"] = same
        print(f"K3-K6 SASS against the parent's: {same}", flush=True)
    libs = load_variants(names)
    data = sites(args.sites.split(","))
    for site, (pos, mass, kw) in data.items():
        box, eps, r_s, r_cut, G, split, soft = kw
        ref = P.p3m_short_plain(pos.double(), mass.double(), *kw)
        n = pos.shape[0]
        reps = 50 if r_cut < P.K1_SLICE_RCUT * box else 10
        times = {name: [] for name in names}
        ktimes = {name: [] for name in names}
        rows = {}
        for rnd in range(args.rounds):
            for name in names:
                lib = libs[name][0]

                def launch(name=name, lib=lib):
                    return variant_acc(name, lib, pos, mass, *kw)

                times[name].append(time_ms(launch, reps))
                kfn, keep = kernel_launch(name, lib, pos, mass, *kw)
                ktimes[name].append(time_ms(kfn, reps))
                del keep
                if rnd:
                    continue
                got, again = launch(), launch()
                torch.cuda.synchronize()
                row = dict(rel_l2=float((got.double() - ref).norm()
                                        / ref.norm()),
                           target_err=target_err(got, ref),
                           bit_equal=bool(torch.equal(got, again)),
                           registers=registers(libs[name][1]))
                if name != "original":
                    geo = variant_geometry(name, lib, pos, box, r_cut, split,
                                           soft)
                    row["geometry"] = dict(geo._asdict(),
                                           R=VARIANTS[name].R)
                    if geo.slices == 1 and name in ("redesign", "narrowed"):
                        reach = None
                        if name == "narrowed":
                            reach = P.k1_reach(box, r_cut) - r_cut / 2
                        plan = P.k1_plan(pos, mass, box, r_cut, reach=reach)
                        row["visits"] = P.k1_visits(plan)
                        row["rint_tiles"] = int(plan.rint.sum())
                rows[name] = row
        dense = n * (-(-n // 128) * 128)
        print(f"{site}: N {n}, r_cut {r_cut:.4f} (r_cut / box "
              f"{r_cut / box:.4f}), {split}/{soft}; dense visits {dense:.4e}",
              flush=True)
        base = statistics.median(ktimes["redesign"]) if "redesign" in ktimes \
            else None
        for name in names:
            row = rows[name]
            row["ms"] = statistics.median(times[name])
            row["ms_rounds"] = times[name]
            row["kernel_ms"] = statistics.median(ktimes[name])
            geo = row.get("geometry")
            shape = (f"R {geo['R']}, "
                     f"{geo['groups']} x {geo['slices']} blocks, "
                     f"{geo['blocks_per_sm']} resident/SM" if geo else
                     "one target a thread, every source")
            visits = (f"; visits {row['visits']:.4e} "
                      f"({row['visits'] / dense:.4f} of dense), rint tiles "
                      f"{row['rint_tiles']}" if "visits" in row else "")
            vs = (f" ({row['kernel_ms'] / base:.3f}x the redesign's)" if base
                  else "")
            print(f"  {name}: kernel {row['kernel_ms']:.4f} ms{vs}; the whole "
                  f"call {row['ms']:.4f} ms, rounds "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}; rel L2 "
                  f"{row['rel_l2']:.3e}, per target {row['target_err']:.3e}, "
                  f"{'bit-equal' if row['bit_equal'] else 'NOT bit-equal'}; "
                  f"{shape}; registers {row['registers']}{visits}",
                  flush=True)
            results["variants"].setdefault(name, {})[site] = row
        if "redesign" in names:
            lib = libs["redesign"][0]
            stages, ms, host = stage_times(
                lambda: variant_acc("redesign", lib, pos, mass, *kw))
            results.setdefault("stages", {})[site] = dict(
                stages=stages, ms=ms, host_ms=host)
            print(f"  redesign by kernel (torch.profiler, device ms a call; "
                  f"{sum(stages.values()):.4f} of {ms:.4f} ms a call by "
                  f"CUDA events, the host's enqueue {host:.4f} ms a call): "
                  + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(
                          stages.items(), key=lambda kv: -kv[1])),
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
