// The column pair sum shared by K3 (pm_supercell.cu), K4 and K5
// (p3m_columns.cu): the plane layout, the block-to-targets maps and the
// loop over the reach of a block's targets in its chunk's 9 neighbour
// z-windows.
//
// Plane: (8, P2 * stride) float32 row-major, rows x, y, z, m (rows 4-7
// unused on input), P2 = (nx + 2) * (ncell + 2) padded columns of `stride`
// slots: nx interior x-rows (ncell for the whole box, ncell / D for a
// slab's plane, whose two ghost x-rows are its neighbours' edge rows);
// padded column (px, py) starts at slot (px * P + py) * stride, P =
// ncell + 2.  Interior column ic = cx * ncell + cy (cx < nx) is padded
// column (cx + 1, cy + 1).  Its chunk k holds the target slots
// [gz + k * chunk, gz + (k + 1) * chunk) and interacts with window
// [ws, ws + W) of each neighbour (cx + o2 / 3, cy + o2 % 3), o2 = 0..8,
// ws = ws_tab[(ic * 9 + o2) * maxch + k].  Ghost columns and ghost slots
// carry +-box in their coordinates, so there is no minimum image.
//
// The reach.  W is the widest window any chunk of the plane needed, so
// most of a chunk's window lies beyond r_cut of its targets in z.  A
// block (kColTargets targets of one chunk) takes the z-range [tmin, tmax]
// of its targets, less the sentinels (below), and visits in each
// neighbour window only the slots whose sources can lie in [tmin - r_cut,
// tmax + r_cut]: the pairs summed are those of the whole window inside
// r_cut, in another order.  The slots are found from probes of z every
// kColFence slots of the window.  A column's z is ascending up to the
// 2^-21 box quantum of the plane's sort key, or, on a frozen plane, up to
// the drift since the freeze: every slot's z lies within D of its z at
// the freeze, D the largest |z drift| of the plane's particles, which the
// caller measures on the card (`drift`; 0 for a fresh plane).  So a probe
// whose z lies below tmin - r_cut - 2 D - 4 quanta proves every earlier
// massive slot below tmin - r_cut (its freeze z was below tmin - r_cut -
// D and the earlier ones' no higher), and one above tmax + r_cut + 2 D +
// 4 quanta proves every later one above tmax + r_cut.  The sentinels
// break the order: an invalid front ghost sits at -2 box (z < -box),
// padding and invalid back ghosts at box + 3 r_cut (z > box + 2 r_cut),
// both massless at xy -8 r_cut.  A front sentinel proves every earlier
// massive slot below -Z + 2 D + a quantum (Z = 1.0001 r_cut, the ghost
// band's wrap margin: an earlier slot sorted no higher and was, or is,
// valid only above -Z), so it counts as z = -Z for the lower bound; a
// back sentinel proves every later massive slot above box + Z - 2 D - a
// quantum, so it counts as z = box + Z for the upper bound; neither
// proves anything for the other bound.  Within the slots found, each
// warp skips the 32-source sub-tiles whose massive sources all lie beyond
// r_cut of its own targets in z (a massless source adds nothing).
// Sentinel targets (the padding of a column's last chunk) lie more than
// r_cut from every massive slot in xy (the column side is below 7 r_cut
// in every tier), so their sums are zero either way.
//
// The weight.  Inside the reach ~5% of a target's visits lie inside
// r_cut, but a warp of 32 targets has one inside on most of its visits,
// and the cutoff branch then costs the whole warp the weight.  Two ways
// round that, and two or four targets a thread, were measured against
// this design (patches in scripts/torch_columns_ablation.py, on the
// H100): the weight on every visit with the result selected, and each
// lane marking its sources inside r_cut in a 32-bit mask per sub-tile,
// then the warp working through the marks a lane at a time.  All lose
// (the marks because a warp's targets are consecutive in z, so its
// lanes' pairs come at the same sources; a second target a thread
// doubles a warp's z-span and its visits), so one target a thread and
// the branch stay; the weight itself is made cheaper: beyond the
// softening's support, nearly every pair, it takes the Newton form alone
// (pair_weight).  Each target adds its sources in slot order, so two
// launches give the same bits, and the same sums at every capacity: its
// terms are the massive sources within r_cut, taken neighbour by
// neighbour and, in each, in their column's order (front ghosts, reals,
// back ghosts), whatever the window's start and width W, the capacity
// CK, the ghost band gz or the chunk; a slot out of reach or massless
// adds nothing (tests/test_torch_cuda.py holds K3, K4 and K5 at CK and
// 2 CK bit for bit, scripts/torch_capacity_bits.py at cfg64's shapes).
//
// A batched launch (the batched tier's members) adds blockIdx.z, the
// member, whose plane, tables and output follow the previous member's
// (member_part): each member has its own launch's blocks and sums.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "short_weight.cuh"

namespace nbody_kernels {

// Targets a block, one a thread: a chunk (256 slots, or 128 when it does
// not divide the capacity) is chunk / kColTargets blocks, so a uniform
// 64^3-particle state gives ~2,500 blocks.
constexpr int kColTargets = 128;
constexpr int kColThreads = kColTargets;
constexpr int kColWarps = kColThreads / 32;
// Sources a shared-memory tile (a multiple of 32 and of kColThreads).
constexpr int kColTile = 512;
// Slots between the probes of the reach search.
constexpr int kColFence = 32;
// 1: each block searches its reach in every window (else it streams the
// whole window); 1: each warp skips the sub-tiles out of its own reach;
// 1: the Newton form of the weight beyond the softening's support
// (pair_weight).  0 for all three, with 128-source tiles, is the design
// before the redesign, scripts/torch_columns_ablation.py's `original`.
constexpr int kColSearch = 1;
constexpr int kColCull = 1;
constexpr int kColNewton = 1;

static_assert(kColThreads % 32 == 0 && kColTile % kColThreads == 0 &&
                  kColTile % 32 == 0,
              "the tile is loaded a warp's 32 sources at a time");

struct ColumnGeom {
  int nx;      // interior x-rows of the plane (ncell, or a slab's share)
  int ncell;   // interior columns per y side
  int stride;  // slots per padded column
  int W;       // window width (slots), <= stride
  int maxch;   // chunk slots per column in the window table
  int gz;      // z-ghost slots at each column end
  int chunk;   // targets per chunk (a multiple of kColTargets)
  size_t row;  // elements per plane row: (nx + 2) * (ncell + 2) * stride
  float reach;   // r_cut and the float32 rounding of |dz|, plus 4 quanta
  float slack;   // 4 quanta: the sort key's tolerance
  float zlow;    // z below it: a front sentinel (-box)
  float zhigh;   // z above it: a back sentinel (box + 2 r_cut)
  float key_lo;  // a front sentinel's z for the lower bound (-Z)
  float key_hi;  // a back sentinel's z for the upper bound (box + Z)
  const float* drift;  // D on the card (one float), nullptr: 0
};

// The geometry of one launch; `drift`: a frozen plane's D (the largest
// |z drift| of its particles since the freeze, one float on the card),
// nullptr for a fresh plane.
inline ColumnGeom make_geom(int nx, int ncell, int stride, int W, int maxch,
                            int gz, int chunk, double box, double r_cut,
                            const float* drift) {
  ColumnGeom g;
  g.nx = nx;
  g.ncell = ncell;
  g.stride = stride;
  g.W = W;
  g.maxch = maxch;
  g.gz = gz;
  g.chunk = chunk;
  g.row = static_cast<size_t>(nx + 2) * (ncell + 2) * stride;
  const double quantum = box / (1 << 21);  // >= 4 float32 ulps of box
  g.reach = static_cast<float>(r_cut * (1.0 + 1e-5) + 4.0 * quantum);
  g.slack = static_cast<float>(4.0 * quantum);
  g.zlow = static_cast<float>(-box);
  g.zhigh = static_cast<float>(box + 2.0 * r_cut);
  g.key_lo = static_cast<float>(-1.0001 * r_cut);
  g.key_hi = static_cast<float>(box + 1.0001 * r_cut);
  g.drift = drift;
  return g;
}

// The member blockIdx.z's part of an array of `per` elements a member.
template <typename T>
__device__ __forceinline__ T* member_part(T* p, size_t per) {
  return p == nullptr ? p : p + static_cast<size_t>(blockIdx.z) * per;
}

// The first target slot of this block's share of chunk k of interior
// column ic (a chunk is g.chunk / kColTargets blocks along blockIdx.y).
__device__ __forceinline__ size_t chunk_first(const ColumnGeom& g, int ic,
                                              int k) {
  const int P = g.ncell + 2;
  const int tcol = (ic / g.ncell + 1) * P + (ic % g.ncell + 1);
  return static_cast<size_t>(tcol) * g.stride + g.gz +
         static_cast<size_t>(k) * g.chunk +
         static_cast<size_t>(blockIdx.y % (g.chunk / kColTargets)) *
             kColTargets;
}

// Where this block's targets are: interior column `ic`, chunk `k` and the
// first target slot; false when the chunk is empty (the whole block
// returns before any barrier).
__device__ __forceinline__ bool column_block(const ColumnGeom& g,
                                             const int* __restrict__ nch,
                                             int& ic, int& k, size_t& first) {
  ic = blockIdx.x;
  k = blockIdx.y / (g.chunk / kColTargets);
  if (k >= nch[ic]) return false;
  first = chunk_first(g, ic, k);
  return true;
}

// The same for the masked form: blockIdx.y / (chunk / kColTargets) is a
// slot of column ic's chunk table `cht` (ncol * maxch), of which the
// first nch_act[ic] hold the indices of the active chunks.
__device__ __forceinline__ bool column_block_masked(
    const ColumnGeom& g, const int* __restrict__ nch_act,
    const int* __restrict__ cht, int& ic, int& k, size_t& first) {
  ic = blockIdx.x;
  const int slot = blockIdx.y / (g.chunk / kColTargets);
  if (slot >= nch_act[ic]) return false;
  k = cht[static_cast<size_t>(ic) * g.maxch + slot];
  first = chunk_first(g, ic, k);
  return true;
}

// A thread's target: position in, sums out.
struct ColumnTarget {
  float x, y, z;
  float ax, ay, az;
};

// This thread's target of the block whose first target slot is `first`:
// its slot, and the target read from the plane with zero sums.
__device__ __forceinline__ size_t target_slot(size_t first) {
  return first + threadIdx.x;
}

__device__ __forceinline__ ColumnTarget load_target(
    const float* __restrict__ plane, const ColumnGeom& g, size_t i) {
  return ColumnTarget{plane[i], plane[g.row + i], plane[2 * g.row + i],
                      0.0f, 0.0f, 0.0f};
}

// The block's shared memory.
struct ColumnShared {
  float4 tile[kColTile];
  float smin[kColTile / 32], smax[kColTile / 32];  // massive z a sub-tile
  float wmin[kColWarps], wmax[kColWarps];          // target z a warp
  int ws[9];                                       // window starts
  int lo[9], hi[9];                                // reach, in fences
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The pair weight (short_weight.cuh).  With the cubic-spline softening,
// a pair beyond its support h (nearly all of them) takes the Newton form
// alone: the same value, without the softened polynomials that the
// shared weight evaluates and discards.
template <int SPLIT, int SOFT>
__device__ __forceinline__ float pair_weight(float r2, const Params& p) {
  if constexpr (SOFT == 1 && kColNewton) {
    if (r2 >= p.h * p.h) {
      Params q = p;
      q.h = 0.0f;
      return short_weight<SPLIT, 1>(r2, q);
    }
  }
  return short_weight<SPLIT, SOFT>(r2, p);
}

// The 32 sources `s` (a sub-tile; unloaded entries lie at z = 1e30)
// against this thread's target, the weight under the cutoff branch.
template <int SPLIT, int SOFT>
__device__ __forceinline__ void subtile_pairs(const float4* s,
                                              ColumnTarget& t,
                                              const Params& p) {
#pragma unroll 8
  for (int u = 0; u < 32; ++u) {
    const float4 v = s[u];
    const float dx = v.x - t.x;
    const float dy = v.y - t.y;
    const float dz = v.z - t.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (fmaxf(r2, 1e-30f) < p.r_cut2) {
      const float w = v.w * pair_weight<SPLIT, SOFT>(r2, p);
      t.ax += w * dx;
      t.ay += w * dy;
      t.az += w * dz;
    }
  }
}

// Adds to t's sums the short-range sum of its target over the reach of
// the block's targets in the 9 windows of chunk k of column ic.  Every
// thread of the block calls it (barriers inside).
template <int SPLIT, int SOFT>
__device__ __forceinline__ void column_pair_sum(
    const float* __restrict__ plane, const int* __restrict__ ws,
    const ColumnGeom& g, int ic, int k, ColumnTarget& t, const Params& p,
    ColumnShared& sh) {
  const int P = g.ncell + 2;
  const int cx = ic / g.ncell;
  const int cy = ic % g.ncell;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nf = (g.W + kColFence - 1) / kColFence;

  // the z-range of the warp's and of the block's targets, less sentinels
  const bool real = t.z >= g.zlow && t.z <= g.zhigh;
  const float wmin = warp_min(real ? t.z : CUDART_INF_F);
  const float wmax = warp_max(real ? t.z : -CUDART_INF_F);
  if (lane == 0) {
    sh.wmin[warp] = wmin;
    sh.wmax[warp] = wmax;
  }
  if (tid < 9) {
    sh.ws[tid] = ws[(static_cast<size_t>(ic) * 9 + tid) * g.maxch + k];
    sh.lo[tid] = 0;
    sh.hi[tid] = nf;
  }
  __syncthreads();
  float bmin = CUDART_INF_F, bmax = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kColWarps; ++w) {
    bmin = fminf(bmin, sh.wmin[w]);
    bmax = fmaxf(bmax, sh.wmax[w]);
  }
  if (!(bmin <= bmax)) return;  // sentinels only (block-uniform)
  const float qlo = bmin - g.reach;
  const float qhi = bmax + g.reach;

  if constexpr (kColSearch) {
    // the order's tolerance: 2 D + 4 quanta
    const float slack =
        g.drift == nullptr ? g.slack : g.slack + 2.0f * __ldg(g.drift);
    // probe every fence of the 9 windows; a fence below the reach moves
    // the start up to it, one above it moves the end down to it
    for (int idx = tid; idx < 9 * nf; idx += kColThreads) {
      const int o2 = idx / nf;
      const int f = idx - o2 * nf;
      const int jcol = (cx + o2 / 3) * P + (cy + o2 % 3);
      const size_t j =
          static_cast<size_t>(jcol) * g.stride + sh.ws[o2] + f * kColFence;
      const float z = plane[2 * g.row + j];
      const bool low = z < g.zlow;
      const bool high = z > g.zhigh;
      if (!high && (low ? g.key_lo : z) < qlo - slack)
        atomicMax(&sh.lo[o2], f);
      if (!low && (high ? g.key_hi : z) > qhi + slack)
        atomicMin(&sh.hi[o2], f);
    }
    __syncthreads();
  }

  for (int o2 = 0; o2 < 9; ++o2) {
    const int jcol = (cx + o2 / 3) * P + (cy + o2 % 3);
    const size_t base = static_cast<size_t>(jcol) * g.stride + sh.ws[o2];
    const int start = kColSearch ? sh.lo[o2] * kColFence : 0;
    const int end = kColSearch ? min(sh.hi[o2] * kColFence, g.W) : g.W;
    for (int j0 = start; j0 < end; j0 += kColTile) {
      const int nt = min(kColTile, end - j0);
#pragma unroll
      for (int i = 0; i < kColTile / kColThreads; ++i) {
        const int u = i * kColThreads + tid;
        float4 s = make_float4(0.0f, 0.0f, 1e30f, 0.0f);
        if (u < nt) {
          const size_t j = base + j0 + u;
          s = make_float4(plane[j], plane[g.row + j], plane[2 * g.row + j],
                          plane[3 * g.row + j]);
        }
        sh.tile[u] = s;
        if constexpr (kColCull) {
          const bool massive = s.w > 0.0f;
          const float lo = warp_min(massive ? s.z : CUDART_INF_F);
          const float hi = warp_max(massive ? s.z : -CUDART_INF_F);
          if (lane == 0) {
            sh.smin[u / 32] = lo;
            sh.smax[u / 32] = hi;
          }
        }
      }
      __syncthreads();
      const int nsub = (nt + 31) / 32;
      for (int sub = 0; sub < nsub; ++sub) {
        if (kColCull && (sh.smin[sub] > wmax + g.reach ||
                         sh.smax[sub] < wmin - g.reach))
          continue;  // warp-uniform
        subtile_pairs<SPLIT, SOFT>(sh.tile + sub * 32, t, p);
      }
      __syncthreads();
    }
  }
}

}  // namespace nbody_kernels
