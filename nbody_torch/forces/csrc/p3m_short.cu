// K1: the short-range P3M pair sum over minimum images inside r_cut,
// float32, for sm_90a.
//
// Replaces the Pallas kernel `kernel` inside
// nbody/forces/p3m.py:p3m_short_acc (the dense "allpairs" tier), which
// also carries the real-space half of the Ewald PP force
// (nbody/forces/ewald.py:ewald_pp_acc).
//
// What it computes: for every target i,
//   acc_i = G * sum_j m_j * w(r_ij^2) * d_ij,
//   d_ij  = minimum image of x_j - x_i  (d - box * rint(d / box)),
// over the pairs with r_ij < r_cut, with w the weight _weight_fn(split,
// softening) of nbody/forces/p3m.py (short_weight.cuh): spline or Gaussian
// (Ewald erfc) force split times Plummer or cubic-spline softened Newton.
// The four variants are template instantiations chosen by two integer
// arguments.  There is no self-pair mask: at d = 0 the weighted
// displacement is exactly 0, as in the TPU kernel.  Inputs in any order,
// outputs in the same order.
//
// What bounds it: operations, of two kinds.  At the P3M site (spline
// split, r_cut = 4.5 x 1.25 mesh cells: 44 Mpc in the default 500 Mpc
// box) 0.28% of the N^2 pairs lie inside r_cut, so a kernel that visits
// every pair (the TPU's, and this one before its redesign: 1.07e9 visits
// a call at N = 32,768, each a float4 LDS, three differences, three rint
// minimum images and r^2) spends nearly all its time on pairs that add
// nothing.  At the Ewald site (Gaussian split, r_cut = 0.4999 box) 52% of
// the pairs lie inside, so nearly every warp pays the weight (rsqrt, exp,
// a reciprocal, the erfc and softening polynomials: ~60 instructions) on
// nearly every visit, and culling cannot help.
//
// What the design does about it:
// * Spatial order (the wrapper, nbody_torch/forces/p3m.py): p3m_short_keys
//   gives each particle the Hilbert index of its cell on a 2^5 grid of the
//   box (cells of 15.6 Mpc in the default box, a third of r_cut), as int16
//   keys, torch.argsort orders them (stable: the same order every launch),
//   and k1_pack gathers them in that order as float4 (x, y, z, m), wrapped
//   into [0, box], with the bounding box of each tile of kTile sources.  A
//   Hilbert curve has no jumps (consecutive cells share a face), so a tile
//   is compact; on Morton order the tiles that straddle an octant boundary
//   span half the box and every block visits them.
// * A cull.  A block takes a target group (32 consecutive sorted
//   particles, one a thread; each of its kWarps warps holds the same
//   targets) and tests every source tile's box against the group's box:
//   the periodic gap per axis, min over the three images of the interval
//   distance, and the tile is visited only where the gaps' squares sum
//   below reach^2 (cull_reach: r_cut and the float32 rounding of the
//   coordinates and of the test; p3m_short_reach reports it).  The test is
//   exact for intervals of any width, so a tile that straddles the periodic
//   edge or spans the box loses no pair.  The visited tiles of each chunk
//   of kChunk tiles are listed in shared memory in tile order (ballots and
//   a prefix count: no atomics) and dealt out to the block's warps in turn;
//   each warp sums its tiles, and the warps' sums are added in warp order.
//   The tile table has a fixed size (npad / kTile), so nothing is read back
//   to the host.
// * The minimum image per tile.  Where only one image of a source tile
//   comes within reach of the group on an axis, every pair inside r_cut
//   takes that image, so the shift is applied to the targets once per
//   tile and a pair costs one subtraction an axis, not four; a tile with
//   two images within reach (only at the Ewald site, or tiles wider than
//   box - 2 r_cut) takes rint on every pair, as before.
// * One target a thread, the weight under the cutoff branch and eight
//   warps a group, at both sites.  Where the cull leaves most tiles
//   (r_cut >= box / 4: the Ewald site), the wrapper cuts the sources into
//   slices of whole tiles so the target groups fill the card: block (g, s)
//   writes its partial sums, which k1_sum_slices adds in slice order.  No
//   atomics: two launches on the same inputs give the same bits.
// * The weight (short_weight.cuh with APPROX): one MUFU.RSQ, MUFU.RCP and
//   MUFU.EX2 in place of rsqrtf, the IEEE division and expf; with the
//   cubic-spline softening, beyond its support h (nearly every pair) the
//   Newton form alone.
// The designs that measured slower (several targets a thread, the weight
// predicated, no cull, rint on every pair, 64-source tiles, 2 or 4 warps, a
// Morton order, a 2^10 grid, ...) are patches of this file in
// scripts/torch_k1_ablation.py, with their times in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "short_weight.cuh"

namespace {

using nbody_kernels::Params;
using nbody_kernels::short_weight;

constexpr int kTile = 32;      // sources a tile (a warp's load)
constexpr int kWarps = 8;      // warps a block, all on one target group
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;   // tiles tested and listed at a time
constexpr int kKeyBits = 5;    // Hilbert grid 2^5 a side: 15-bit keys
// int16 keys: torch.argsort's radix sort takes two 8-bit passes, not four
using Key = short;

static_assert(3 * kKeyBits < 16, "the keys are int16");
static_assert(kTile % 32 == 0 && kChunk % kThreads == 0 && kChunk == 32 * 32,
              "tiles are whole warps; one warp scans the chunk's 32 ballots");

// a tile's visit code: bits 2a, 2a + 1 the image of axis a (1: +box,
// 2: -box), kRint: rint on every pair
constexpr int kRint = 64;

// wrapped into [0, box]: x - box floor(x / box), one rounding, clamped
// (x / box rounds up to 1 for x within an ulp below box)
__device__ __forceinline__ float wrap(float x, float box, float inv_box) {
  return fminf(fmaxf(fmaf(-box, floorf(x * inv_box), x), 0.0f), box);
}

// The Hilbert index of cell (x, y, z) of a 2^kKeyBits grid (Skilling's
// transpose: "Programming the Hilbert curve", AIP Conf. Proc. 707, 2004),
// three bits a level, x's highest.
__device__ __forceinline__ unsigned hilbert3(unsigned x, unsigned y,
                                             unsigned z) {
  unsigned X[3] = {x, y, z};
  for (unsigned Q = 1u << (kKeyBits - 1); Q > 1; Q >>= 1) {
    const unsigned P = Q - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (X[i] & Q) {
        X[0] ^= P;
      } else {
        const unsigned t = (X[0] ^ X[i]) & P;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  X[1] ^= X[0];
  X[2] ^= X[1];
  unsigned t = 0;
  for (unsigned Q = 1u << (kKeyBits - 1); Q > 1; Q >>= 1)
    if (X[2] & Q) t ^= Q - 1;
  unsigned key = 0;
  for (int b = kKeyBits - 1; b >= 0; --b) {
    key = (key << 3) | ((((X[0] ^ t) >> b) & 1u) << 2) |
          ((((X[1] ^ t) >> b) & 1u) << 1) | (((X[2] ^ t) >> b) & 1u);
  }
  return key;
}

__device__ __forceinline__ unsigned cell_of(float w, float scale) {
  return static_cast<unsigned>(
      min(max(__float2int_rz(w * scale), 0), (1 << kKeyBits) - 1));
}

// keys[i]: the Hilbert index of particle i's cell, pos (n, 3) row-major
__global__ void k1_keys(const float* __restrict__ pos, int n, float box,
                        float inv_box, float scale, Key* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t i3 = 3 * static_cast<size_t>(i);
  const unsigned cx = cell_of(wrap(pos[i3 + 0], box, inv_box), scale);
  const unsigned cy = cell_of(wrap(pos[i3 + 1], box, inv_box), scale);
  const unsigned cz = cell_of(wrap(pos[i3 + 2], box, inv_box), scale);
  keys[i] = static_cast<Key>(hilbert3(cx, cy, cz));
}

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

// packed[k] = (wrapped x, y, z, m) of particle perm[k], k < npad; the
// padding repeats the last particle's position with m = 0.  boxes[2 t],
// boxes[2 t + 1]: the low and high corner of tile t's real particles.  One
// warp a tile; with several members, member b's tiles follow member
// b - 1's (its pos, mass and perm n rows further on, its packed rows npad).
__global__ void k1_pack(const float* __restrict__ pos,
                        const float* __restrict__ mass,
                        const long long* __restrict__ perm, int n, int npad,
                        int members, float box, float inv_box,
                        float4* __restrict__ packed,
                        float4* __restrict__ boxes) {
  const int lane = threadIdx.x % 32;
  const int ntiles = npad / kTile;
  const int gtile = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (gtile >= ntiles * members) return;  // warp-uniform
  const int member = gtile / ntiles;
  const int tile = gtile % ntiles;
  pos += 3 * static_cast<size_t>(member) * n;
  mass += static_cast<size_t>(member) * n;
  perm += static_cast<size_t>(member) * n;
  packed += static_cast<size_t>(member) * npad;
  boxes += 2 * static_cast<size_t>(member) * ntiles;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int u = 0; u < kTile / 32; ++u) {
    const int k = tile * kTile + u * 32 + lane;
    const bool real = k < n;
    const size_t j = static_cast<size_t>(perm[real ? k : n - 1]);
    const float x = wrap(pos[3 * j + 0], box, inv_box);
    const float y = wrap(pos[3 * j + 1], box, inv_box);
    const float z = wrap(pos[3 * j + 2], box, inv_box);
    packed[k] = make_float4(x, y, z, real ? mass[j] : 0.0f);
    if (real) {
      lo[0] = fminf(lo[0], x), hi[0] = fmaxf(hi[0], x);
      lo[1] = fminf(lo[1], y), hi[1] = fmaxf(hi[1], y);
      lo[2] = fminf(lo[2], z), hi[2] = fmaxf(hi[2], z);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  if (lane == 0) {
    boxes[2 * tile] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    boxes[2 * tile + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
}

struct CullGeom {
  float box;
  float reach;    // r_cut and the float32 rounding (see the note above)
  float reach2;   // the cull's reach, squared
  float rc2;      // r_cut^2, or 0 where r_cut^2 <= 1e-30 (then no pair
                  // passes max(r^2, 1e-30) < r_cut^2)
  float G;
};

// The visit code of a tile of box [b0, b1] for a target group of box
// [a0, a1], or -1 where the tile is out of reach.  An empty box (+inf,
// -inf) is out of reach of everything.
__device__ __forceinline__ int visit_code(const float (&a0)[3],
                                          const float (&a1)[3], float4 lo,
                                          float4 hi, const CullGeom& c) {
  const float b0[3] = {lo.x, lo.y, lo.z};
  const float b1[3] = {hi.x, hi.y, hi.z};
  float g2 = 0.0f;
  int code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g0 = fmaxf(fmaxf(b0[a] - a1[a], a0[a] - b1[a]), 0.0f);
    const float gp = fmaxf((b0[a] + c.box) - a1[a], 0.0f);  // source + box
    const float gm = fmaxf((a0[a] + c.box) - b1[a], 0.0f);  // source - box
    const float g = fminf(g0, fminf(gp, gm));
    g2 += g * g;
    const int hits = (g0 < c.reach) + (gp < c.reach) + (gm < c.reach);
    if (hits != 1) {
      code |= kRint;
    } else {
      code |= (gp < c.reach ? 1 : (gm < c.reach ? 2 : 0)) << (2 * a);
    }
  }
  if (!(g2 < c.reach2)) return -1;
  return code;
}

// The pair weight: with the cubic-spline softening, a pair beyond its
// support h takes the Newton form alone (the same value).
template <int SPLIT, int SOFT>
__device__ __forceinline__ float k1_weight(float r2, const Params& p) {
  if constexpr (SOFT == 1) {
    if (r2 >= p.h * p.h) {
      Params q = p;
      q.h = 0.0f;
      return short_weight<SPLIT, 1, true>(r2, q);
    }
  }
  return short_weight<SPLIT, SOFT, true>(r2, p);
}

// The kTile sources `s` against this thread's target (x, y, z), its image
// already applied (RINT: rint on every pair instead).
template <int SPLIT, int SOFT, bool RINT>
__device__ __forceinline__ void tile_pairs(const float4* s, float x, float y,
                                           float z, float& ax, float& ay,
                                           float& az, const Params& p,
                                           float rc2) {
#pragma unroll 2
  for (int u = 0; u < kTile; ++u) {
    const float4 v = s[u];
    float dx = v.x - x;
    float dy = v.y - y;
    float dz = v.z - z;
    if constexpr (RINT) {
      dx -= p.box * rintf(dx * p.inv_box);
      dy -= p.box * rintf(dy * p.inv_box);
      dz -= p.box * rintf(dz * p.inv_box);
    }
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (r2 < rc2) {
      const float w = v.w * k1_weight<SPLIT, SOFT>(r2, p);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
  }
}

struct K1Shared {
  unsigned mask[kChunk / 32];     // visited tiles of the chunk, a bit each
  int offset[kChunk / 32];        // visited tiles before each mask word
  int count;                      // visited tiles of the chunk
  unsigned char code[kChunk];     // visit code by tile of the chunk
  unsigned short list[kChunk];    // visited tiles, in tile order
  unsigned char lcode[kChunk];    // their visit codes
  float4 buf[kWarps][kTile];      // each warp's current source tile
  float red[kWarps - 1][3][32];   // warps 1.. sums, for warp 0
};

// Block (g, s, b): targets [32 g, 32 (g + 1)) of member b's sorted order
// against its source tiles [s slice_tiles, min(ntiles, (s + 1)
// slice_tiles)).  Thread lane of every warp holds target 32 g + lane.
// With one slice, writes G * sum to out[perm[k]] (n, 3); else the raw sums
// to part[s] (npad, 3); each member's arrays follow the one before.
template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kThreads)
k1_pairs(const float4* __restrict__ packed, const float4* __restrict__ boxes,
         const long long* __restrict__ perm, int n, int npad,
         int slice_tiles, int slices, Params p, CullGeom c,
         float* __restrict__ part, float* __restrict__ out) {
  __shared__ K1Shared sh;
  {
    const size_t b = blockIdx.z;
    packed += b * npad;
    boxes += 2 * b * (npad / kTile);
    perm += b * n;
    out += 3 * b * n;
    if (part != nullptr) part += 3 * b * slices * static_cast<size_t>(npad);
  }
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k = blockIdx.x * 32 + lane;
  const int ntiles = npad / kTile;

  const float4 t = k < n ? packed[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float a0[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float a1[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (k < n) {
    a0[0] = a1[0] = t.x;
    a0[1] = a1[1] = t.y;
    a0[2] = a1[2] = t.z;
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
    for (int j = tid; j < kChunk; j += kThreads) {
      const int code =
          j < nc ? visit_code(a0, a1, boxes[2 * (c0 + j)],
                              boxes[2 * (c0 + j) + 1], c)
                 : -1;
      const unsigned m = __ballot_sync(0xffffffffu, code >= 0);
      if (lane == 0) sh.mask[j / 32] = m;
      if (code >= 0) sh.code[j] = static_cast<unsigned char>(code);
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
    for (int j = tid; j < kChunk; j += kThreads) {
      const unsigned m = sh.mask[j / 32];
      const int bit = j % 32;
      if ((m >> bit) & 1u) {
        const int q = sh.offset[j / 32] + __popc(m & ((1u << bit) - 1u));
        sh.list[q] = static_cast<unsigned short>(j);
        sh.lcode[q] = sh.code[j];
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
        tile_pairs<SPLIT, SOFT, true>(sh.buf[warp], t.x, t.y, t.z, ax, ay, az,
                                      p, c.rc2);
      } else {
        // the tile's image on each axis, applied to the target
        const float sx = (code & 1) ? c.box : ((code & 2) ? -c.box : 0.0f);
        const float sy =
            (code & 4) ? c.box : ((code & 8) ? -c.box : 0.0f);
        const float sz =
            (code & 16) ? c.box : ((code & 32) ? -c.box : 0.0f);
        tile_pairs<SPLIT, SOFT, false>(sh.buf[warp], t.x - sx, t.y - sy,
                                       t.z - sz, ax, ay, az, p, c.rc2);
      }
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) cur[u] = nxt[u];
    }
    __syncthreads();  // the next chunk reuses the mask and the list
  }

  // the warps' sums, added in warp order by warp 0
  if (warp > 0) {
    sh.red[warp - 1][0][lane] = ax;
    sh.red[warp - 1][1][lane] = ay;
    sh.red[warp - 1][2][lane] = az;
  }
  __syncthreads();
  if (warp != 0 || k >= n) return;
  for (int w = 1; w < kWarps; ++w) {
    ax += sh.red[w - 1][0][lane];
    ay += sh.red[w - 1][1][lane];
    az += sh.red[w - 1][2][lane];
  }
  if (slices == 1) {
    const size_t j = 3 * static_cast<size_t>(perm[k]);
    out[j + 0] = c.G * ax;
    out[j + 1] = c.G * ay;
    out[j + 2] = c.G * az;
  } else {
    const size_t j = 3 * (static_cast<size_t>(blockIdx.y) * npad + k);
    part[j + 0] = ax;
    part[j + 1] = ay;
    part[j + 2] = az;
  }
}

// out[perm[k]] = G (part[0][k] + part[1][k] + ...), in slice order; the
// members one after another
__global__ void k1_sum_slices(const float* __restrict__ part,
                              const long long* __restrict__ perm, int n,
                              int npad, int slices, int members, float G,
                              float* __restrict__ out) {
  const int gk = blockIdx.x * blockDim.x + threadIdx.x;
  if (gk >= n * members) return;
  const int k = gk % n;
  const size_t member = gk / n;
  part += 3 * member * slices * static_cast<size_t>(npad);
  perm += member * n;
  out += 3 * member * n;
  const size_t stride = 3 * static_cast<size_t>(npad);
  const size_t j = 3 * static_cast<size_t>(perm[k]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float sum = part[3 * static_cast<size_t>(k) + a];
    for (int s = 1; s < slices; ++s)
      sum += part[s * stride + 3 * static_cast<size_t>(k) + a];
    out[j + a] = G * sum;
  }
}

template <int SPLIT, int SOFT>
cudaError_t launch(const float4* packed, const float4* boxes,
                   const long long* perm, int n, int npad, int slice_tiles,
                   int slices, int members, const Params& p,
                   const CullGeom& c, float* part, float* out,
                   cudaStream_t s) {
  const dim3 grid((n + 31) / 32, slices, members);
  k1_pairs<SPLIT, SOFT><<<grid, kThreads, 0, s>>>(
      packed, boxes, perm, n, npad, slice_tiles, slices, p, c, part, out);
  return cudaGetLastError();
}

const void* pairs_kernel(int split, int softening) {
  return split == 0
             ? (softening == 0 ? reinterpret_cast<const void*>(k1_pairs<0, 0>)
                               : reinterpret_cast<const void*>(k1_pairs<0, 1>))
             : (softening == 0
                    ? reinterpret_cast<const void*>(k1_pairs<1, 0>)
                    : reinterpret_cast<const void*>(k1_pairs<1, 1>));
}

// The cull's reach: r_cut, its float32 rounding and that of the
// coordinates and of the test (4 box / 2^21)
double cull_reach(double box, double r_cut) {
  return r_cut * (1.0 + 1e-5) + 4.0 * box / (1 << 21);
}

}  // namespace

extern "C" {

// keys (n,) int16: the Hilbert index of each particle's cell of the
// 2^kKeyBits-a-side grid of the box, pos (n, 3) float32 row-major.
int p3m_short_keys(const float* pos, int n, double box, void* keys,
                   void* stream) {
  if (n < 0 || !(box > 0.0)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int threads = 256;
  k1_keys<<<(n + threads - 1) / threads, threads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      pos, n, static_cast<float>(box), static_cast<float>(1.0 / box),
      static_cast<float>((1 << kKeyBits) / box), static_cast<Key*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// The pair sum of `members` problems of n particles, pos (members, n, 3)
// and mass (members, n), in the order perm (members, n) int64 (each
// member's argsort of p3m_short_keys, indices into its own n rows): acc
// (members, n, 3) in the input order, one launch of each kernel for all
// members, each member's sums those of a launch of it alone, bit for bit.
// split: 0 = Gaussian, 1 = spline; softening: 0 = Plummer, 1 = cubic
// spline; the sources cut into `slices` slices of `slice_tiles` tiles.
// Scratch, from the caller, member after member: packed (npad, 4), boxes
// (npad / tile, 2, 4) and, with more than one slice, part (slices, npad,
// 3); npad = n rounded up to the tile.  Returns cudaGetLastError() after
// the launches (0 on success); 1 (cudaErrorInvalidValue) for arguments
// the kernel does not take.
int p3m_short_f32(const float* pos, const float* mass, const long long* perm,
                  int n, int members, double box, double eps, double r_s,
                  double r_cut, double G, int split, int softening,
                  int slice_tiles, int slices, float* packed, float* boxes,
                  float* part, float* out, void* stream) {
  const int npad = (n + kTile - 1) / kTile * kTile;
  const int ntiles = npad / kTile;
  if (n < 0 || n > (1 << 30) || members < 1 || members > 65535 ||
      static_cast<long long>(n) * members > (1 << 30) || !(box > 0.0) ||
      split < 0 || split > 1 || softening < 0 || softening > 1 ||
      slice_tiles < 1 || slices < 1 || slices > 65535 ||
      static_cast<long long>(slice_tiles) * slices < ntiles ||
      static_cast<long long>(slice_tiles) * (slices - 1) >=
          (ntiles > 0 ? ntiles : 1) ||
      (slices > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float fbox = static_cast<float>(box);
  const float inv_box = static_cast<float>(1.0 / box);
  float4* pk = reinterpret_cast<float4*>(packed);
  float4* bx = reinterpret_cast<float4*>(boxes);
  const int per_block = 128;
  const long long pack_threads = 32LL * ntiles * members;
  k1_pack<<<static_cast<unsigned>((pack_threads + per_block - 1) / per_block),
            per_block, 0, s>>>(pos, mass, perm, n, npad, members, fbox,
                               inv_box, pk, bx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Params p = nbody_kernels::make_params(box, eps, r_s, r_cut);
  CullGeom c;
  const double reach = cull_reach(box, r_cut);
  c.box = fbox;
  c.reach = static_cast<float>(reach);
  c.reach2 = static_cast<float>(reach * reach);
  c.rc2 = p.r_cut2 > 1e-30f ? p.r_cut2 : 0.0f;
  c.G = static_cast<float>(G);
  const auto run =
      split == 0 ? (softening == 0 ? &launch<0, 0> : &launch<0, 1>)
                 : (softening == 0 ? &launch<1, 0> : &launch<1, 1>);
  err = run(pk, bx, perm, n, npad, slice_tiles, slices, members, p, c, part,
            out, s);
  if (err == cudaSuccess && slices > 1) {
    const int threads = 256;
    const long long total = static_cast<long long>(n) * members;
    k1_sum_slices<<<static_cast<unsigned>((total + threads - 1) / threads),
                    threads, 0, s>>>(part, perm, n, npad, slices, members,
                                     c.G, out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The launch shape of the current device's kernels for one split and
// softening: out = [sources a tile, warps a block, tiles a chunk, resident
// blocks per SM, SM count].  Returns a CUDA error code (0 on success).
int p3m_short_info(int split, int softening, int* out) {
  if (split < 0 || split > 1 || softening < 0 || softening > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pairs_kernel(split, softening), kThreads, 0);
  out[0] = kTile;
  out[1] = kWarps;
  out[2] = kChunk;
  out[3] = blocks;
  out[4] = sms;
  return static_cast<int>(err);
}

// *reach = the cull's reach for (box, r_cut): a tile is visited where its
// box's periodic gap to the target group's is below it.
int p3m_short_reach(double box, double r_cut, double* reach) {
  if (!(box > 0.0) || !(r_cut >= 0.0))
    return static_cast<int>(cudaErrorInvalidValue);
  *reach = cull_reach(box, r_cut);
  return 0;
}

}  // extern "C"
