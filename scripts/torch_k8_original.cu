// K8 before its redesign for Hopper: the source of
// nbody_torch/forces/csrc/pp_gram.cu as the port first wrote it, kept here
// so that scripts/torch_k8_ablation.py and chip_smoke.py can time it
// beside the kernel on the same inputs.  It builds alone (nvcc -shared)
// and exports the entry point pp_gram_f32 with the signature it had then.
// Its design, in its own words below: a per-pair threshold test (an fminf
// a pair) and the Gram sums of each tile kept apart until the warp's vote.
//
// K8: softened all-pairs gravity in the Gram form, r^2 on the tensor
// cores, float32, for sm_90a.
//
// Replaces the Pallas kernel _mxu_kernel of nbody/forces/pallas_mxu.py,
// which allpairs_pallas_mxu launches.
//
// What it computes: the particles arrive Morton-sorted and padded (mass 0)
// as (x, y, z, m); each tile of ti targets has a centroid c, and
// xic = x_i - c, xjc = x_j - c.  For every target i against every source
// j != i, r2 = |xic|^2 + eps^2 + |xjc|^2 - 2 xic . xjc (the Gram form),
// S_i += m_j w (xjc, 1) with w = r2^(-3/2), P_i += m_j r2^(-1/2), and the
// output row is [S_xyz - xic S_m, P] without G, as the TPU kernel's
// epilogue forms it.  Where a Gram r2 in a warp's tile of 32 x 128 pairs
// falls below lambda_i = max(eps^2, refine_k |xic|^2), the tile is taken
// from its separations d = x_j - x_i instead: r2 = |d|^2 + eps^2 and
// E_i += m_j w d, added to the row apart from the Gram sums
// (nbody_torch/forces/pallas_mxu.py says why: the float32 Gram form loses
// a pair much closer together than to its tile centre).  Output: (npad, 4) row-major
// [ax, ay, az, pot], sorted order.
//
// What bounds it: the special-function unit.  Every one of the npad^2
// pairs takes one rsqrt, and the SFU issues 16 a clock per SM against 128
// FP32 lanes: at N = 262,144 and 1,980 MHz that is 16.4 ms.  The Gram
// products are 32 tensor-core flops a pair (4.4 ms at 495 TFLOP/s); the
// bytes are 16 a particle.
//
// What the design does about it: it takes every per-pair operation it can
// off the FP32 lanes.  r^2 + eps^2 is two mma.sync m16n8k8 TF32 products
// in the 3xTF32 split (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi);
// hi hi + hi lo + lo hi keeps ~22 bits of each operand, as
// Precision.HIGHEST did on the TPU).  The TPU's K=8 operands
// [1, 1, 1, xic, |xic|^2 + eps^2, 0] . [xjc^2, -2 xjc, 1, 0] would take
// three products (lo hi, hi lo, hi hi); here the norms enter as one
// summed term each, and the lo parts of the exact 1s vanish, so the same
// terms fit two: A1 . B1 = [q hi, q lo, 1, 1, xic hi] . [1, 1, Q hi, Q lo,
// -2xjc hi] and A2 . B2 = [xic hi, xic lo] . [-2xjc lo, -2xjc hi].  What is
// left on the FP32 lanes per pair is the threshold's min, rsqrt, two
// multiplies for w and five FMAs (route (b): the force sums [m xjc, m] . w
// and m . inv are FMA accumulations from the accumulator fragment in
// registers, reduced over the quad at the end), against K7's fourteen.
// W and inv never leave the registers; the TPU's limit, the (TJ, TI)
// weight matrix written to VMEM for its second matmul, does not arise.
// One block owns 128 targets of one centring tile (4 warps x 2 row blocks
// of 16) and loops over all sources in shared-memory tiles of 128, two of
// them alternating so one barrier a tile suffices: a tile holds each
// source's B fragments already split, so the split is paid once per block
// and source, not per pair; the A fragments are split once and stay in
// registers.  The groups of a tile run branch-free; where some pair of a
// warp's tile fell below lambda (or the tile holds the warp's own
// targets), the warp drops the tile's Gram sums and takes all its pairs
// from their separations (exact_tile, about 1 warp tile in 300 on the
// Plummer drive).  Each tile's sums are added into the running sums once
// per tile.  Nothing carries over between blocks and no atomics are used.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowBlocks = 2;                         // m16 row blocks a warp owns
constexpr int kWarpTargets = 16 * kRowBlocks;         // 32
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;                 // 128
constexpr int kBlockTargets = kWarps * kWarpTargets;  // 128
constexpr int kTile = kThreads;                       // sources a shared tile holds
constexpr int kGroups = kTile / 8;                    // m16n8k8 column groups a tile holds

struct SourceTile {
  // per group and lane (g, t): source 8 q + g's B values k = t and
  // k = t + 4 of the two products, [B1[t], B1[t+4], B2[t], B2[t+4]]
  uint4 frag[kGroups][32];
  float4 mx[kTile];  // (m xjc, m yjc, m zjc, m)
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi and lo of the 3xTF32 split of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// one MUFU.RSQ: every argument is at least eps^2 > 0 (rsqrtf adds a
// denormal guard of three instructions)
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, row) . B (8 x 8, col), TF32 in, float32 out.  Lane
// (g, t) = (lane / 4, lane % 4) holds a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4], b = B[t][g], B[t+4][g], d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r^2 + eps^2 of the warp's rows against one group of 8 sources, the
// small products first.  r2[rb][e] is row 16 rb + g + 8 (e / 2) against
// source 2t + e % 2.
__device__ __forceinline__ void gram(const uint4 bf,
                                     const uint32_t (&a1)[kRowBlocks][4],
                                     const uint32_t (&a2)[kRowBlocks][4],
                                     float (&r2)[kRowBlocks][4]) {
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, a2[rb], bf.z, bf.w);
    mma_tf32(d, a1[rb], bf.x, bf.y);
#pragma unroll
    for (int e = 0; e < 4; ++e) r2[rb][e] = d[e];
  }
}

// the Gram sums of one group: S += m w (xjc, 1), P += m inv, from the
// accumulator fragment in registers (v0, v1: [m xjc, m] of the lane's two
// sources)
__device__ __forceinline__ void gram_sums(const float (&r2)[kRowBlocks][4],
                                          const float4 v0, const float4 v1,
                                          float (&part)[kRowBlocks][2][5]) {
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 v = (e & 1) ? v1 : v0;
      const float inv = rsqrt_ftz(r2[rb][e]);
      const float w = inv * inv * inv;
      float* a = part[rb][e >> 1];
      a[0] = fmaf(w, v.x, a[0]);
      a[1] = fmaf(w, v.y, a[1]);
      a[2] = fmaf(w, v.z, a[2]);
      a[3] = fmaf(w, v.w, a[3]);
      a[4] = fmaf(inv, v.w, a[4]);
    }
  }
}

// every pair of the warp's rows (i0 = wt0 + g) against the kTile sources
// from j0, from the separations d = x_j - x_i: E += m w d, P += m inv; the
// self pair adds nothing.  The sources are read from device memory (L2,
// where all of them fit).
__device__ __forceinline__ void exact_tile(const float4* __restrict__ pos4,
                                           int j0, int i0, int t, float eps2,
                                           float (&near)[kRowBlocks][2][3],
                                           float (&tot)[kRowBlocks][2][5]) {
  float4 pi[kRowBlocks][2];
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
    for (int h = 0; h < 2; ++h) pi[rb][h] = pos4[i0 + 16 * rb + 8 * h];
#pragma unroll 2
  for (int q = 0; q < kGroups; ++q) {
    const int jc = j0 + 8 * q + 2 * t;
    const float4 src[2] = {pos4[jc], pos4[jc + 1]};
#pragma unroll
    for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 sj = src[c];
          const float dx = sj.x - pi[rb][h].x, dy = sj.y - pi[rb][h].y,
                      dz = sj.z - pi[rb][h].z;
          const float r = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
          const float inv =
              i0 + 16 * rb + 8 * h == jc + c ? 0.0f : rsqrt_ftz(r);
          const float mw = sj.w * (inv * inv * inv);
          near[rb][h][0] = fmaf(mw, dx, near[rb][h][0]);
          near[rb][h][1] = fmaf(mw, dy, near[rb][h][1]);
          near[rb][h][2] = fmaf(mw, dz, near[rb][h][2]);
          tot[rb][h][4] = fmaf(inv, sj.w, tot[rb][h][4]);
        }
      }
    }
  }
}

// one source into a shared tile: its B fragments for the lanes (g, t) of
// group s / 8 with g = s % 8, and its [m xjc, m]
__device__ __forceinline__ void stage(SourceTile& tile, int s, const float4 p,
                                      float cx, float cy, float cz) {
  const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
  uint32_t qh, ql, xh, xl, yh, yl, zh, zl;
  split(fmaf(z, z, fmaf(y, y, x * x)), qh, ql);
  split(-2.0f * x, xh, xl);
  split(-2.0f * y, yh, yl);
  split(-2.0f * z, zh, zl);
  const uint32_t one = __float_as_uint(1.0f);
  // B1 = [1, 1, Q hi, Q lo, -2x hi, -2y hi, -2z hi, 0]
  // B2 = [-2x lo, -2y lo, -2z lo, -2x hi, -2y hi, -2z hi, 0, 0]
  uint4* f = &tile.frag[s >> 3][(s & 7) * 4];
  f[0] = make_uint4(one, xh, xl, yh);
  f[1] = make_uint4(one, yh, yl, zh);
  f[2] = make_uint4(qh, zh, zl, 0u);
  f[3] = make_uint4(ql, 0u, xh, 0u);
  tile.mx[s] = make_float4(p.w * x, p.w * y, p.w * z, p.w);
}

// pos4: (npad, 4) sorted (x, y, z, m); ctr: (npad / ti, 3) centroids;
// out: (npad, 4).
__global__ void __launch_bounds__(kThreads, 3)
gram_kernel(const float4* __restrict__ pos4, const float* __restrict__ ctr,
            int npad, int ti, float eps2, float refine_k,
            float4* __restrict__ out) {
  __shared__ SourceTile tiles[2];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int block0 = blockIdx.x * kBlockTargets;
  const int wt0 = block0 + (threadIdx.x >> 5) * kWarpTargets;
  const int ci = block0 / ti;
  const float cx = ctr[3 * ci + 0], cy = ctr[3 * ci + 1], cz = ctr[3 * ci + 2];

  // the warp's rows, split once into A fragments, and their thresholds:
  // A1 = [q hi, q lo, 1, 1, x hi, y hi, z hi, 0] (q = |xic|^2 + eps^2),
  // A2 = [x hi, y hi, z hi, x lo, y lo, z lo, 0, 0]; with B1, B2 above,
  // A1 . B1 + A2 . B2 is r^2 + eps^2 in 3xTF32 (hi hi + hi lo + lo hi;
  // the lo parts of the exact 1s vanish)
  uint32_t a1[kRowBlocks][4], a2[kRowBlocks][4];
  float lam[kRowBlocks][2];
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 p = pos4[wt0 + 16 * rb + g + 8 * h];
      const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
      const float q = fmaf(z, z, fmaf(y, y, x * x));
      lam[rb][h] = fmaxf(eps2, refine_k * q);
      uint32_t qh, ql, xh, xl, yh, yl, zh, zl;
      split(q + eps2, qh, ql);
      split(x, xh, xl);
      split(y, yh, yl);
      split(z, zh, zl);
      const uint32_t one = __float_as_uint(1.0f);
      const uint32_t k1[8] = {qh, ql, one, one, xh, yh, zh, 0u};
      const uint32_t k2[8] = {xh, yh, zh, xl, yl, zl, 0u, 0u};
      a1[rb][h] = k1[t];
      a1[rb][2 + h] = k1[t + 4];
      a2[rb][h] = k2[t];
      a2[rb][2 + h] = k2[t + 4];
    }
  }

  // running sums per row (g, g + 8 of each row block): S_x, S_y, S_z, S_m,
  // P; and the separations' force E
  float tot[kRowBlocks][2][5] = {};
  float near[kRowBlocks][2][3] = {};

  // one thread stages each source; two tiles alternate, so one barrier a
  // tile keeps a tile from being overwritten while it is read
  const int ntiles = npad / kTile;
  stage(tiles[0], threadIdx.x, pos4[threadIdx.x], cx, cy, cz);
  __syncthreads();
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kTile;
    const SourceTile& tile = tiles[jt & 1];
    const bool more = jt + 1 < ntiles;
    const float4 next = more ? pos4[j0 + kTile + threadIdx.x] : float4{};

    // every group on the Gram path, branch-free; the least r^2 of each row
    // tells whether a pair fell below lambda
    float part[kRowBlocks][2][5] = {};
    float rmin[kRowBlocks][2];
#pragma unroll
    for (int rb = 0; rb < kRowBlocks; ++rb)
      rmin[rb][0] = rmin[rb][1] = __int_as_float(0x7f800000);
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      float r2[kRowBlocks][4];
      gram(tile.frag[q][lane], a1, a2, r2);
#pragma unroll
      for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rmin[rb][e >> 1] = fminf(rmin[rb][e >> 1], r2[rb][e]);
      gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1], part);
    }
    bool low = false;
#pragma unroll
    for (int rb = 0; rb < kRowBlocks; ++rb)
      low |= rmin[rb][0] < lam[rb][0] || rmin[rb][1] < lam[rb][1];
    if (__any_sync(0xffffffffu, low) || (j0 <= wt0 && wt0 < j0 + kTile)) {
      // rare: the tile's Gram sums are dropped, and every pair of it is
      // taken from its separation
      exact_tile(pos4, j0, wt0 + g, t, eps2, near, tot);
    } else {
#pragma unroll
      for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 5; ++k) tot[rb][h][k] += part[rb][h][k];
    }
    if (more) stage(tiles[(jt + 1) & 1], threadIdx.x, next, cx, cy, cz);
    __syncthreads();
  }

  // the quad's four column sets, then the epilogue
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8] = {tot[rb][h][0], tot[rb][h][1], tot[rb][h][2], tot[rb][h][3],
                    tot[rb][h][4], near[rb][h][0], near[rb][h][1],
                    near[rb][h][2]};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
      }
      if (t == 0) {
        const int i = wt0 + 16 * rb + g + 8 * h;
        const float4 p = pos4[i];
        const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
        out[i] = make_float4(fmaf(-x, v[3], v[0]) + v[5],
                             fmaf(-y, v[3], v[1]) + v[6],
                             fmaf(-z, v[3], v[2]) + v[7], v[4]);
      }
    }
  }
}

}  // namespace

extern "C" {

// The Gram-form sums of the sorted, padded particles pos4 (npad, 4) with
// centroids ctr (npad / ti, 3) into out (npad, 4).  Returns
// cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take (npad and ti
// positive, ti a multiple of 128, npad a multiple of ti).
int pp_gram_f32(const float* pos4, const float* ctr, int npad, int ti,
                double eps2, double refine_k, float* out, void* stream) {
  if (npad <= 0 || ti <= 0 || ti % kBlockTargets != 0 || npad % ti != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gram_kernel<<<npad / kBlockTargets, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pos4), ctr, npad, ti,
      static_cast<float>(eps2), static_cast<float>(refine_k),
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
