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
// epilogue forms it.  Where a warp's tile of 32 x 128 pairs may hold a
// pair whose Gram r2 falls below lambda_i = max(eps^2, refine_k |xic|^2),
// the tile is taken from its separations d = x_j - x_i instead:
// r2 = |d|^2 + eps^2, E_i += m_j w d into S_xyz (the epilogue's
// S_xyz - xic S_m leaves E whole) and P_i += m_j / r
// (nbody_torch/forces/pallas_mxu.py says why: the float32 Gram form loses
// a pair much closer together than to its tile centre).  Every tile's
// sums are summed apart and then added into the running sums, which keeps
// the float32 error of 2^18 terms to that of blocked sums.  Output:
// (npad, 4) row-major [ax, ay, az, pot], sorted order.
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
// left on the FP32 lanes per pair is rsqrt, two multiplies for w and five
// FMAs (route (b): the force sums [m xjc, m] . w and m . inv are FMA
// accumulations from the accumulator fragment in registers, reduced over
// the quad at the end), against K7's fourteen.  W and inv never leave the
// registers; the TPU's limit, the (TJ, TI) weight matrix written to VMEM
// for its second matmul, does not arise.
//
// One block owns kBlockTargets targets of one centring tile (kWarps warps
// x kRowBlocks row blocks of 16) and loops over all sources in
// shared-memory tiles of kTile, two of them alternating so one barrier a
// tile suffices: a tile holds each source's B fragments already split, so
// the split is paid once per block and source, not per pair; the A
// fragments are split once and stay in registers.  Before a tile, each
// warp knows from boxes whether the tile can hold a pair whose Gram r^2
// falls below its target's lambda_i = max(eps^2, refine_k |xic|^2): a
// first launch (tile_box_kernel) writes each source tile's bounding box,
// and each lane of a warp tests one of the next 32 tiles against the box
// of the warp's targets (unsafe_vote), allowing for a bound on the Gram
// form's float32 error.  Where the boxes rule such a pair out, the warp
// takes the tile's Gram sums with no instruction a pair for the test;
// elsewhere the warp runs the per-pair test as before
// the redesign (the least r^2 of each row beside the tile's sums), and
// where some pair fell below its lambda it drops the tile's Gram sums and
// takes every pair from its separation (exact_tile), as it does at once
// for the tile of its own targets.  The separations' force goes into the
// Gram sums and the warp's box into shared memory, so the kernel fits 4
// blocks an SM (128 registers; 3 before the redesign).  The box test
// flags every tile the per-pair test would redo, so the result is the
// design's before the redesign, up to the order of the float32 sums.  On
// uniform positions the boxes clear ~99% of the warp tiles; in a Plummer
// sphere's core, where the Morton cells hold hundreds of particles in no
// spatial order, they clear few, and those tiles keep the per-pair test.
// Nothing carries over between blocks and no atomics are used, so two
// launches agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowBlocks = 2;                         // m16 row blocks a warp owns
constexpr int kWarpTargets = 16 * kRowBlocks;         // 32
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;                 // 128
constexpr int kBlockTargets = kWarps * kWarpTargets;  // 128
constexpr int kMinBlocks = 4;                         // resident blocks an SM
constexpr int kTile = 128;                            // sources a shared tile holds
constexpr int kGroups = kTile / 8;                    // m16n8k8 column groups a tile holds
constexpr int kBoxThreads = 128;                      // threads of tile_box_kernel
// the Gram r^2's float32 error is below 2^-18 ((|xic| + |xjc|)^2 + eps^2):
// the lo x lo terms the split drops, the roundings of the split norms and
// the products' float32 sums; the box test allows 2^-14 of the same
constexpr float kGramSlack = 1.0f / 16384.0f;

// a warp's targets for its vote: their box (centred), the largest |xic|
// and the largest lambda
struct WarpBox {
  float lo[3], hi[3], rt, lam;
};

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
                                          float (&tot)[kRowBlocks][2][5]) {
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 v = (e & 1) ? v1 : v0;
      const float inv = rsqrt_ftz(r2[rb][e]);
      const float w = inv * inv * inv;
      float* a = tot[rb][e >> 1];
      a[0] = fmaf(w, v.x, a[0]);
      a[1] = fmaf(w, v.y, a[1]);
      a[2] = fmaf(w, v.z, a[2]);
      a[3] = fmaf(w, v.w, a[3]);
      a[4] = fmaf(inv, v.w, a[4]);
    }
  }
}

// the Gram sums of a whole tile, summed apart over the tile and then
// added into the running sums: sums of 32 terms a tile and of one term a
// tile keep the float32 error of 2^18 terms summed in blocks, which the
// epilogue's S_x - xic S_m amplifies
__device__ __forceinline__ void gram_tile(const SourceTile& tile, int lane,
                                          int t,
                                          const uint32_t (&a1)[kRowBlocks][4],
                                          const uint32_t (&a2)[kRowBlocks][4],
                                          float (&tot)[kRowBlocks][2][5]) {
  float part[kRowBlocks][2][5] = {};
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    float r2[kRowBlocks][4];
    gram(tile.frag[q][lane], a1, a2, r2);
    gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1], part);
  }
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 5; ++k) tot[rb][h][k] += part[rb][h][k];
}

// every pair of the warp's rows (i0 = wt0 + g) against the kTile sources
// from j0, from the separations d = x_j - x_i: E = m w d and P = m inv,
// summed apart over the tile, then E added to S_xyz (the epilogue's
// S_xyz - xic S_m leaves it whole) and P to P; the self pair adds nothing.
// The sources are read from device memory (L2, where all of them fit).
__device__ __forceinline__ void exact_tile(const float4* __restrict__ pos4,
                                           int j0, int i0, int t, float eps2,
                                           float (&tot)[kRowBlocks][2][5]) {
  float4 pi[kRowBlocks][2];
  float part[kRowBlocks][2][4] = {};
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
          float* a = part[rb][h];
          a[0] = fmaf(mw, dx, a[0]);
          a[1] = fmaf(mw, dy, a[1]);
          a[2] = fmaf(mw, dz, a[2]);
          a[3] = fmaf(inv, sj.w, a[3]);
        }
      }
    }
  }
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tot[rb][h][0] += part[rb][h][0];
      tot[rb][h][1] += part[rb][h][1];
      tot[rb][h][2] += part[rb][h][2];
      tot[rb][h][4] += part[rb][h][3];
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

// The bounding box of each tile of kTile sources: boxes[2 t] = (lo, 0),
// boxes[2 t + 1] = (hi, 0).  One block a tile.
__global__ void __launch_bounds__(kBoxThreads)
tile_box_kernel(const float4* __restrict__ pos4, float4* __restrict__ boxes) {
  __shared__ float part[kBoxThreads / 32][6];
  float v[6] = {3.4e38f, 3.4e38f, 3.4e38f, -3.4e38f, -3.4e38f, -3.4e38f};
  for (int s = threadIdx.x; s < kTile; s += kBoxThreads) {
    const float4 p = pos4[static_cast<size_t>(blockIdx.x) * kTile + s];
    v[0] = fminf(v[0], p.x);
    v[1] = fminf(v[1], p.y);
    v[2] = fminf(v[2], p.z);
    v[3] = fmaxf(v[3], p.x);
    v[4] = fmaxf(v[4], p.y);
    v[5] = fmaxf(v[5], p.z);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
      v[3 + k] = fmaxf(v[3 + k], __shfl_xor_sync(0xffffffffu, v[3 + k], o));
    }
  }
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < 6; ++k) part[threadIdx.x >> 5][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kBoxThreads / 32; ++w)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = fminf(v[k], part[w][k]);
        v[3 + k] = fmaxf(v[3 + k], part[w][3 + k]);
      }
    boxes[2 * blockIdx.x] = make_float4(v[0], v[1], v[2], 0.0f);
    boxes[2 * blockIdx.x + 1] = make_float4(v[3], v[4], v[5], 0.0f);
  }
}

// The warp's vote on the 32 source tiles from jt (a lane each): bit k set
// where the boxes cannot rule out a pair of tile jt + k whose Gram r^2
// falls below its target's lambda, i.e. where the least r^2 + eps^2 the
// tile's box and the warp's target box (tlo, thi, centred) allow, less
// the Gram form's error bound kGramSlack ((Rt + Rs)^2 + eps^2), falls
// below the warp's largest lambda.  Rt and Rs bound |xic| and |xjc|.
__device__ __forceinline__ unsigned unsafe_vote(
    const float4* __restrict__ boxes, int jt, int ntiles, int lane,
    float cx, float cy, float cz, const WarpBox& wb, float eps2) {
  const float tlo[3] = {wb.lo[0], wb.lo[1], wb.lo[2]};
  const float thi[3] = {wb.hi[0], wb.hi[1], wb.hi[2]};
  const int tt = jt + lane;
  bool flag = false;
  if (tt < ntiles) {
    const float4 lo = boxes[2 * tt], hi = boxes[2 * tt + 1];
    const float slo[3] = {lo.x - cx, lo.y - cy, lo.z - cz};
    const float shi[3] = {hi.x - cx, hi.y - cy, hi.z - cz};
    float gap2 = 0.0f, rs2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gap = fmaxf(fmaxf(slo[k] - thi[k], tlo[k] - shi[k]), 0.0f);
      gap2 = fmaf(gap, gap, gap2);
      const float far = fmaxf(fabsf(slo[k]), fabsf(shi[k]));
      rs2 = fmaf(far, far, rs2);
    }
    const float span = wb.rt + sqrtf(rs2);
    const float slack = kGramSlack * fmaf(span, span, eps2);
    flag = fmaf(gap2, 1.0f - 1.0f / 1048576.0f, eps2 - slack) < wb.lam;
  }
  return __ballot_sync(0xffffffffu, flag);
}

// pos4: (npad, 4) sorted (x, y, z, m); ctr: (npad / ti, 3) centroids;
// boxes: tile_box_kernel's; out: (npad, 4).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gram_kernel(const float4* __restrict__ pos4, const float* __restrict__ ctr,
            const float4* __restrict__ boxes, int npad, int ti, float eps2,
            float refine_k, float4* __restrict__ out) {
  __shared__ SourceTile tiles[2];
  __shared__ WarpBox wbox[kWarps];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int block0 = blockIdx.x * kBlockTargets;
  const int wt0 = block0 + (threadIdx.x >> 5) * kWarpTargets;
  const int ci = block0 / ti;
  const float cx = ctr[3 * ci + 0], cy = ctr[3 * ci + 1], cz = ctr[3 * ci + 2];

  // the warp's rows, split once into A fragments:
  // A1 = [q hi, q lo, 1, 1, x hi, y hi, z hi, 0] (q = |xic|^2 + eps^2),
  // A2 = [x hi, y hi, z hi, x lo, y lo, z lo, 0, 0]; with B1, B2 above,
  // A1 . B1 + A2 . B2 is r^2 + eps^2 in 3xTF32 (hi hi + hi lo + lo hi;
  // the lo parts of the exact 1s vanish).  Each row's lambda, and the box
  // of the warp's rows (centred), their largest |xic|^2 and lambda.
  uint32_t a1[kRowBlocks][4], a2[kRowBlocks][4];
  float tlo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  float thi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
  float q2 = 0.0f;
  float lam_row[kRowBlocks][2];
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 p = pos4[wt0 + 16 * rb + g + 8 * h];
      const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
      const float q = fmaf(z, z, fmaf(y, y, x * x));
      lam_row[rb][h] = fmaxf(eps2, refine_k * q);
      q2 = fmaxf(q2, q);
      const float c[3] = {x, y, z};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tlo[k] = fminf(tlo[k], c[k]);
        thi[k] = fmaxf(thi[k], c[k]);
      }
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
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    q2 = fmaxf(q2, __shfl_xor_sync(0xffffffffu, q2, o));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tlo[k] = fminf(tlo[k], __shfl_xor_sync(0xffffffffu, tlo[k], o));
      thi[k] = fmaxf(thi[k], __shfl_xor_sync(0xffffffffu, thi[k], o));
    }
  }
  WarpBox& wb = wbox[threadIdx.x >> 5];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wb.lo[k] = tlo[k];
      wb.hi[k] = thi[k];
    }
    wb.rt = sqrtf(q2);
    wb.lam = fmaxf(eps2, refine_k * q2);
  }
  __syncwarp();

  // running sums per row (g, g + 8 of each row block): S_x, S_y, S_z, S_m,
  // P (the separations' force E goes into S_xyz)
  float tot[kRowBlocks][2][5] = {};

  // one thread stages each source; two tiles alternate, so one barrier a
  // tile keeps a tile from being overwritten while it is read
  const int ntiles = npad / kTile;
  for (int s = threadIdx.x; s < kTile; s += kThreads)
    stage(tiles[0], s, pos4[s], cx, cy, cz);
  __syncthreads();
  const int own = wt0 / kTile;  // the tile of the warp's own targets
  unsigned unsafe = 0u;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kTile;
    const SourceTile& tile = tiles[jt & 1];
    const bool more = jt + 1 < ntiles;
    float4 next[kTile / kThreads];
#pragma unroll
    for (int u = 0; u < kTile / kThreads; ++u)
      next[u] = more ? pos4[j0 + kTile + threadIdx.x + u * kThreads]
                     : float4{};
    if ((jt & 31) == 0)
      unsafe = unsafe_vote(boxes, jt, ntiles, lane, cx, cy, cz, wb, eps2);
    if (jt == own) {
      // the warp's own targets: every pair from its separation
      exact_tile(pos4, j0, wt0 + g, t, eps2, tot);
    } else if (!((unsafe >> (jt & 31)) & 1u)) {
      // the boxes rule out a pair below lambda: the Gram sums straight
      // into the running sums
      gram_tile(tile, lane, t, a1, a2, tot);
    } else {
      // the per-pair test: the tile's Gram sums apart, and the least r^2
      // of each row; where some pair of the warp's tile fell below its
      // lambda, the sums are dropped and every pair is taken from its
      // separation
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
        gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1],
                  part);
      }
      bool low = false;
#pragma unroll
      for (int rb = 0; rb < kRowBlocks; ++rb)
        low |= rmin[rb][0] < lam_row[rb][0] || rmin[rb][1] < lam_row[rb][1];
      if (__any_sync(0xffffffffu, low)) {
        exact_tile(pos4, j0, wt0 + g, t, eps2, tot);
      } else {
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 5; ++k) tot[rb][h][k] += part[rb][h][k];
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kTile / kThreads; ++u)
        stage(tiles[(jt + 1) & 1], threadIdx.x + u * kThreads, next[u], cx,
              cy, cz);
    }
    __syncthreads();
  }

  // the quad's four column sets, then the epilogue
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[5] = {tot[rb][h][0], tot[rb][h][1], tot[rb][h][2], tot[rb][h][3],
                    tot[rb][h][4]};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
      }
      if (t == 0) {
        const int i = wt0 + 16 * rb + g + 8 * h;
        const float4 p = pos4[i];
        const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
        out[i] = make_float4(fmaf(-x, v[3], v[0]), fmaf(-y, v[3], v[1]),
                             fmaf(-z, v[3], v[2]), v[4]);
      }
    }
  }
}

}  // namespace

extern "C" {

// The Gram-form sums of the sorted, padded particles pos4 (npad, 4) with
// centroids ctr (npad / ti, 3) into out (npad, 4); boxes: scratch of
// npad / 16 floats (each source tile's box).  Two launches on `stream`.
// Returns cudaGetLastError() after them (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take (npad and ti
// positive, ti a multiple of 128, npad a multiple of ti).
int pp_gram_f32(const float* pos4, const float* ctr, int npad, int ti,
                double eps2, double refine_k, float* boxes, float* out,
                void* stream) {
  if (npad <= 0 || ti <= 0 || ti % kBlockTargets != 0 || npad % ti != 0 ||
      npad % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* p4 = reinterpret_cast<const float4*>(pos4);
  float4* bx = reinterpret_cast<float4*>(boxes);
  tile_box_kernel<<<npad / kTile, kBoxThreads, 0, s>>>(p4, bx);
  gram_kernel<<<npad / kBlockTargets, kThreads, 0, s>>>(
      p4, ctr, bx, npad, ti, static_cast<float>(eps2),
      static_cast<float>(refine_k), reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K8's launch shape into info: targets a block, sources a tile, warps a
// block and the gram kernel's resident blocks an SM on the current device.
int pp_gram_info(int* info) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gram_kernel, kThreads, 0);
  info[0] = kBlockTargets;
  info[1] = kTile;
  info[2] = kWarps;
  info[3] = blocks;
  return static_cast<int>(e);
}

}  // extern "C"
