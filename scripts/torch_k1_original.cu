// K1 as it was before its redesign for Hopper, kept for comparison: the
// `original` variant of scripts/torch_k1_ablation.py, which chip_smoke.py
// also builds and times beside the kernel.  Not part of the library.
//
// K1: dense minimum-image short-range P3M pair sum, float32, for sm_90a.
//
// Replaces the Pallas kernel `kernel` inside
// nbody/forces/p3m.py:p3m_short_acc (the dense "allpairs" tier).
//
// What it computes: for every target i,
//   acc_i = G * sum_j m_j * w(r_ij^2) * d_ij,
//   d_ij  = minimum image of x_j - x_i  (d - box * rint(d / box)),
// with w the cutoff-masked weight _weight_fn(split, softening) of
// nbody/forces/p3m.py (short_weight.cuh): spline or Gaussian (Ewald erfc)
// force split times Plummer or cubic-spline softened Newton.  The four variants are template
// instantiations chosen by two integer arguments.  There is no self-pair
// mask: at d = 0 the weighted displacement is exactly 0, as in the TPU
// kernel.  The Gaussian split uses the same Abramowitz-Stegun erfc
// polynomial as the reference (_erfc_pos), not erfcf.
//
// What bounds it: compute.  Every one of the N^2 pairs is visited (1.07e9
// pairs per force call at the default 32^3 configuration); each visit is
// about ten FP32 instructions (three differences, three rint-FMA minimum
// images, r^2) and the few pairs inside r_cut (0.3% of them in a uniform
// 500 Mpc box with r_cut = 44 Mpc) add about 40 flops and one rsqrt.  The
// input is 16 bytes per source, read once per block from L2.
//
// What the design does about it: one thread per target keeps the target
// and its three sums in registers; sources are staged through shared
// memory one 128-wide tile at a time as float4 (x, y, z, m), so each
// source is read from device memory once per block and broadcast from
// shared memory to all of the block's threads.  The weight is evaluated
// only under an r^2 < r_cut^2 branch, so the pairs outside the cutoff cost
// only the distance; the TPU kernel evaluated every weight and masked it.
// The TPU's 512 x 2048 tiles and its sequential-grid accumulation into the
// output block are not carried over: on the card the loop over sources
// runs inside the block and each block writes its targets once.

#include <cuda_runtime.h>

#include "short_weight.cuh"

namespace {

using nbody_kernels::Params;
using nbody_kernels::short_weight;

constexpr int kBlock = 128;  // targets per block == sources per tile

// packed: (4, npad) row-major [x; y; z; m], positions wrapped into [0, box),
// padding columns have m = 0.  npad is a multiple of kBlock.
// out: (n, 3) row-major.
template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kBlock)
p3m_short_kernel(const float* __restrict__ packed, int n, int npad, Params p,
                 float G, float* __restrict__ out) {
  __shared__ float4 tile[kBlock];
  const float* __restrict__ px = packed;
  const float* __restrict__ py = packed + npad;
  const float* __restrict__ pz = packed + 2 * static_cast<size_t>(npad);
  const float* __restrict__ pm = packed + 3 * static_cast<size_t>(npad);

  const int i = blockIdx.x * kBlock + threadIdx.x;
  // threads past n still stage their share of every tile
  const float xi = i < n ? px[i] : 0.0f;
  const float yi = i < n ? py[i] : 0.0f;
  const float zi = i < n ? pz[i] : 0.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int j0 = 0; j0 < npad; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = make_float4(px[j], py[j], pz[j], pm[j]);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBlock; ++t) {
      const float4 s = tile[t];
      float dx = s.x - xi;
      float dy = s.y - yi;
      float dz = s.z - zi;
      dx -= p.box * rintf(dx * p.inv_box);
      dy -= p.box * rintf(dy * p.inv_box);
      dz -= p.box * rintf(dz * p.inv_box);
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (fmaxf(r2, 1e-30f) < p.r_cut2) {
        const float w = s.w * short_weight<SPLIT, SOFT>(r2, p);
        ax += w * dx;
        ay += w * dy;
        az += w * dz;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    out[3 * static_cast<size_t>(i) + 0] = G * ax;
    out[3 * static_cast<size_t>(i) + 1] = G * ay;
    out[3 * static_cast<size_t>(i) + 2] = G * az;
  }
}

template <int SPLIT, int SOFT>
void launch(const float* packed, int n, int npad, const Params& p, float G,
            float* out, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  p3m_short_kernel<SPLIT, SOFT><<<blocks, kBlock, 0, stream>>>(packed, n, npad, p, G, out);
}

}  // namespace

extern "C" {

// Source-tile width: the wrapper pads npad to a multiple of this.
int p3m_short_tile(void) { return kBlock; }

// split: 0 = Gaussian, 1 = spline.  softening: 0 = Plummer, 1 = cubic spline.
// Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int p3m_short_acc_f32(const float* packed, int n, int npad, double box,
                      double eps, double r_s, double r_cut, double G, int split,
                      int softening, float* out, void* stream) {
  if (n < 0 || npad < n || npad % kBlock != 0 || split < 0 || split > 1 ||
      softening < 0 || softening > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Params p = nbody_kernels::make_params(box, eps, r_s, r_cut);
  const float g = static_cast<float>(G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 0) {
    if (softening == 0) launch<0, 0>(packed, n, npad, p, g, out, s);
    else                launch<0, 1>(packed, n, npad, p, g, out, s);
  } else {
    if (softening == 0) launch<1, 0>(packed, n, npad, p, g, out, s);
    else                launch<1, 1>(packed, n, npad, p, g, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
