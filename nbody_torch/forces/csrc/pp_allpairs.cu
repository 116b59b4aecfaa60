// K7: softened all-pairs gravity, float32 and float64, for sm_90a.
//
// Replaces the Pallas kernel _pp_kernel of nbody/forces/pallas_pp.py,
// which both allpairs_pallas and block_acc_pallas launch.
//
// What it computes: for every target i of pos_i against every source j of
// (pos_j, mass_j),
//   acc_i = sum_j m_j d_ij (r_ij^2 + eps^2)^(-3/2),
//   pot_i = sum_j m_j (r_ij^2 + eps^2)^(-1/2),     d_ij = x_j - x_i,
// with d_ij reduced to its minimum image (d - box * rint(d / box), rounding
// half to even as jnp.round does) when box > 0.  No G and no self-term:
// the wrappers apply both.  With eps > 0 a self pair adds exactly zero to
// acc and m / eps to pot, as in the TPU kernel.  Output: (ni, 4) row-major
// [ax, ay, az, pot].
//
// What bounds it: operations.  Every one of the ni * nj pairs is
// evaluated: three differences, r^2 + eps^2 (three FMAs), one rsqrt, three
// multiplies and four accumulating adds, about 20 flops a pair by the JAX
// package's cost estimate, plus one rsqrt on the SFU (16 a clock per SM
// against 128 FP32 lanes).  At N = 262,144 that is 6.87e10 pairs; the
// input is 16 bytes a source, read once per block from L2.
//
// What the design does about it: K1's design.  One thread per target keeps
// the target and its four sums in registers; sources are staged through
// shared memory one 128-wide tile at a time as (x, y, z, m), so each is
// read from device memory once per block and broadcast to all of the
// block's threads; the inner loop is branch-free.  The last tile is cut to
// the sources there are, so nj needs no padding.  Each tile's sums are
// added into the running sums once per tile (as the TPU kernel adds each
// j-tile's sum into its output block), which keeps the float32 rounding of
// a 262,144-term sum near that of a 2,048-term one.  The TPU's 512 x 2048
// VMEM tiles and its sequential-grid accumulation are not carried over:
// the loop over sources runs inside the block and each block writes its
// targets once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // targets per block == sources per tile

template <typename T>
struct alignas(4 * sizeof(T)) Source {
  T x, y, z, m;
};

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }

// pos_i: (ni, 3), pos_j: (nj, 3), mass_j: (nj,), all row-major;
// out: (ni, 4) row-major.
template <typename T, bool PERIODIC>
__global__ void __launch_bounds__(kBlock)
pp_kernel(const T* __restrict__ pos_i, int ni, const T* __restrict__ pos_j,
          const T* __restrict__ mass_j, int nj, T eps2, T box, T inv_box,
          T* __restrict__ out) {
  __shared__ Source<T> tile[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // threads past ni still stage their share of every tile
  const size_t i3 = 3 * static_cast<size_t>(i);
  const T xi = i < ni ? pos_i[i3 + 0] : T(0);
  const T yi = i < ni ? pos_i[i3 + 1] : T(0);
  const T zi = i < ni ? pos_i[i3 + 2] : T(0);
  T ax = 0, ay = 0, az = 0, pot = 0;

  for (int j0 = 0; j0 < nj; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < nj) {
      const size_t j3 = 3 * static_cast<size_t>(j);
      tile[threadIdx.x] = Source<T>{pos_j[j3 + 0], pos_j[j3 + 1],
                                    pos_j[j3 + 2], mass_j[j]};
    }
    __syncthreads();
    const int tn = min(kBlock, nj - j0);  // the same for the whole block
    T tx = 0, ty = 0, tz = 0, tp = 0;
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      const Source<T> s = tile[t];
      T dx = s.x - xi;
      T dy = s.y - yi;
      T dz = s.z - zi;
      if (PERIODIC) {
        dx -= box * rint_t(dx * inv_box);
        dy -= box * rint_t(dy * inv_box);
        dz -= box * rint_t(dz * inv_box);
      }
      const T r2 = dx * dx + dy * dy + dz * dz + eps2;
      const T inv_r = rsqrt_t(r2);
      const T mw = s.m * inv_r;        // m_j / r
      const T w = mw * inv_r * inv_r;  // m_j / r^3
      tx += w * dx;
      ty += w * dy;
      tz += w * dz;
      tp += mw;
    }
    ax += tx;
    ay += ty;
    az += tz;
    pot += tp;
    __syncthreads();
  }
  if (i < ni) {
    const size_t i4 = 4 * static_cast<size_t>(i);
    out[i4 + 0] = ax;
    out[i4 + 1] = ay;
    out[i4 + 2] = az;
    out[i4 + 3] = pot;
  }
}

template <typename T>
int launch(const T* pos_i, int ni, const T* pos_j, const T* mass_j, int nj,
           double eps2, double box, T* out, void* stream) {
  if (ni < 0 || nj < 0 || !(box >= 0.0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ni == 0) return 0;
  const int blocks = (ni + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T e2 = static_cast<T>(eps2);
  if (box > 0.0) {
    pp_kernel<T, true><<<blocks, kBlock, 0, s>>>(
        pos_i, ni, pos_j, mass_j, nj, e2, static_cast<T>(box),
        static_cast<T>(1.0 / box), out);
  } else {
    pp_kernel<T, false><<<blocks, kBlock, 0, s>>>(
        pos_i, ni, pos_j, mass_j, nj, e2, T(0), T(0), out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Raw sums of targets pos_i against sources (pos_j, mass_j); box > 0 takes
// minimum images.  Returns cudaGetLastError() after the launch (0 on
// success); 1 (cudaErrorInvalidValue) for arguments the kernel does not
// take.
int pp_allpairs_f32(const float* pos_i, int ni, const float* pos_j,
                    const float* mass_j, int nj, double eps2, double box,
                    float* out, void* stream) {
  return launch<float>(pos_i, ni, pos_j, mass_j, nj, eps2, box, out, stream);
}

int pp_allpairs_f64(const double* pos_i, int ni, const double* pos_j,
                    const double* mass_j, int nj, double eps2, double box,
                    double* out, void* stream) {
  return launch<double>(pos_i, ni, pos_j, mass_j, nj, eps2, box, out, stream);
}

}  // extern "C"
