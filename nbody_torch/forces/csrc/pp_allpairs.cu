// K7: softened all-pairs gravity, float32 and float64, for sm_90a.
//
// Replaces the Pallas kernel _pp_kernel of nbody/forces/pallas_pp.py,
// which both allpairs_pallas and block_acc_pallas launch (the latter also
// from the ring of nbody/distributed/sharding.py).
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
// What bounds it: operations.  The repo's bound is the JAX package's cost
// estimate, 20 flops a pair at the card's 67 TFLOP/s float32 rate: 20.51
// ms for the 6.87e10 pairs of N = 262,144.  No float32 design reaches it.
// The card issues one warp instruction a clock per scheduler, whatever it
// is, and the 67 TFLOP/s counts every slot as an FMA (2 flops), but only
// six of a pair's instructions are FMAs (r^2 + eps^2 and the three force
// sums): the three differences, the potential's add and the three
// multiplies for m/r and m/r^3 are one flop a slot, and rsqrt takes a
// slot of its own.  Counted from the built kernel's SASS (cuobjdump -sass
// of the hot loop, scripts/torch_k7_ablation.py): 4 FADD, 6 FFMA, 3 FMUL,
// 1 MUFU.RSQ, 1/4 LDS.128 and 0.6 of loop control, 14.9 issue slots a
// pair, so the issue floor is 30.6 ms at N = 262,144 and 1,980 MHz (1.91
// ms for a 65,536^2 ring launch).  The SFU (16 rsqrt a clock per SM)
// needs 8 of a warp's 14.9 cycles a pair, and the input is 16 bytes a
// source, read once per block from L2: neither binds.
//
// What the design does about it:
// * R = 4 targets a thread (float32), in registers with their sums.  One
//   shared-memory read of a source (x, y, z, m), a broadcast LDS.128,
//   serves R pairs, and the R rsqrt chains are independent, so the
//   scheduler has work while the SFU answers.  r^2 + eps^2 is summed from
//   the right so that it is three FMAs (left to right it would be a
//   multiply, two FMAs and an add).  The source loop is unrolled 2 deep:
//   70 registers, 7 blocks an SM.
// * rsqrt.approx.ftz.f32, one MUFU.RSQ.  rsqrtf compiles without -ftz to
//   the same instruction behind a three-instruction denormal guard.  The
//   argument is at least eps^2 > 0 wherever the wrappers allow eps > 0
//   (allpairs_pallas and the ring refuse eps <= 0).  block_acc_pallas with
//   eps = 0 keeps its NaN on a coincident pair (rsqrt(0) = inf, inf * 0),
//   and the flush adds no failure: an r^2 below 2^-126 gives 1/r^3 above
//   2^189, which already overflowed float32 in m/r^3 before.
// * A card filled at both launch shapes.  Where the target blocks make
//   fewer than 8 waves of the resident slots (a 65,536-target ring launch
//   makes 128 blocks of 512 targets, N = 262,144 makes 512, and the card
//   holds 924), the sources are cut into S slices of whole tiles
//   (the last tile of the last slice is cut to the sources there are, so
//   nj needs no padding); block (b, s) writes its targets' sums over slice
//   s into part[s], and sum_slices adds the S partials in slice order.  S
//   is chosen by launch_geometry in nbody_torch/forces/pallas_pp.py from
//   the SM count and the resident blocks per SM that pp_allpairs_info
//   returns.  No atomics: two launches on the same inputs give the same
//   bits.
// * Each 128-source tile's sums are added into the running sums once per
//   tile (as the TPU kernel adds each j-tile's sum into its output block),
//   which keeps the float32 rounding of a 262,144-term sum near that of a
//   tile-sized one.
// The float64 form (the Kepler and solar-system drives) is the same
// template at R = 1 with rsqrt in float64.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block == sources per tile
constexpr int kTargetsF32 = 4;  // targets per thread, float32
constexpr int kTargetsF64 = 1;  // targets per thread, float64

template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T x, y, z, w;
};

// one MUFU.RSQ (see the note above)
__device__ __forceinline__ float rsqrt_t(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }

// pos_i: (ni, 3), pos_j: (nj, 3), mass_j: (nj,), all row-major; block
// (b, s) takes targets [b R kThreads, (b + 1) R kThreads) against sources
// [s slice, min(nj, (s + 1) slice)) and writes out + s ni 4, (ni, 4)
// row-major.  Thread t holds targets b R kThreads + t + r kThreads.
template <typename T, int R, bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
pp_kernel(const T* __restrict__ pos_i, int ni, const T* __restrict__ pos_j,
          const T* __restrict__ mass_j, int nj, int slice, T eps2, T box,
          T inv_box, T* __restrict__ out) {
  __shared__ Quad<T> tile[kThreads];
  const int i0 = blockIdx.x * (R * kThreads) + threadIdx.x;
  T xi[R], yi[R], zi[R], ax[R], ay[R], az[R], pot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past ni still stage their share of every tile
    const int i = i0 + r * kThreads;
    const size_t i3 = 3 * static_cast<size_t>(i);
    xi[r] = i < ni ? pos_i[i3 + 0] : T(0);
    yi[r] = i < ni ? pos_i[i3 + 1] : T(0);
    zi[r] = i < ni ? pos_i[i3 + 2] : T(0);
    ax[r] = ay[r] = az[r] = pot[r] = T(0);
  }
  const int jb = blockIdx.y * slice;
  const int je = nj - jb <= slice ? nj : jb + slice;

  for (int j0 = jb; j0 < je; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < je) {
      const size_t j3 = 3 * static_cast<size_t>(j);
      tile[threadIdx.x] = Quad<T>{pos_j[j3 + 0], pos_j[j3 + 1], pos_j[j3 + 2],
                                  mass_j[j]};
    }
    __syncthreads();
    const int tn = min(kThreads, je - j0);  // the same for the whole block
    T tx[R], ty[R], tz[R], tp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = tp[r] = T(0);
#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const Quad<T> s = tile[t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T dx = s.x - xi[r];
        T dy = s.y - yi[r];
        T dz = s.z - zi[r];
        if (PERIODIC) {
          dx -= box * rint_t(dx * inv_box);
          dy -= box * rint_t(dy * inv_box);
          dz -= box * rint_t(dz * inv_box);
        }
        const T r2 = dx * dx + (dy * dy + (dz * dz + eps2));  // 3 FMAs
        const T inv_r = rsqrt_t(r2);
        const T mw = s.w * inv_r;        // m_j / r
        const T w = mw * inv_r * inv_r;  // m_j / r^3
        tx[r] += w * dx;
        ty[r] += w * dy;
        tz[r] += w * dz;
        tp[r] += mw;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ax[r] += tx[r];
      ay[r] += ty[r];
      az[r] += tz[r];
      pot[r] += tp[r];
    }
    __syncthreads();
  }
  Quad<T>* o = reinterpret_cast<Quad<T>*>(out) +
               static_cast<size_t>(blockIdx.y) * ni;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i < ni) o[i] = Quad<T>{ax[r], ay[r], az[r], pot[r]};
  }
}

// out[k] = part[0][k] + part[1][k] + ... + part[slices - 1][k], in that
// order, for k < n: the same bits on every launch
template <typename T>
__global__ void sum_slices(const T* __restrict__ part, size_t n, int slices,
                           T* __restrict__ out) {
  const size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (k >= n) return;
  T sum = part[k];
  for (int s = 1; s < slices; ++s) sum += part[s * n + k];
  out[k] = sum;
}

template <typename T, int R>
int info(bool periodic, int* out) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = periodic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, pp_kernel<T, R, true>, kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, pp_kernel<T, R, false>, kThreads, 0);
  }
  out[0] = kThreads;
  out[1] = R;
  out[2] = blocks;
  out[3] = sms;
  return static_cast<int>(err);
}

template <typename T, int R>
int launch(const T* pos_i, int ni, const T* pos_j, const T* mass_j, int nj,
           double eps2, double box, int slice, int slices, T* part, T* out,
           void* stream) {
  // the slices are whole tiles, cover the sources and none is empty
  const long long covered = static_cast<long long>(slice) * slices;
  if (ni < 0 || nj < 0 || nj > INT_MAX - kThreads || !(box >= 0.0) ||
      slice < 1 || slice % kThreads != 0 || slices < 1 || slices > 65535 ||
      covered < nj || covered - slice >= (nj > 0 ? nj : 1) ||
      (slices > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ni == 0) return 0;
  const dim3 grid((ni + R * kThreads - 1) / (R * kThreads), slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T e2 = static_cast<T>(eps2);
  T* dst = slices > 1 ? part : out;
  if (box > 0.0) {
    pp_kernel<T, R, true><<<grid, kThreads, 0, s>>>(
        pos_i, ni, pos_j, mass_j, nj, slice, e2, static_cast<T>(box),
        static_cast<T>(1.0 / box), dst);
  } else {
    pp_kernel<T, R, false><<<grid, kThreads, 0, s>>>(
        pos_i, ni, pos_j, mass_j, nj, slice, e2, T(0), T(0), dst);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && slices > 1) {
    const size_t n = 4 * static_cast<size_t>(ni);
    const int threads = 256;
    sum_slices<T><<<static_cast<unsigned>((n + threads - 1) / threads),
                    threads, 0, s>>>(part, n, slices, out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Raw sums of targets pos_i against sources (pos_j, mass_j); box > 0 takes
// minimum images.  The sources are cut into `slices` slices of `slice`
// sources (a multiple of the tile, 128); with more than one, `part` holds
// (slices, ni, 4) partial sums.  Returns cudaGetLastError() after the
// launches (0 on success); 1 (cudaErrorInvalidValue) for arguments the
// kernel does not take.
int pp_allpairs_f32(const float* pos_i, int ni, const float* pos_j,
                    const float* mass_j, int nj, double eps2, double box,
                    int slice, int slices, float* part, float* out,
                    void* stream) {
  return launch<float, kTargetsF32>(pos_i, ni, pos_j, mass_j, nj, eps2, box,
                                    slice, slices, part, out, stream);
}

int pp_allpairs_f64(const double* pos_i, int ni, const double* pos_j,
                    const double* mass_j, int nj, double eps2, double box,
                    int slice, int slices, double* part, double* out,
                    void* stream) {
  return launch<double, kTargetsF64>(pos_i, ni, pos_j, mass_j, nj, eps2, box,
                                     slice, slices, part, out, stream);
}

// The launch shape of the current device's kernel for float64 (f64 != 0)
// or float32, periodic or not: out = [threads a block (== sources a tile),
// targets a thread, resident blocks per SM, SM count].  Returns a CUDA
// error code (0 on success).
int pp_allpairs_info(int f64, int periodic, int* out) {
  return f64 ? info<double, kTargetsF64>(periodic != 0, out)
             : info<float, kTargetsF32>(periodic != 0, out);
}

}  // extern "C"
