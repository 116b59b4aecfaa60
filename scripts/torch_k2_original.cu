// K2 before its redesign for Hopper: the supercell tier's CIC deposit,
// float32, for sm_90a, one thread a real slot adding its 8 corner masses
// straight into the mesh (or a slab's haloed planes) with atomicAdd; the
// caller zeroes the mesh first.  The source of nbody_torch/forces/csrc/
// pm_supercell.cu's deposit before the redesign, kept here so that
// scripts/torch_k2_ablation.py and chip_smoke.py can time it beside the
// kernel: it builds alone (nvcc -shared) and exports the same entry point
// with the signature it had then.
//
// It replaces the Pallas kernel `_deposit_kernel` that
// nbody/forces/pm_supercell.py:_deposit_node_masses launches.  What bounds
// it: bytes, 16 B read a particle and 4 B a mesh node; its 8 global
// atomics a particle go to L2.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDepositThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The mesh x-plane of node `ix`: periodic over nmesh, or on a slab the
// haloed plane ix + 1 of nxg, -1 outside the halo.
__device__ __forceinline__ int x_plane(int ix, int nmesh, int nxg, int slab) {
  if (!slab) return wrap(ix, nmesh);
  return (ix + 1 >= 0 && ix + 1 < nxg) ? ix + 1 : -1;
}

__global__ void __launch_bounds__(kDepositThreads)
deposit_kernel(const float* __restrict__ plane, const int* __restrict__ counts,
               int ncell, int S, int nmesh, int nxg, int slab, int row0,
               int stride, int gz, size_t row, float scale, float shift,
               float* __restrict__ rho) {
  const int ic = blockIdx.x;
  const int r = blockIdx.y * kDepositThreads + threadIdx.x;
  if (r >= counts[ic]) return;
  const int cx = ic / ncell;
  const int cy = ic % ncell;
  const int P = ncell + 2;
  const size_t i =
      static_cast<size_t>((cx + 1) * P + (cy + 1)) * stride + gz + r;
  // coordinates in cells relative to the tile origin, as the TPU kernel,
  // rounded op by op as the plain version (no multiply-add contraction)
  const float x = __fsub_rn(__fsub_rn(__fmul_rn(plane[i], scale),
                                      static_cast<float>((cx + row0) * S)),
                            shift);
  const float y = __fsub_rn(__fsub_rn(__fmul_rn(plane[row + i], scale),
                                      static_cast<float>(cy * S)), shift);
  const float z = __fsub_rn(__fmul_rn(plane[2 * row + i], scale), shift);
  const float m = plane[3 * row + i];
  const float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
  const float fx = x - fx0, fy = y - fy0, fz = z - fz0;
  const int ix = static_cast<int>(fx0) + cx * S;
  const int iy = static_cast<int>(fy0) + cy * S;
  const int iz = static_cast<int>(fz0);
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int px = x_plane(ix + a, nmesh, nxg, slab);
    if (px < 0) continue;
    const size_t gx = static_cast<size_t>(px) * nmesh;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const size_t gxy = (gx + wrap(iy + b, nmesh)) * nmesh;
      const float wxy = wx[a] * wy[b] * m;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        atomicAdd(rho + gxy + wrap(iz + c, nmesh), wxy * wz[c]);
      }
    }
  }
}

}  // namespace

extern "C" {

// K2.  plane (8, (nx + 2) * (ncell + 2) * stride) float32; counts
// (nx * ncell,) int32 (real slots per column, <= CK); rho, zeroed by the
// caller, receives the masses: (nmesh^3,) with nx = ncell and slab = 0,
// or on a slab (slab = 1, nx = ncell / D, its first x-row row0 of the
// box's grid) the haloed (nx * S + 3, nmesh, nmesh).  Returns
// cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int pm_supercell_deposit_f32(const float* plane, const int* counts, int nx,
                             int ncell, int slab, int row0, int S, int nmesh,
                             int stride, int gz, int CK, double scale,
                             double shift, float* rho, void* stream) {
  if (ncell < 1 || nx < 1 || nx > ncell || (slab == 0 && nx != ncell) ||
      slab < 0 || slab > 1 || row0 < 0 || row0 + nx > ncell ||
      (slab == 0 && row0 != 0) || S < 1 || nmesh != ncell * S ||
      stride < 1 || gz < 0 || CK < 1 || gz + CK > stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t row = static_cast<size_t>(nx + 2) * (ncell + 2) * stride;
  const int nxg = slab ? nx * S + 3 : nmesh;
  const dim3 grid(nx * ncell, (CK + kDepositThreads - 1) / kDepositThreads);
  deposit_kernel<<<grid, kDepositThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      plane, counts, ncell, S, nmesh, nxg, slab, row0, stride, gz, row,
      static_cast<float>(scale), static_cast<float>(shift), rho);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
