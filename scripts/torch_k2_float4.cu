// K2 and K3: the supercell tier's PM deposit and its PM readback fused
// with the column pair sum, float32, for sm_90a.
//
// K2 replaces the Pallas kernel `_deposit_kernel` that
// nbody/forces/pm_supercell.py:_deposit_node_masses launches (from
// supercell_deposit_from_plane, and on a slab from supercell_deposit_local);
// K3 replaces `_column_pm_kernel` that pm_supercell.py:
// run_fused_column_plane launches (on a slab from
// nbody/distributed/domain.py:supercell_eval).  The plane layout is that
// of column_pairs.cuh.
//
// K2 computes the CIC mass grid (nmesh^3, periodic) of the plane's real
// slots (the first counts[c] interior slots of each column; z-ghosts and
// ghost columns excluded), with coordinates in mesh cells minus `shift`.
// The TPU kernel built each column's haloed 16 x 16 x ZP node grid with
// two matrix products (its MXU has no scatter) and left the overlap-add
// of the halos to XLA.  What bounds it on the card: bytes, 16 B read a
// particle and 4 B written a mesh node (8.4 MB at 128^3).
//
// The design: one thread a real slot, its 8 corner masses added straight
// into the mesh with global atomics, as before the redesign: the adds
// bound it (2.1 M at cfg64, ~80 G a second from L2 on an H100), so
// the two corners of a node line, adjacent in z, go as one float4 atomic
// (red.global.add.v4.f32) on the aligned four nodes that hold both,
// unless the pair straddles four: 5 atomics a slot on average, not 8.
// The mesh is zeroed by a memset in the same library call.  The order of
// the adds changes from run to run, so the mesh agrees with the plain
// version to float32 summation order and is not equal bit for bit across
// launches.  A shared-memory tile a column and z range (the TPU kernel's
// node subgrid), with its ring added by a second kernel, ran slower
// (scripts/torch_k2_tile.cu, scripts/torch_k2_ablation.py); so does a
// float atomicAdd to shared memory, which on this card is a
// compare-and-swap loop.
//
// On a slab of the domain decomposition (`slab` = 1) both kernels run
// over the slab's nx = ncell / D interior x-rows, the first of which is
// row `row0` of the whole box's chaining grid, and x no longer wraps.
// The plane keeps box coordinates: a particle's coordinates in cells are
// taken against its tile's origin in the box, op by op as on the whole
// box's plane (so a slab rounds each CIC weight exactly as one device
// does), and only its node index is made slab-local.  (The TPU kernel
// works on a plane whose x the caller shifted to the slab's origin,
// nbody/distributed/domain.py:807; the shift rounds x once more.)  Then:
// K2 writes into a haloed slab of nx * S + 3 mesh planes (plane p holds
// local node p - 1; the caller sends planes 0 and nx * S + 1, + 2 to the
// neighbours, as pm_supercell.py:supercell_deposit_local does with its
// ppermutes), and K3 reads haloed force grids of nx * S + 4 planes (local
// node p - 1 again: one plane from the left neighbour, three from the
// right, the x extent of extract_local_subgrids).  A resident particle's
// CIC corners lie in local nodes -1 .. nx * S + 1, inside the halo; a
// corner outside it (the sentinel slots of a chunk's tail, parked far
// off) adds and reads nothing, as the TPU kernel's node subgrid gives it
// no weight.
//
// K3 computes K4's output (p3m_columns.cu) with the PM force added first:
// each target reads its 8 CIC corners of the force grids (3, nmesh^3)
// with periodic indices from its coordinates in cells relative to its
// column's tile origin, as the TPU kernel's triangle weights did; with
// `interlaced` it also reads grids 3-5 at -0.5 cell and averages the two.
// The result starts the target's sum (rows 0-2), or goes to rows 3-5 with
// `split_out` while rows 0-2 hold the short-range sum alone.  The TPU's
// 256-row x ZP triangle contraction over a per-column node subgrid was
// MXU mechanics; on the card the 24 (48 interlaced) corner reads per
// target come from the force grids in L2 and need no subgrid gather.
// What bounds it: the pair sum, as K4.

#include <cuda_runtime.h>

#include "column_pairs.cuh"

namespace {

using nbody_kernels::ColumnGeom;
using nbody_kernels::ColumnTarget;
using nbody_kernels::kColTargets;
using nbody_kernels::kColThreads;
using nbody_kernels::Params;

// K2: threads a block
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

// Adds the z pair (w0 at node iz, w1 at iz + 1, periodic) of one node
// line: a float4 atomic on the aligned four nodes that hold both, or,
// where the pair straddles four (or the rows are not aligned to four
// floats), two scalar atomics.
__device__ __forceinline__ void add_pair(float* __restrict__ line, int iz,
                                         int nmesh, bool vec, float w0,
                                         float w1) {
  const int z = wrap(iz, nmesh);
  const int k = z & 3;
  if (vec && k != 3) {
    const float4 v = make_float4(k == 0 ? w0 : 0.0f,
                                 k == 0 ? w1 : (k == 1 ? w0 : 0.0f),
                                 k == 1 ? w1 : (k == 2 ? w0 : 0.0f),
                                 k == 2 ? w1 : 0.0f);
    atomicAdd(reinterpret_cast<float4*>(line + (z - k)), v);
  } else {
    atomicAdd(line + z, w0);
    atomicAdd(line + wrap(iz + 1, nmesh), w1);
  }
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
  const bool vec = (nmesh & 3) == 0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int px = x_plane(ix + a, nmesh, nxg, slab);
    if (px < 0) continue;
    const size_t gx = static_cast<size_t>(px) * nmesh;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wxy = wx[a] * wy[b] * m;
      add_pair(rho + (gx + wrap(iy + b, nmesh)) * nmesh, iz, nmesh, vec,
               wxy * (1.0f - fz), wxy * fz);
    }
  }
}

// Trilinear read of three (nxg, nmesh, nmesh) grids spaced n3 apart at
// (x, y, z) in cells, x and y relative to the tile origin (x0, y0); x
// periodic, or haloed on a slab (x_plane).
__device__ __forceinline__ float3 cic_read3(const float* __restrict__ grids,
                                            size_t n3, int nmesh, int nxg,
                                            int slab, float x, float y,
                                            float z, int x0, int y0) {
  const float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
  const float fx = x - fx0, fy = y - fy0, fz = z - fz0;
  const int ix = static_cast<int>(fx0) + x0;
  const int iy = static_cast<int>(fy0) + y0;
  const int iz = static_cast<int>(fz0);
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
  float3 f = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int px = x_plane(ix + a, nmesh, nxg, slab);
    if (px < 0) continue;
    const size_t gx = static_cast<size_t>(px) * nmesh;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const size_t gxy = (gx + wrap(iy + b, nmesh)) * nmesh;
      const float wxy = wx[a] * wy[b];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t j = gxy + wrap(iz + c, nmesh);
        const float w = wxy * wz[c];
        f.x += w * grids[j];
        f.y += w * grids[n3 + j];
        f.z += w * grids[2 * n3 + j];
      }
    }
  }
  return f;
}

template <int SPLIT, int SOFT, bool INTERLACED, bool SPLIT_OUT>
__global__ void __launch_bounds__(kColThreads)
fused_kernel(const float* __restrict__ plane, const int* __restrict__ ws,
             const int* __restrict__ nch, const float* __restrict__ grids,
             int nmesh, int nxg, int slab, int row0, int S, float scale,
             ColumnGeom g, Params p, float* __restrict__ out) {
  __shared__ nbody_kernels::ColumnShared sh;
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block(g, nch, ic, k, first)) return;
  const int x0 = (ic / g.ncell) * S;
  const int y0 = (ic % g.ncell) * S;
  const size_t n3 = static_cast<size_t>(nxg) * nmesh * nmesh;
  const size_t i = nbody_kernels::target_slot(first);
  ColumnTarget t = nbody_kernels::load_target(plane, g, i);
  // PM force at the target (the TPU kernel's first-neighbour visit)
  const float xr = __fsub_rn(__fmul_rn(t.x, scale),
                             static_cast<float>(x0 + row0 * S));
  const float yr = __fsub_rn(__fmul_rn(t.y, scale), static_cast<float>(y0));
  const float zr = __fmul_rn(t.z, scale);
  float3 pm = cic_read3(grids, n3, nmesh, nxg, slab, xr, yr, zr, x0, y0);
  if (INTERLACED) {
    // the shift subtracts, as in the gather's convention
    const float3 f1 = cic_read3(grids + 3 * n3, n3, nmesh, nxg, slab,
                                xr - 0.5f, yr - 0.5f, zr - 0.5f, x0, y0);
    pm.x = 0.5f * (pm.x + f1.x);
    pm.y = 0.5f * (pm.y + f1.y);
    pm.z = 0.5f * (pm.z + f1.z);
  }
  if (!SPLIT_OUT) {
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
}

template <int SPLIT, int SOFT, bool INTERLACED, bool SPLIT_OUT>
void launch_fused(const float* plane, const int* ws, const int* nch,
                  const float* grids, int nmesh, int nxg, int slab, int row0,
                  int S, float scale, const ColumnGeom& g, const Params& p,
                  float* out, cudaStream_t stream) {
  const dim3 grid(g.nx * g.ncell, g.maxch * (g.chunk / kColTargets));
  fused_kernel<SPLIT, SOFT, INTERLACED, SPLIT_OUT>
      <<<grid, kColThreads, 0, stream>>>(plane, ws, nch, grids, nmesh, nxg,
                                         slab, row0, S, scale, g, p, out);
}

template <int SPLIT, int SOFT>
void dispatch_fused(bool interlaced, bool split_out, const float* plane,
                    const int* ws, const int* nch, const float* grids,
                    int nmesh, int nxg, int slab, int row0, int S,
                    float scale, const ColumnGeom& g, const Params& p,
                    float* out, cudaStream_t s) {
  if (interlaced) {
    if (split_out)
      launch_fused<SPLIT, SOFT, true, true>(plane, ws, nch, grids, nmesh, nxg,
                                            slab, row0, S, scale, g, p, out,
                                            s);
    else
      launch_fused<SPLIT, SOFT, true, false>(plane, ws, nch, grids, nmesh,
                                             nxg, slab, row0, S, scale, g, p,
                                             out, s);
  } else {
    if (split_out)
      launch_fused<SPLIT, SOFT, false, true>(plane, ws, nch, grids, nmesh,
                                             nxg, slab, row0, S, scale, g, p,
                                             out, s);
    else
      launch_fused<SPLIT, SOFT, false, false>(plane, ws, nch, grids, nmesh,
                                              nxg, slab, row0, S, scale, g, p,
                                              out, s);
  }
}

}  // namespace

extern "C" {

// K2.  plane (8, (nx + 2) * (ncell + 2) * stride) float32; counts
// (nx * ncell,) int32 (real slots per column, <= CK); rho receives the
// masses (zeroed here first, on `stream`): (nmesh^3,) with nx = ncell and
// slab = 0, or on a slab (slab = 1, nx = ncell / D, its first x-row row0
// of the box's grid) the haloed (nx * S + 3, nmesh, nmesh).  Returns
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      rho, 0, static_cast<size_t>(nxg) * nmesh * nmesh * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nx * ncell, (CK + kDepositThreads - 1) / kDepositThreads);
  deposit_kernel<<<grid, kDepositThreads, 0, s>>>(
      plane, counts, ncell, S, nmesh, nxg, slab, row0, stride, gz, row,
      static_cast<float>(scale), static_cast<float>(shift), rho);
  return static_cast<int>(cudaGetLastError());
}

// K3.  plane, ws, nch, out, box and drift as p3m_columns_f32; grids (3,
// nxg, nmesh, nmesh) float32, or (6, ...) with `interlaced` (rows 3-5 read
// at -0.5 cell): nxg = nmesh periodic (slab = 0, nx = ncell), or on a slab
// (slab = 1, its first x-row row0 of the box's grid) the haloed
// nx * S + 4 planes.  `split_out` writes the PM force to rows 3-5 and the
// short-range sum alone to rows 0-2.
int pm_supercell_fused_f32(const float* plane, const int* ws, const int* nch,
                           const float* grids, int nmesh, int interlaced,
                           int split_out, int nx, int ncell, int slab,
                           int row0, int S, double scale, int stride, int W,
                           int maxch, int gz, int chunk, double eps,
                           double r_s, double r_cut, double box,
                           const float* drift, int split, int softening,
                           float* out, void* stream) {
  if (ncell < 1 || nx < 1 || nx > ncell || (slab == 0 && nx != ncell) ||
      slab < 0 || slab > 1 || row0 < 0 || row0 + nx > ncell ||
      (slab == 0 && row0 != 0) || S < 1 || nmesh != ncell * S || stride < 1 ||
      W < 1 || W > stride || maxch < 1 || gz < 0 || chunk < kColTargets ||
      chunk % kColTargets != 0 || gz + maxch * chunk > stride ||
      split < 0 || split > 1 || softening < 0 || softening > 1 ||
      !(box > 0.0) || maxch * (chunk / kColTargets) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ColumnGeom g = nbody_kernels::make_geom(nx, ncell, stride, W, maxch,
                                                gz, chunk, box, r_cut, drift);
  const int nxg = slab ? nx * S + 4 : nmesh;
  // the column tiers bake the box into the ghost coordinates
  const Params p = nbody_kernels::make_params(1.0, eps, r_s, r_cut);
  const float sc = static_cast<float>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool il = interlaced != 0, so = split_out != 0;
  if (split == 0) {
    if (softening == 0)
      dispatch_fused<0, 0>(il, so, plane, ws, nch, grids, nmesh, nxg, slab,
                           row0, S, sc, g, p, out, s);
    else
      dispatch_fused<0, 1>(il, so, plane, ws, nch, grids, nmesh, nxg, slab,
                           row0, S, sc, g, p, out, s);
  } else {
    if (softening == 0)
      dispatch_fused<1, 0>(il, so, plane, ws, nch, grids, nmesh, nxg, slab,
                           row0, S, sc, g, p, out, s);
    else
      dispatch_fused<1, 1>(il, so, plane, ws, nch, grids, nmesh, nxg, slab,
                           row0, S, sc, g, p, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
