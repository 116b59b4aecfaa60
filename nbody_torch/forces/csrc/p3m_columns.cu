// K4: the column-packed short-range P3M pair sum, float32, for sm_90a,
// and K5, the same sum restricted to a chunk table of active chunks.
//
// K4 replaces the Pallas kernel `_column_kernel` (with `_pair_accum`) that
// nbody/forces/p3m_columns.py:_run_column_kernel launches, and that
// p3m_columns.py:p3m_short_columns_local launches on a slab's plane of the
// domain decomposition (nx = ncell / D interior x-rows); K5 replaces
// `_column_kernel_masked` that p3m_columns.py:
// p3m_short_columns_frozen_masked launches (the rung tier's interior
// ticks on a frozen plan) and p3m_columns.py:
// p3m_local_columns_frozen_masked launches on a shard's frozen slab
// plane (the domain rung tier's interior ticks, nx = ncell / D).
//
// What it computes: for every target slot of every occupied 256-slot
// chunk of every interior column of the plane (column_pairs.cuh), the sum
// over the chunk's 9 neighbour z-windows of m_j * w(r_ij^2) * (x_j - x_i),
// w the cutoff-masked weight of short_weight.cuh; written to rows 0-2 of
// the (8, P2 * stride) output plane at the target's slot.  The wrapper
// zeroes the output, so every other slot and row is 0.
//
// What bounds it: compute.  Each target visits 9 * W window slots (about
// 4,600 at the 64^3-particle production geometry, 1.2e9 visits per call);
// a visit is three differences, r^2 and the cutoff test, and the ~3% of
// visits inside r_cut add the weight (~40 flops and one rsqrt).  The plane
// (16 MB at 64^3) is read from L2 once per block.
//
// What the design does about it: the TPU kernel walked the 9 neighbours
// as a sequential grid axis and carried the output column between grid
// steps.  Blocks on the card run in no order, so here one block owns 128
// targets of one (column, chunk) and loops over all 9 neighbours itself;
// each output is written once, with no atomics.  The window streams
// through shared memory in float4 tiles of 128 sources, as in K1, and the
// weight is evaluated only under the cutoff branch.  Two blocks per
// 256-slot chunk give ~2,500 blocks at the production geometry (K1's 256
// blocks left most SMs idle).  Windows wider than 512 (healed clustered
// states) only lengthen the tile loop.
//
// K5: the TPU kernel looped over a column's active chunks with a dynamic
// trip count read from scalar memory.  Here the grid is K4's, a block per
// (column, chunk-table slot, half chunk), and a block past the column's
// active count returns at once; the others read their chunk index from
// the table and run K4's body.  Slots of chunks not in the table stay 0.
// What bounds it: as K4, over the active chunks only.

#include <cuda_runtime.h>

#include "column_pairs.cuh"

namespace {

using nbody_kernels::ColumnGeom;
using nbody_kernels::kColThreads;
using nbody_kernels::Params;

template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kColThreads)
column_kernel(const float* __restrict__ plane, const int* __restrict__ ws,
              const int* __restrict__ nch, ColumnGeom g, Params p,
              float* __restrict__ out) {
  __shared__ float4 tile[kColThreads];
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block(g, nch, ic, k, first)) return;
  const size_t i = first + threadIdx.x;
  const float xi = plane[i];
  const float yi = plane[g.row + i];
  const float zi = plane[2 * g.row + i];
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  nbody_kernels::column_pair_sum<SPLIT, SOFT>(plane, ws, g, ic, k, xi, yi, zi,
                                              p, tile, ax, ay, az);
  out[i] = ax;
  out[g.row + i] = ay;
  out[2 * g.row + i] = az;
}

template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kColThreads)
column_kernel_masked(const float* __restrict__ plane,
                     const int* __restrict__ ws,
                     const int* __restrict__ nch_act,
                     const int* __restrict__ cht, ColumnGeom g, Params p,
                     float* __restrict__ out) {
  __shared__ float4 tile[kColThreads];
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block_masked(g, nch_act, cht, ic, k, first))
    return;
  const size_t i = first + threadIdx.x;
  const float xi = plane[i];
  const float yi = plane[g.row + i];
  const float zi = plane[2 * g.row + i];
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  nbody_kernels::column_pair_sum<SPLIT, SOFT>(plane, ws, g, ic, k, xi, yi, zi,
                                              p, tile, ax, ay, az);
  out[i] = ax;
  out[g.row + i] = ay;
  out[2 * g.row + i] = az;
}

// cht == nullptr launches K4, else K5 with nch the active counts.
template <int SPLIT, int SOFT>
void launch(const float* plane, const int* ws, const int* nch, const int* cht,
            const ColumnGeom& g, const Params& p, float* out,
            cudaStream_t stream) {
  const dim3 grid(g.nx * g.ncell, g.maxch * (g.chunk / kColThreads));
  if (cht == nullptr)
    column_kernel<SPLIT, SOFT><<<grid, kColThreads, 0, stream>>>(
        plane, ws, nch, g, p, out);
  else
    column_kernel_masked<SPLIT, SOFT><<<grid, kColThreads, 0, stream>>>(
        plane, ws, nch, cht, g, p, out);
}

int run(const float* plane, const int* ws, const int* nch, const int* cht,
        int nx, int ncell, int stride, int W, int maxch, int gz, int chunk,
        double eps, double r_s, double r_cut, int split, int softening,
        float* out, void* stream) {
  if (ncell < 1 || nx < 1 || nx > ncell || stride < 1 || W < 1 ||
      W > stride || maxch < 1 || gz < 0 || chunk < kColThreads ||
      chunk % kColThreads != 0 ||
      gz + maxch * chunk > stride || split < 0 || split > 1 ||
      softening < 0 || softening > 1 ||
      maxch * (chunk / kColThreads) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ColumnGeom g;
  g.nx = nx;
  g.ncell = ncell;
  g.stride = stride;
  g.W = W;
  g.maxch = maxch;
  g.gz = gz;
  g.chunk = chunk;
  g.row = static_cast<size_t>(nx + 2) * (ncell + 2) * stride;
  // the column tiers bake the box into the ghost coordinates
  const Params p = nbody_kernels::make_params(1.0, eps, r_s, r_cut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 0) {
    if (softening == 0) launch<0, 0>(plane, ws, nch, cht, g, p, out, s);
    else                launch<0, 1>(plane, ws, nch, cht, g, p, out, s);
  } else {
    if (softening == 0) launch<1, 0>(plane, ws, nch, cht, g, p, out, s);
    else                launch<1, 1>(plane, ws, nch, cht, g, p, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// plane (8, (nx + 2) * (ncell + 2) * stride) float32, nx interior x-rows
// (ncell for the whole box, ncell / D for a slab's plane); ws
// (nx * ncell * 9 * maxch,) int32; nch (nx * ncell,) int32; out like
// plane, zeroed by the caller.
// split: 0 = Gaussian, 1 = spline.  softening: 0 = Plummer, 1 = cubic
// spline.  Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int p3m_columns_f32(const float* plane, const int* ws, const int* nch,
                    int nx, int ncell, int stride, int W, int maxch, int gz,
                    int chunk, double eps, double r_s, double r_cut, int split,
                    int softening, float* out, void* stream) {
  return run(plane, ws, nch, nullptr, nx, ncell, stride, W, maxch, gz, chunk,
             eps, r_s, r_cut, split, softening, out, stream);
}

// K5.  As p3m_columns_f32, with nch_act (nx * ncell,) int32 the active
// chunks of each column and cht (nx * ncell * maxch,) int32 their indices
// (the first nch_act[ic] entries of row ic).
int p3m_columns_masked_f32(const float* plane, const int* ws,
                           const int* nch_act, const int* cht, int nx,
                           int ncell, int stride, int W, int maxch, int gz,
                           int chunk, double eps, double r_s, double r_cut,
                           int split, int softening, float* out,
                           void* stream) {
  return run(plane, ws, nch_act, cht, nx, ncell, stride, W, maxch, gz, chunk,
             eps, r_s, r_cut, split, softening, out, stream);
}

}  // extern "C"
