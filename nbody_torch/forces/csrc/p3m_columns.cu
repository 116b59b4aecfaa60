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
// What bounds it: compute.  A target has ~100 pairs inside r_cut at the
// 64^3-particle production geometry; its 9 windows hold 9 * W slots (W
// the plane's widest window: 9,000-26,000 a target), 3% of them inside
// r_cut, and the reach of a block of 128 targets about 2,000.
//
// What the design does about it: the TPU kernel walked the 9 neighbours
// as a sequential grid axis and carried the output column between grid
// steps.  Blocks on the card run in no order, so here one block owns 128
// targets of one (column, chunk), one a thread, and loops over all 9
// neighbours itself; each output is written once, with no atomics.  It
// visits in each window only the reach of its own targets
// (column_pairs.cuh: the reach search and the per-warp culling of
// sub-tiles).
//
// K5: the TPU kernel looped over a column's active chunks with a dynamic
// trip count read from scalar memory.  Here the grid is K4's, a block per
// (column, chunk-table slot, 128 targets), and a block past the column's
// active count returns at once; the others read their chunk index from
// the table and run K4's body over every target of the chunk.  Slots of
// chunks not in the table stay 0.  What bounds it: as K4, over the active
// chunks only.

#include <cuda_runtime.h>

#include "column_pairs.cuh"

namespace {

using nbody_kernels::ColumnGeom;
using nbody_kernels::ColumnTarget;
using nbody_kernels::kColTargets;
using nbody_kernels::kColThreads;
using nbody_kernels::Params;

// Loads this thread's target of the block at `first`, runs the pair sum
// and writes the sums to rows 0-2 of `out`.
template <int SPLIT, int SOFT>
__device__ __forceinline__ void column_body(const float* __restrict__ plane,
                                            const int* __restrict__ ws,
                                            const ColumnGeom& g,
                                            const Params& p, int ic, int k,
                                            size_t first,
                                            float* __restrict__ out) {
  __shared__ nbody_kernels::ColumnShared sh;
  const size_t i = nbody_kernels::target_slot(first);
  ColumnTarget t = nbody_kernels::load_target(plane, g, i);
  nbody_kernels::column_pair_sum<SPLIT, SOFT>(plane, ws, g, ic, k, t, p, sh);
  out[i] = t.ax;
  out[g.row + i] = t.ay;
  out[2 * g.row + i] = t.az;
}

// The member blockIdx.z's plane, tables, drift and output.
struct Member {
  const float* plane;
  const int* ws;
  const int* nch;
  const int* cht;
  float* out;
};

__device__ __forceinline__ Member member_of(const float* plane,
                                            const int* ws, const int* nch,
                                            const int* cht, float* out,
                                            ColumnGeom& g) {
  using nbody_kernels::member_part;
  const size_t ncol = static_cast<size_t>(g.nx) * g.ncell;
  g.drift = member_part(g.drift, 1);
  return Member{member_part(plane, 8 * g.row),
                member_part(ws, ncol * 9 * g.maxch), member_part(nch, ncol),
                member_part(cht, ncol * g.maxch), member_part(out, 8 * g.row)};
}

template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kColThreads)
column_kernel(const float* __restrict__ plane, const int* __restrict__ ws,
              const int* __restrict__ nch, ColumnGeom g, Params p,
              float* __restrict__ out) {
  const Member m = member_of(plane, ws, nch, nullptr, out, g);
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block(g, m.nch, ic, k, first)) return;
  column_body<SPLIT, SOFT>(m.plane, m.ws, g, p, ic, k, first, m.out);
}

template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kColThreads)
column_kernel_masked(const float* __restrict__ plane,
                     const int* __restrict__ ws,
                     const int* __restrict__ nch_act,
                     const int* __restrict__ cht, ColumnGeom g, Params p,
                     float* __restrict__ out) {
  const Member m = member_of(plane, ws, nch_act, cht, out, g);
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block_masked(g, m.nch, m.cht, ic, k, first))
    return;
  column_body<SPLIT, SOFT>(m.plane, m.ws, g, p, ic, k, first, m.out);
}

// cht == nullptr launches K4, else K5 with nch the active counts.
template <int SPLIT, int SOFT>
void launch(const float* plane, const int* ws, const int* nch, const int* cht,
            int members, const ColumnGeom& g, const Params& p, float* out,
            cudaStream_t stream) {
  const dim3 grid(g.nx * g.ncell, g.maxch * (g.chunk / kColTargets),
                  members);
  if (cht == nullptr)
    column_kernel<SPLIT, SOFT><<<grid, kColThreads, 0, stream>>>(
        plane, ws, nch, g, p, out);
  else
    column_kernel_masked<SPLIT, SOFT><<<grid, kColThreads, 0, stream>>>(
        plane, ws, nch, cht, g, p, out);
}

int run(const float* plane, const int* ws, const int* nch, const int* cht,
        int members, int nx, int ncell, int stride, int W, int maxch, int gz, int chunk,
        double eps, double r_s, double r_cut, double box, const float* drift,
        int split, int softening, float* out, void* stream) {
  if (members < 1 || members > 65535 || ncell < 1 || nx < 1 || nx > ncell ||
      stride < 1 || W < 1 ||
      W > stride || maxch < 1 || gz < 0 || chunk < kColTargets ||
      chunk % kColTargets != 0 ||
      gz + maxch * chunk > stride || split < 0 || split > 1 ||
      softening < 0 || softening > 1 || !(box > 0.0) ||
      maxch * (chunk / kColTargets) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ColumnGeom g = nbody_kernels::make_geom(nx, ncell, stride, W, maxch,
                                                gz, chunk, box, r_cut, drift);
  // the column tiers bake the box into the ghost coordinates
  const Params p = nbody_kernels::make_params(1.0, eps, r_s, r_cut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 0) {
    if (softening == 0) launch<0, 0>(plane, ws, nch, cht, members, g, p, out, s);
    else                launch<0, 1>(plane, ws, nch, cht, members, g, p, out, s);
  } else {
    if (softening == 0) launch<1, 0>(plane, ws, nch, cht, members, g, p, out, s);
    else                launch<1, 1>(plane, ws, nch, cht, members, g, p, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// plane (members, 8, (nx + 2) * (ncell + 2) * stride) float32, nx interior
// x-rows (ncell for the whole box, ncell / D for a slab's plane); ws
// (members, nx * ncell * 9 * maxch) int32; nch (members, nx * ncell)
// int32; out like plane, zeroed by the caller.  One launch over the
// members (blockIdx.z), each with the blocks of its own launch, so a
// member's sums are those of its launch alone, bit for bit.
// split: 0 = Gaussian, 1 = spline.  softening: 0 = Plummer, 1 = cubic
// spline.  box: the periodic box side; drift: nullptr for a fresh plane,
// for a frozen one a float a member on the card, the largest |z drift| of the
// plane's particles since the freeze (column_pairs.cuh).  Returns
// cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int p3m_columns_f32(const float* plane, const int* ws, const int* nch,
                    int members, int nx, int ncell, int stride, int W, int maxch, int gz,
                    int chunk, double eps, double r_s, double r_cut,
                    double box, const float* drift, int split,
                    int softening, float* out, void* stream) {
  return run(plane, ws, nch, nullptr, members, nx, ncell, stride, W, maxch, gz, chunk,
             eps, r_s, r_cut, box, drift, split, softening, out, stream);
}

// K5.  As p3m_columns_f32, with nch_act (members, nx * ncell) int32 the
// active chunks of each column and cht (members, nx * ncell * maxch) int32
// their indices (the first nch_act[ic] entries of row ic).
int p3m_columns_masked_f32(const float* plane, const int* ws,
                           const int* nch_act, const int* cht, int members,
                           int nx,
                           int ncell, int stride, int W, int maxch, int gz,
                           int chunk, double eps, double r_s, double r_cut,
                           double box, const float* drift, int split,
                           int softening, float* out, void* stream) {
  return run(plane, ws, nch_act, cht, members, nx, ncell, stride, W, maxch, gz, chunk,
             eps, r_s, r_cut, box, drift, split, softening, out, stream);
}

// The column kernels' targets a block, slots between the probes of
// their reach search and whether they search (column_pairs.cuh), for the
// plain reach rule p3m_columns.column_reach.  Returns 0.
int column_pairs_info(int* targets, int* fence, int* search) {
  *targets = nbody_kernels::kColTargets;
  *fence = nbody_kernels::kColFence;
  *search = nbody_kernels::kColSearch;
  return 0;
}

}  // extern "C"
