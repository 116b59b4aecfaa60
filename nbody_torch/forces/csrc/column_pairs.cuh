// The column pair sum shared by K3 (pm_supercell.cu), K4 and K5
// (p3m_columns.cu): the plane layout, the block-to-targets maps and the
// loop over a target chunk's 9 neighbour z-windows.
//
// Plane: (8, P2 * stride) float32 row-major, rows x, y, z, m (rows 4-7
// unused on input), P2 = (nx + 2) * (ncell + 2) padded columns of `stride`
// slots: nx interior x-rows (ncell for the whole box, ncell / D for a
// slab's plane, whose two ghost x-rows are its neighbours' edge rows);
// padded column (px, py) starts at slot (px * P + py) * stride, P =
// ncell + 2.  Interior column ic = cx * ncell + cy (cx < nx) is padded
// column (cx + 1, cy + 1).  Its chunk k holds the target slots
// [gz + k * chunk, gz + (k + 1) * chunk) and interacts with window
// [ws, ws + W) of each neighbour (cx + o2 / 3, cy + o2 % 3), o2 = 0..8,
// ws = ws_tab[(ic * 9 + o2) * maxch + k].  Ghost columns and ghost slots
// carry +-box in their coordinates, so there is no minimum image.

#pragma once

#include <cuda_runtime.h>

#include "short_weight.cuh"

namespace nbody_kernels {

// Targets per block == sources per shared-memory tile.  A chunk of 256
// targets is two blocks, so a uniform 64^3-particle state gives ~2,500
// blocks of 4 warps for 132 SMs.
constexpr int kColThreads = 128;

struct ColumnGeom {
  int nx;      // interior x-rows of the plane (ncell, or a slab's share)
  int ncell;   // interior columns per y side
  int stride;  // slots per padded column
  int W;       // window width (slots), <= stride, multiple of 128
  int maxch;   // chunk slots per column in the window table
  int gz;      // z-ghost slots at each column end
  int chunk;   // targets per chunk (a multiple of kColThreads)
  size_t row;  // elements per plane row: (nx + 2) * (ncell + 2) * stride
};

// The first target slot of this block's share of chunk k of interior
// column ic (a chunk is g.chunk / kColThreads blocks along blockIdx.y).
__device__ __forceinline__ size_t chunk_first(const ColumnGeom& g, int ic,
                                              int k) {
  const int P = g.ncell + 2;
  const int tcol = (ic / g.ncell + 1) * P + (ic % g.ncell + 1);
  return static_cast<size_t>(tcol) * g.stride + g.gz +
         static_cast<size_t>(k) * g.chunk +
         static_cast<size_t>(blockIdx.y % (g.chunk / kColThreads)) *
             kColThreads;
}

// Where this block's targets are: interior column `ic`, chunk `k` and the
// first target slot; false when the chunk is empty (the whole block
// returns before any barrier).
__device__ __forceinline__ bool column_block(const ColumnGeom& g,
                                             const int* __restrict__ nch,
                                             int& ic, int& k, size_t& first) {
  ic = blockIdx.x;
  k = blockIdx.y / (g.chunk / kColThreads);
  if (k >= nch[ic]) return false;
  first = chunk_first(g, ic, k);
  return true;
}

// The same for the masked form: blockIdx.y / (chunk / kColThreads) is a
// slot of column ic's chunk table `cht` (ncol * maxch), of which the
// first nch_act[ic] hold the indices of the active chunks.
__device__ __forceinline__ bool column_block_masked(
    const ColumnGeom& g, const int* __restrict__ nch_act,
    const int* __restrict__ cht, int& ic, int& k, size_t& first) {
  ic = blockIdx.x;
  const int slot = blockIdx.y / (g.chunk / kColThreads);
  if (slot >= nch_act[ic]) return false;
  k = cht[static_cast<size_t>(ic) * g.maxch + slot];
  first = chunk_first(g, ic, k);
  return true;
}

// Adds to (ax, ay, az) the short-range sum of target (xi, yi, zi) over
// the 9 windows of chunk k of column ic.  Every thread of the block calls
// it (barriers inside); `tile` is kColThreads float4 of shared memory.
template <int SPLIT, int SOFT>
__device__ __forceinline__ void column_pair_sum(
    const float* __restrict__ plane, const int* __restrict__ ws,
    const ColumnGeom& g, int ic, int k, float xi, float yi, float zi,
    const Params& p, float4* tile, float& ax, float& ay, float& az) {
  const int P = g.ncell + 2;
  const int cx = ic / g.ncell;
  const int cy = ic % g.ncell;
  for (int o2 = 0; o2 < 9; ++o2) {
    const int jcol = (cx + o2 / 3) * P + (cy + o2 % 3);
    const int start =
        ws[(static_cast<size_t>(ic) * 9 + o2) * g.maxch + k];
    const size_t base = static_cast<size_t>(jcol) * g.stride + start;
    for (int j0 = 0; j0 < g.W; j0 += kColThreads) {
      const int nt = min(kColThreads, g.W - j0);
      if (static_cast<int>(threadIdx.x) < nt) {
        const size_t j = base + j0 + threadIdx.x;
        tile[threadIdx.x] = make_float4(plane[j], plane[g.row + j],
                                        plane[2 * g.row + j],
                                        plane[3 * g.row + j]);
      }
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        const float4 s = tile[t];
        const float dx = s.x - xi;
        const float dy = s.y - yi;
        const float dz = s.z - zi;
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
  }
}

}  // namespace nbody_kernels
