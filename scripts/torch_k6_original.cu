// K6: the ghost-padded cell-plane short-range P3M pair sum, float32, for
// sm_90a, in its one-plane form (the 'cells' tier) and its two-plane form
// (the rung tier's interior ticks: a compact plane of the active targets
// against the full source plane).
//
// Replaces the Pallas kernel `_cell_kernel` that
// nbody/forces/p3m.py:run_cell_plane launches, on the whole box's plane
// and on a slab's (nx = ncell / D): the domain decomposition's short
// force (nbody/distributed/domain.py:904) and, in the two-plane form,
// its rung tier's interior ticks (domain.py:941).
//
// Plane: (8, (nx + 2) * M * M * K) float32 row-major, rows x, y, z, m
// (rows 4-7 unused on input), M = ncell + 2 padded cells per y and z side
// (nx + 2 in x); padded cell (px, py, pz) holds the slots
// [((px * M + py) * M + pz) * K, + K): its stored particles first, then
// sentinels.  Ghost cells carry +-box in their coordinates, so there is no
// minimum image.  `counts` holds each padded cell's stored particles.
//
// What it computes: for every stored target slot t of every real cell
// (px in 1..nx, py and pz in 1..ncell), the sum over the stored sources s
// of the 27 neighbour cells of the source plane of m_s * w(r_ts^2) *
// (x_s - x_t), w the cutoff-masked weight of short_weight.cuh; written to
// rows 0-2 of the output plane at t.  The wrapper zeroes the output, so
// every other slot and row is 0.
//
// What bounds it: the pair visits.  At the default 32^3 run (ncell 11,
// ~25 particles a cell) a target meets ~660 stored sources, so a full
// plane is ~2.2e7 visits; the rung tier's interior ticks touch only the
// cells that hold an active target.  The planes (8 MB at K = 128) are read
// from L2.
//
// What the design does about it: the TPU kernel walked the 9 (ox, oy)
// neighbour columns as a sequential grid axis, accumulating a whole
// z-column of target cells in VMEM, and swept every one of the K x 3K_j
// slots, sentinels included.  Blocks on the card run in no order, so here
// one block owns one target cell and loops over its 27 neighbour cells
// itself; each output is written once, with no atomics.  Loops stop at the
// cells' stored counts, so sentinel slots cost nothing, and a block whose
// cell holds no target (every block of an interior tick with no active
// particle nearby) returns at once.  Sources stream through shared memory
// in float4 tiles, as in K1 and K4.

#include <cuda_runtime.h>

#include "short_weight.cuh"

namespace {

using nbody_kernels::Params;

// Threads per block, and sources per shared-memory tile.  A cell holds
// ~25 particles at the production densities: a 64-thread block keeps most
// lanes busy, and a cell with more targets loops over them in groups.
constexpr int kCellThreads = 64;

template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(kCellThreads)
cell_kernel(const float* __restrict__ plane, const float* __restrict__ plane_j,
            const int* __restrict__ counts, const int* __restrict__ counts_j,
            int ncell, int K, int K_j, size_t row, size_t row_j, Params p,
            float* __restrict__ out) {
  __shared__ float4 tile[kCellThreads];
  const int M = ncell + 2;
  const int c2 = blockIdx.x;  // target z-column: px - 1 = c2 / ncell
  const int px = c2 / ncell + 1;
  const int py = c2 % ncell + 1;
  const int pz = blockIdx.y + 1;
  const int tcell = (px * M + py) * M + pz;
  const int ci = counts[tcell];
  for (int t0 = 0; t0 < ci; t0 += kCellThreads) {
    const int t = t0 + threadIdx.x;
    const bool live = t < ci;
    const size_t i = static_cast<size_t>(tcell) * K + (live ? t : 0);
    const float xi = plane[i];
    const float yi = plane[row + i];
    const float zi = plane[2 * row + i];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int o = 0; o < 27; ++o) {
      const int scell =
          ((px + o / 9 - 1) * M + (py + (o / 3) % 3 - 1)) * M + pz + o % 3 - 1;
      const int cj = counts_j[scell];
      const size_t base = static_cast<size_t>(scell) * K_j;
      for (int j0 = 0; j0 < cj; j0 += kCellThreads) {
        const int nt = min(kCellThreads, cj - j0);
        if (static_cast<int>(threadIdx.x) < nt) {
          const size_t j = base + j0 + threadIdx.x;
          tile[threadIdx.x] = make_float4(plane_j[j], plane_j[row_j + j],
                                          plane_j[2 * row_j + j],
                                          plane_j[3 * row_j + j]);
        }
        __syncthreads();
        if (live) {
#pragma unroll 4
          for (int s = 0; s < nt; ++s) {
            const float4 src = tile[s];
            const float dx = src.x - xi;
            const float dy = src.y - yi;
            const float dz = src.z - zi;
            const float r2 = dx * dx + dy * dy + dz * dz;
            if (fmaxf(r2, 1e-30f) < p.r_cut2) {
              const float w =
                  src.w * nbody_kernels::short_weight<SPLIT, SOFT>(r2, p);
              ax += w * dx;
              ay += w * dy;
              az += w * dz;
            }
          }
        }
        __syncthreads();
      }
    }
    if (live) {
      out[i] = ax;
      out[row + i] = ay;
      out[2 * row + i] = az;
    }
  }
}

template <int SPLIT, int SOFT>
void launch(const float* plane, const float* plane_j, const int* counts,
            const int* counts_j, int nx, int ncell, int K, int K_j,
            size_t row, size_t row_j, const Params& p, float* out,
            cudaStream_t stream) {
  const dim3 grid(nx * ncell, ncell);
  cell_kernel<SPLIT, SOFT><<<grid, kCellThreads, 0, stream>>>(
      plane, plane_j, counts, counts_j, ncell, K, K_j, row, row_j, p, out);
}

}  // namespace

extern "C" {

// plane (8, (nx + 2) * (ncell + 2)^2 * K) float32 and counts
// ((nx + 2) * (ncell + 2)^2,) int32 (<= K); plane_j / counts_j the source
// plane of the same cell geometry with bucket width K_j (plane and counts
// again for the one-plane form); out like plane, zeroed by the caller.
// split: 0 = Gaussian, 1 = spline.  softening: 0 = Plummer, 1 = cubic
// spline.  Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int p3m_cells_f32(const float* plane, const float* plane_j, const int* counts,
                  const int* counts_j, int nx, int ncell, int K, int K_j,
                  double eps, double r_s, double r_cut, int split,
                  int softening, float* out, void* stream) {
  if (nx < 1 || ncell < 1 || ncell > 65535 || K < 1 || K_j < 1 ||
      split < 0 || split > 1 || softening < 0 || softening > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t cells = static_cast<size_t>(nx + 2) * (ncell + 2) * (ncell + 2);
  const size_t row = cells * K;
  const size_t row_j = cells * K_j;
  // the cell tier bakes the box into the ghost coordinates
  const Params p = nbody_kernels::make_params(1.0, eps, r_s, r_cut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 0) {
    if (softening == 0)
      launch<0, 0>(plane, plane_j, counts, counts_j, nx, ncell, K, K_j, row,
                   row_j, p, out, s);
    else
      launch<0, 1>(plane, plane_j, counts, counts_j, nx, ncell, K, K_j, row,
                   row_j, p, out, s);
  } else {
    if (softening == 0)
      launch<1, 0>(plane, plane_j, counts, counts_j, nx, ncell, K, K_j, row,
                   row_j, p, out, s);
    else
      launch<1, 1>(plane, plane_j, counts, counts_j, nx, ncell, K, K_j, row,
                   row_j, p, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
