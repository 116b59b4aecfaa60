// K6: the ghost-padded cell-plane short-range P3M pair sum, float32, for
// sm_90a, in its one-plane form (the 'cells' tier) and its two-plane form
// (the rung tier's interior ticks: a compact plane of the active targets
// against the full source plane).
//
// Replaces the Pallas kernel `_cell_kernel` that
// nbody/forces/p3m.py:run_cell_plane launches, on the whole box's plane
// and on a slab's (nx = ncell / D): the domain decomposition's short
// force (nbody/distributed/domain.py:904), in the two-plane form its rung
// tier's interior ticks (domain.py:941), and the replicated-grid P3M's
// x-slab of the whole plane (nbody/distributed/sharding.py:388).
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
// rows 0-2 of the output plane at t.  The kernel writes every other slot
// and row of the output as 0 (the ghost cells, the slots past a cell's
// count, rows 3-7), so the caller allocates it uninitialised.
//
// What bounds it: the visits and the weight.  A cell holds ~25-64 stored
// particles at the production densities, so a target meets ~700-1,700
// stored sources, 5-14% of them inside r_cut; a warp of one cell's
// targets steps through every source of the 27 cells and runs the weight
// where any of its lanes is inside.  The planes (a few MB) are read from
// L2.
//
// What the design does about it (the design before this one is
// scripts/torch_k6_original.cu: a 64-thread block a cell, 2 warps an SM
// at the slab site, half its lanes idle at 25-33 targets a cell, one
// synchronous tile load and two __syncthreads per neighbour cell):
// * One block of W warps a real target cell, W from the wrapper
//   (k6_geometry in nbody_torch/forces/p3m.py: the most warps whose
//   blocks make at most K6_WAVES waves of the card's resident blocks, from
//   the SM count and the resident blocks p3m_cells_info reports).  The
//   cell's 27 neighbour cells' stored sources are cut into tiles of up to
//   kTile of one cell, tile q going to share q mod S; a warp sums one
//   share, and the shares' sums are added in share order in shared
//   memory.  No atomics: two launches give the same bits.
// * Live lanes.  A cell of c <= 32 targets gives each target L = 32 / c
//   lanes, which take the sources l, l + L, ... of each tile and are added
//   in lane order with shuffles, so one active target of the rung tier's
//   compact plane keeps a whole warp busy.  A cell of more targets is cut
//   into G groups of 32, one target a lane, and the W warps into
//   S = W / G shares of each group's neighbourhood.
// * Staging with asynchronous copies: each warp stages its tiles into two
//   buffers of its own with cp.async (4 bytes a row, from the SoA plane
//   into float4 slots), the next tile in flight while the current one is
//   summed; no block barrier until the shares are added.
// * The weight under the r^2 < r_cut^2 branch, with the one-instruction
//   rsqrt, rcp and exp of short_weight.cuh (APPROX).
// * The zeros: a block writes its target cell's K slots (rows 0-2) and a
//   share of the ghost cells and of rows 3-7, so no zero-fill runs before
//   the kernel.
// The designs that measured slower (other W, synchronous staging, one
// target a lane at every count, the IEEE weight, the weight deferred to a
// second pass over the marked pairs, 42 registers, K1's Newton form, a
// tile cull on sources sorted in their cells) are patches of this file in
// scripts/torch_k6_ablation.py, with their times in PERF.md.

#include <cuda_runtime.h>

#include <climits>

#include "short_weight.cuh"

namespace {

using nbody_kernels::Params;

constexpr int kTile = 32;       // sources a warp stages at a time
constexpr int kMaxWarps = 16;   // warps a block, at most
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block of W warps: each warp's two source
// buffers, then the shares' partial sums (W x 32 targets x 3 floats).
__host__ __device__ constexpr size_t smem_bytes(int warps) {
  return static_cast<size_t>(warps) * (2 * kTile * sizeof(float4) +
                                       3 * 32 * sizeof(float));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the tile in flight) is pending
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage tile q of the neighbourhood into buf: lane j copies source j of
// the tile's cell run (x, y, z, m from the SoA rows into one float4).
// Lane o < 27 holds neighbour cell o's first slot, its count, the tiles of
// cells 0..o (`tend`) and of cells 0..o-1 (`tbeg`).  Returns the tile's
// source count.
__device__ __forceinline__ int stage_tile(float4* buf, int q,
                                          const float* __restrict__ plane_j,
                                          size_t row_j, long long base,
                                          int cnt, int tbeg, int tend,
                                          int lane) {
  const int o = __popc(__ballot_sync(kFull, tend <= q));
  const long long b = __shfl_sync(kFull, base, o);
  const int c = __shfl_sync(kFull, cnt, o);
  const int first = (q - __shfl_sync(kFull, tbeg, o)) * kTile;
  const int n = min(kTile, c - first);
  if (lane < n) {
    const float* src = plane_j + b + first + lane;
    float* dst = reinterpret_cast<float*>(buf + lane);
    cp_async4(dst + 0, src);
    cp_async4(dst + 1, src + row_j);
    cp_async4(dst + 2, src + 2 * row_j);
    cp_async4(dst + 3, src + 3 * row_j);
  }
  return n;
}

// 1 where the source lies inside r_cut of the target (x, y, z): r^2 < rc2,
// rc2 = r_cut^2, or 0 where r_cut^2 <= 1e-30 (the JAX kernel's mask
// max(r^2, 1e-30) < r_cut^2 then holds for no pair; else for the same
// pairs)
__device__ __forceinline__ unsigned inside(const float4 v, float x, float y,
                                           float z, float rc2) {
  const float dx = v.x - x;
  const float dy = v.y - y;
  const float dz = v.z - z;
  return dx * dx + dy * dy + dz * dz < rc2;
}

// the pair's term m w(r^2) d, added to the target's sum
template <int SPLIT, int SOFT>
__device__ __forceinline__ void add_pair(const float4 v, float x, float y,
                                         float z, float& ax, float& ay,
                                         float& az, const Params& p) {
  const float dx = v.x - x;
  const float dy = v.y - y;
  const float dz = v.z - z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float w = v.w * nbody_kernels::short_weight<SPLIT, SOFT, true>(r2, p);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
}

// Block b: real cell b (x-major, z fastest) of the target plane, W warps;
// blockIdx.y the member of a batched launch (its planes, counts and output
// follow the previous member's).
template <int SPLIT, int SOFT>
__global__ void __launch_bounds__(32 * kMaxWarps)
cell_kernel(const float* __restrict__ plane, const float* __restrict__ plane_j,
            const int* __restrict__ counts, const int* __restrict__ counts_j,
            int nx, int ncell, int K, int K_j, size_t row, size_t row_j,
            Params p, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float4* buf = smem + warp * 2 * kTile;
  float* red = reinterpret_cast<float*>(smem + W * 2 * kTile);
  const int M = ncell + 2;
  const int ncells = (nx + 2) * M * M;
  {
    const size_t b = blockIdx.y;
    plane += b * 8 * row;
    plane_j += b * 8 * row_j;
    counts += b * ncells;
    counts_j += b * ncells;
    out += b * 8 * row;
  }
  const float rc2 = p.r_cut2 > 1e-30f ? p.r_cut2 : 0.0f;

  // the zeros this block owns beyond its target cell: a share of rows
  // 3-7 (float4 stores; row is a multiple of 4) and of the ghost cells
  {
    const size_t n4 = 5 * row / 4;
    const size_t per = (n4 + gridDim.x - 1) / gridDim.x;
    const size_t end = min(n4, (blockIdx.x + 1) * per);
    float4* z4 = reinterpret_cast<float4*>(out + 3 * row);
    for (size_t k = blockIdx.x * per + tid; k < end; k += blockDim.x)
      z4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int pc = blockIdx.x; pc < ncells; pc += gridDim.x) {
      const int qx = pc / (M * M), qy = (pc / M) % M, qz = pc % M;
      if (qx > 0 && qx <= nx && qy > 0 && qy <= ncell && qz > 0 &&
          qz <= ncell)
        continue;
      for (int i = tid; i < 3 * K; i += blockDim.x)
        out[(i / K) * row + static_cast<size_t>(pc) * K + i % K] = 0.0f;
    }
  }

  const int r = blockIdx.x;
  const int px = r / (ncell * ncell) + 1;
  const int py = (r / ncell) % ncell + 1;
  const int pz = r % ncell + 1;
  const int tcell = (px * M + py) * M + pz;
  const int c = counts[tcell];

  // this warp's table of the 27 neighbour cells, a lane each
  long long base = 0;
  int cnt = 0, tend = INT_MAX, tbeg = 0;
  {
    int tiles = 0;
    if (lane < 27) {
      const int scell = ((px + lane / 9 - 1) * M + (py + (lane / 3) % 3 - 1)) *
                            M + pz + lane % 3 - 1;
      cnt = counts_j[scell];
      base = static_cast<long long>(scell) * K_j;
      tiles = (cnt + kTile - 1) / kTile;
    }
    int incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    tbeg = incl - tiles;
    if (lane < 27) tend = incl;
  }
  const int Q = __shfl_sync(kFull, tend, 26);

  // the work: c <= 32 targets, L lanes each, W shares; or G groups of 32
  // targets, one a lane, S = W / G shares each
  const bool few = c <= 32;
  const int L = few ? (c > 0 ? 32 / c : 32) : 1;
  const int G = few ? 1 : (c + 31) / 32;
  const int S = few ? W : max(1, W / G);
  const int t = few ? lane / L : 0;
  const int l = few ? lane % L : 0;

  for (int item = warp; item < G * S && c > 0; item += W) {
    const int g = item % G;
    const int s = item / G;
    const int ti = few ? t : g * 32 + lane;  // target index in the cell
    const bool live = ti < c;
    const size_t i = static_cast<size_t>(tcell) * K + (live ? ti : 0);
    const float xi = plane[i];
    const float yi = plane[row + i];
    const float zi = plane[2 * row + i];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;

    int cur = 0;
    int n = s < Q ? stage_tile(buf, s, plane_j, row_j, base, cnt, tbeg, tend,
                               lane)
                  : 0;
    cp_async_commit();
    for (int q = s; q < Q; q += S) {
      const int qn = q + S;
      const int nn = qn < Q ? stage_tile(buf + (cur ^ 1) * kTile, qn,
                                         plane_j, row_j, base, cnt, tbeg,
                                         tend, lane)
                            : 0;
      cp_async_commit();
      cp_async_wait_prev();
      __syncwarp();
      const float4* tile = buf + cur * kTile;
      if (L == 1) {
#pragma unroll 4
        for (int k = 0; k < n; ++k)
          if (inside(tile[k], xi, yi, zi, rc2))
            add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      } else {
        for (int k = l; k < n; k += L)
          if (inside(tile[k], xi, yi, zi, rc2))
            add_pair<SPLIT, SOFT>(tile[k], xi, yi, zi, ax, ay, az, p);
      }
      __syncwarp();  // the buffer is refilled two tiles on
      cur ^= 1;
      n = nn;
    }
    // a target's L lanes, added in lane order into its first
    if (L > 1) {
      const int first = lane - l;
      float sx = ax, sy = ay, sz = az;
      for (int j = 1; j < L; ++j) {
        const float vx = __shfl_sync(kFull, ax, first + j);
        const float vy = __shfl_sync(kFull, ay, first + j);
        const float vz = __shfl_sync(kFull, az, first + j);
        sx += vx, sy += vy, sz += vz;
      }
      ax = sx, ay = sy, az = sz;
    }
    if (live && l == 0) {
      if (S == 1) {
        out[i] = ax;
        out[row + i] = ay;
        out[2 * row + i] = az;
      } else {
        float* rr = red + 3 * ((s * G + g) * 32 + (few ? t : lane));
        rr[0] = ax;
        rr[1] = ay;
        rr[2] = az;
      }
    }
  }
  __syncthreads();
  // the cell's K slots: the shares' sums added in share order, else 0
  for (int k = tid; k < K; k += blockDim.x) {
    if (k < c && S == 1) continue;  // written by its warp
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (k < c) {
      for (int s = 0; s < S; ++s) {
        const float* rr = red + 3 * (s * G * 32 + k);
        sx += rr[0];
        sy += rr[1];
        sz += rr[2];
      }
    }
    const size_t i = static_cast<size_t>(tcell) * K + k;
    out[i] = sx;
    out[row + i] = sy;
    out[2 * row + i] = sz;
  }
}

const void* kernel_of(int split, int softening) {
  return split == 0
             ? (softening == 0 ? reinterpret_cast<const void*>(cell_kernel<0, 0>)
                               : reinterpret_cast<const void*>(cell_kernel<0, 1>))
             : (softening == 0
                    ? reinterpret_cast<const void*>(cell_kernel<1, 0>)
                    : reinterpret_cast<const void*>(cell_kernel<1, 1>));
}

template <int SPLIT, int SOFT>
cudaError_t launch(const float* plane, const float* plane_j,
                   const int* counts, const int* counts_j, int members,
                   int nx, int ncell, int K, int K_j, size_t row,
                   size_t row_j, const Params& p, int warps, float* out,
                   cudaStream_t stream) {
  // at most 22.5 KB: under the 48 KB a launch takes without an opt-in
  cell_kernel<SPLIT, SOFT><<<dim3(nx * ncell * ncell, members), 32 * warps,
                             smem_bytes(warps), stream>>>(
      plane, plane_j, counts, counts_j, nx, ncell, K, K_j, row, row_j, p, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// plane (members, 8, (nx + 2) * (ncell + 2)^2 * K) float32 and counts
// (members, (nx + 2) * (ncell + 2)^2) int32 (<= K); plane_j / counts_j the
// source planes of the same cell geometry with bucket width K_j (plane and
// counts again for the one-plane form); out like plane, written whole (no
// zero-fill needed).  One launch over the members, each with the blocks
// of its own launch (its bits those of its launch alone).  split: 0 = Gaussian, 1 = spline.  softening: 0 =
// Plummer, 1 = cubic spline.  warps: W, 1, 2, 4, 8 or 16 (the wrapper's
// launch shape).  Returns cudaGetLastError() after the launch (0 on
// success); 1 (cudaErrorInvalidValue) for arguments the kernel does not
// take.
int p3m_cells_f32(const float* plane, const float* plane_j, const int* counts,
                  const int* counts_j, int members, int nx, int ncell,
                  int K, int K_j,
                  double eps, double r_s, double r_cut, int split,
                  int softening, int warps, float* out, void* stream) {
  if (members < 1 || members > 65535 || nx < 1 || ncell < 1 || K < 1 || K % 4 != 0 || K_j < 1 || split < 0 ||
      split > 1 || softening < 0 || softening > 1 || warps < 1 ||
      warps > kMaxWarps || (warps & (warps - 1)) != 0 ||
      static_cast<long long>(nx) * ncell * ncell > INT_MAX ||
      static_cast<long long>(nx + 2) * (ncell + 2) * (ncell + 2) *
              (K > K_j ? K : K_j) >= (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t cells = static_cast<size_t>(nx + 2) * (ncell + 2) * (ncell + 2);
  const size_t row = cells * K;
  const size_t row_j = cells * K_j;
  // the cell tier bakes the box into the ghost coordinates
  const Params p = nbody_kernels::make_params(1.0, eps, r_s, r_cut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = split == 0
                       ? (softening == 0 ? &launch<0, 0> : &launch<0, 1>)
                       : (softening == 0 ? &launch<1, 0> : &launch<1, 1>);
  return static_cast<int>(run(plane, plane_j, counts, counts_j, members, nx,
                              ncell, K, K_j, row, row_j, p, warps, out, s));
}

// The launch shapes of the current device's kernel for one split and
// softening: out = [sources a tile, SM count, resident blocks an SM at W =
// 1, 2, 4, 8 and 16 warps a block].  Returns a CUDA error code (0 on
// success).
int p3m_cells_info(int split, int softening, int* out) {
  if (split < 0 || split > 1 || softening < 0 || softening > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = kTile;
  out[1] = sms;
  const void* fn = kernel_of(split, softening);
  for (int k = 0, w = 1; w <= kMaxWarps; ++k, w *= 2) {
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * w,
                                                          smem_bytes(w));
    out[2 + k] = blocks;
  }
  return static_cast<int>(err);
}

}  // extern "C"
