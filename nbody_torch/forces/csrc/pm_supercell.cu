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
// into the mesh with global atomics: the adds bound it (2.1 M at cfg64).
// The sums are exact, so two launches give the same bits: each corner
// mass (float32, as the plain version rounds it) is scaled by a power of
// two 2^e and rounded to a 64-bit integer, and the integers are summed
// with integer atomics, which no order of arrival can change.  A first
// pass finds the largest |mass| of the real slots (a block's maximum,
// then one atomicMax of its float bits) and counts the real slots (one
// atomicAdd a column), and e is chosen so that the real slots' masses,
// summed, stay below 2^62: no node can overflow.  A weight rounds to a
// multiple of 2^-e, so e must not depend on the plane's capacity: the
// count of real slots is the plane's particles whatever the capacity
// CK, where the slot count nx * ncell * CK (the bound before) moved e,
// and with it the rounding of every small corner weight, when a heal or
// a learned capacity changed CK (two runs of one config then parted).
// A last pass writes the float32 node masses, each the exact sum
// rounded once.  The integer mesh (8 bytes a node), the maximum and the
// count are zeroed by a memset in the same library call.
//
// B members of the batched tier run in one launch of each pass
// (blockIdx.z the member): each member has its own integer mesh, its own
// maximum and count and so its own e, and its bits are those of its own
// launch.  64-bit atomics have no
// vector form: 8 atomics a slot, where the float design before it
// (scripts/torch_k2_float4.cu) sent each node line's z pair as one
// float4 atomic, 5 a slot, and its sums changed with the order of
// arrival.  A shared-memory tile a column and z range (the TPU kernel's
// node subgrid), with its ring added by a second kernel, ran slower
// (scripts/torch_k2_tile.cu, scripts/torch_k2_ablation.py).
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

#include <algorithm>

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

// A member's largest |mass| (the bits of a non-negative float, which
// order as the floats do) and its count of real slots: one 64-bit word.
struct MassStats {
  unsigned mbits;
  unsigned count;
};

// The exponent e of the fixed point: the real slots' masses, each below
// 2^k (k from the largest), summed over `count` < 2^j slots, stay below
// 2^62 when scaled by 2^e.
__device__ __forceinline__ int fixed_exponent(const MassStats* st) {
  const float mmax = __uint_as_float(st->mbits);
  if (!(mmax > 0.0f)) return 0;
  int k;
  frexpf(mmax, &k);
  const int j = 32 - __clz(st->count);
  return 62 - k - j;
}

// Pass 1: the largest |mass| of the real slots and their count.
__global__ void __launch_bounds__(kDepositThreads)
deposit_max_kernel(const float* __restrict__ plane,
                   const int* __restrict__ counts, int ncell, int stride,
                   int gz, size_t row, MassStats* __restrict__ stats) {
  __shared__ unsigned warp_max[kDepositThreads / 32];
  plane = nbody_kernels::member_part(plane, 8 * row);
  counts = nbody_kernels::member_part(counts, static_cast<size_t>(gridDim.x));
  MassStats* st = stats + blockIdx.z;
  const int ic = blockIdx.x;
  const int r = blockIdx.y * kDepositThreads + threadIdx.x;
  if (blockIdx.y == 0 && threadIdx.x == 0 && counts[ic] > 0)
    atomicAdd(&st->count, static_cast<unsigned>(counts[ic]));
  unsigned v = 0u;
  if (r < counts[ic]) {
    const int P = ncell + 2;
    const size_t i = static_cast<size_t>((ic / ncell + 1) * P +
                                         (ic % ncell + 1)) * stride + gz + r;
    v = __float_as_uint(fabsf(plane[3 * row + i]));
  }
  v = __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kDepositThreads / 32 ? warp_max[threadIdx.x] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0 && v != 0u) atomicMax(&st->mbits, v);
  }
}

// Adds the weight w, scaled by 2^e and rounded, to a node's integer sum.
__device__ __forceinline__ void add_fixed(unsigned long long* node, float w,
                                          int e) {
  const long long q = __float2ll_rn(ldexpf(w, e));
  if (q != 0) atomicAdd(node, static_cast<unsigned long long>(q));
}

// Pass 2: a thread a real slot, its 8 corners into the integer mesh.
__global__ void __launch_bounds__(kDepositThreads)
deposit_kernel(const float* __restrict__ plane, const int* __restrict__ counts,
               int ncell, int S, int nmesh, int nxg, int slab, int row0,
               int stride, int gz, size_t row, float scale, float shift,
               const MassStats* __restrict__ stats, size_t nodes,
               unsigned long long* __restrict__ sums) {
  using nbody_kernels::member_part;
  plane = member_part(plane, 8 * row);
  counts = member_part(counts, static_cast<size_t>(gridDim.x));
  sums = member_part(sums, nodes);
  const int ic = blockIdx.x;
  const int r = blockIdx.y * kDepositThreads + threadIdx.x;
  if (r >= counts[ic]) return;
  const int e = fixed_exponent(stats + blockIdx.z);
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
  const int z0 = wrap(iz, nmesh), z1 = wrap(iz + 1, nmesh);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int px = x_plane(ix + a, nmesh, nxg, slab);
    if (px < 0) continue;
    const size_t gx = static_cast<size_t>(px) * nmesh;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wxy = wx[a] * wy[b] * m;
      unsigned long long* line = sums + (gx + wrap(iy + b, nmesh)) * nmesh;
      add_fixed(line + z0, wxy * (1.0f - fz), e);
      add_fixed(line + z1, wxy * fz, e);
    }
  }
}

// Pass 3: the float32 node masses, each integer sum rounded once.
__global__ void deposit_float_kernel(const unsigned long long* __restrict__ sums,
                                     size_t nodes,
                                     const MassStats* __restrict__ stats,
                                     float* __restrict__ rho) {
  sums = nbody_kernels::member_part(sums, nodes);
  rho = nbody_kernels::member_part(rho, nodes);
  const int e = fixed_exponent(stats + blockIdx.z);
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < nodes; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    rho[k] = ldexpf(__ll2float_rn(static_cast<long long>(sums[k])), -e);
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
  using nbody_kernels::member_part;
  const size_t ncol = static_cast<size_t>(g.nx) * g.ncell;
  const size_t n3 = static_cast<size_t>(nxg) * nmesh * nmesh;
  plane = member_part(plane, 8 * g.row);
  ws = member_part(ws, ncol * 9 * g.maxch);
  nch = member_part(nch, ncol);
  grids = member_part(grids, (INTERLACED ? 6 : 3) * n3);
  out = member_part(out, 8 * g.row);
  g.drift = member_part(g.drift, 1);
  int ic, k;
  size_t first;
  if (!nbody_kernels::column_block(g, nch, ic, k, first)) return;
  const int x0 = (ic / g.ncell) * S;
  const int y0 = (ic % g.ncell) * S;
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
                  const float* grids, int members, int nmesh, int nxg,
                  int slab, int row0, int S, float scale, const ColumnGeom& g,
                  const Params& p, float* out, cudaStream_t stream) {
  const dim3 grid(g.nx * g.ncell, g.maxch * (g.chunk / kColTargets),
                  members);
  fused_kernel<SPLIT, SOFT, INTERLACED, SPLIT_OUT>
      <<<grid, kColThreads, 0, stream>>>(plane, ws, nch, grids, nmesh, nxg,
                                         slab, row0, S, scale, g, p, out);
}

template <int SPLIT, int SOFT>
void dispatch_fused(bool interlaced, bool split_out, const float* plane,
                    const int* ws, const int* nch, const float* grids,
                    int members, int nmesh, int nxg, int slab, int row0,
                    int S, float scale, const ColumnGeom& g, const Params& p,
                    float* out, cudaStream_t s) {
  const auto run =
      interlaced ? (split_out ? &launch_fused<SPLIT, SOFT, true, true>
                              : &launch_fused<SPLIT, SOFT, true, false>)
                 : (split_out ? &launch_fused<SPLIT, SOFT, false, true>
                              : &launch_fused<SPLIT, SOFT, false, false>);
  run(plane, ws, nch, grids, members, nmesh, nxg, slab, row0, S, scale, g, p,
      out, s);
}

}  // namespace

extern "C" {

// K2.  plane (members, 8, (nx + 2) * (ncell + 2) * stride) float32; counts
// (members, nx * ncell) int32 (real slots per column, <= CK); rho receives
// each member's masses: (nmesh^3,) with nx = ncell and slab = 0, or on a
// slab (slab = 1, nx = ncell / D, its first x-row row0 of the box's grid)
// the haloed (nx * S + 3, nmesh, nmesh).  scratch: members * (nodes + 1)
// 64-bit words from the caller, nodes = the size of a member's rho (the
// integer sums, then a word a member for its largest mass and its count
// of real slots), zeroed here first, on `stream`.  Returns
// cudaGetLastError() after the launches (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
int pm_supercell_deposit_f32(const float* plane, const int* counts,
                             int members, int nx, int ncell, int slab,
                             int row0, int S, int nmesh, int stride, int gz,
                             int CK, double scale, double shift, float* rho,
                             void* scratch, void* stream) {
  if (members < 1 || members > 65535 || ncell < 1 || nx < 1 || nx > ncell ||
      (slab == 0 && nx != ncell) ||
      slab < 0 || slab > 1 || row0 < 0 || row0 + nx > ncell ||
      (slab == 0 && row0 != 0) || S < 1 || nmesh != ncell * S ||
      stride < 1 || gz < 0 || CK < 1 || gz + CK > stride ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t row = static_cast<size_t>(nx + 2) * (ncell + 2) * stride;
  const int nxg = slab ? nx * S + 3 : nmesh;
  const size_t nodes = static_cast<size_t>(nxg) * nmesh * nmesh;
  auto* sums = static_cast<unsigned long long*>(scratch);
  auto* stats = reinterpret_cast<MassStats*>(sums + members * nodes);
  static_assert(sizeof(MassStats) == sizeof(*sums), "a word a member");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaMemsetAsync(sums, 0, members * (nodes + 1) * sizeof(*sums), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nx * ncell, (CK + kDepositThreads - 1) / kDepositThreads,
                  members);
  deposit_max_kernel<<<grid, kDepositThreads, 0, s>>>(plane, counts, ncell,
                                                      stride, gz, row, stats);
  deposit_kernel<<<grid, kDepositThreads, 0, s>>>(
      plane, counts, ncell, S, nmesh, nxg, slab, row0, stride, gz, row,
      static_cast<float>(scale), static_cast<float>(shift), stats, nodes,
      sums);
  const int threads = 256;
  const size_t blocks =
      std::min<size_t>((nodes + threads - 1) / threads, 132 * 16);
  deposit_float_kernel<<<dim3(static_cast<unsigned>(blocks), 1, members),
                         threads, 0, s>>>(sums, nodes, stats, rho);
  return static_cast<int>(cudaGetLastError());
}

// K3.  plane, ws, nch, out, box and drift as p3m_columns_f32, `members` of
// them in one launch; grids (members, 3, nxg, nmesh, nmesh) float32, or
// (members, 6, ...) with `interlaced` (rows 3-5 read at -0.5 cell):
// nxg = nmesh periodic (slab = 0, nx = ncell), or on a slab (slab = 1, its
// first x-row row0 of the box's grid) the haloed nx * S + 4 planes.
// `split_out` writes the PM force to rows 3-5 and the short-range sum
// alone to rows 0-2.
int pm_supercell_fused_f32(const float* plane, const int* ws, const int* nch,
                           const float* grids, int members, int nmesh,
                           int interlaced, int split_out, int nx, int ncell,
                           int slab, int row0, int S, double scale,
                           int stride, int W, int maxch, int gz, int chunk,
                           double eps, double r_s, double r_cut, double box,
                           const float* drift, int split, int softening,
                           float* out, void* stream) {
  if (members < 1 || members > 65535 || ncell < 1 || nx < 1 || nx > ncell ||
      (slab == 0 && nx != ncell) ||
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
  const auto run = split == 0
                       ? (softening == 0 ? &dispatch_fused<0, 0>
                                         : &dispatch_fused<0, 1>)
                       : (softening == 0 ? &dispatch_fused<1, 0>
                                         : &dispatch_fused<1, 1>);
  run(il, so, plane, ws, nch, grids, members, nmesh, nxg, slab, row0, S, sc,
      g, p, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
