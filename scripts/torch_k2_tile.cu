// K2 in the shared-memory tile design, a design this repository measured
// and did not keep: scripts/torch_k2_ablation.py builds it alone (nvcc
// -shared) as its ``tile`` variant and times it beside the kernel.  It
// exports pm_supercell_deposit_f32 with an items' z range Z and a scratch
// buffer (the ablation's tile_geometry gives both).  Its design, in its
// own words:
//
// The design: a block takes one item, a column and a range of Z of its
// z nodes, and accumulates the item's tile in shared memory: the
// (S + 4)^2 node lines (x, y nodes -2 .. S + 1 of the column's tile) over
// the range's Z nodes.  Every block of a column reads all the column's
// real slots (from L2) and keeps the corners whose z node falls in its
// range: no corner has two owners, and the tile needs no z halo.  The
// tile holds fixed-point integers, round(w 2^31 / M) with M the column's
// mass, added with the native integer atomics of shared memory: on this
// card a float atomicAdd to shared memory is a compare-and-swap loop,
// and it ran at the rate of the global atomics it was to replace
// (scripts/torch_k2_ablation.py); integer sums do not depend on their
// order, and 2^-31 M a unit keeps the nodes within 1e-7 of the float32
// ones.  Then the block stores the item's core (the column's S x S lines)
// into the mesh as float32: the cores tile the mesh, so every node is
// written once and the caller need not zero it.  The ring of the tile
// around the core goes to a scratch buffer, line by line where a line
// holds any mass, and a second kernel has each item gather, for the
// nodes it owns within the ring's reach, the ring lines of the columns
// around it in a fixed order and add them: no two blocks touch a node,
// and the mesh is the same bit for bit from launch to launch.  A corner
// off its tile across the column (a particle drifted more than two nodes
// past its column) flags its item; the second kernel then adds every
// ring line and those corners with float atomics: any drift still
// reaches the mesh, in an order that may change.  The TPU's fold of the
// halos by XLA becomes the second kernel; the zero fill of the mesh is
// gone.
//
// Measured on an NVIDIA H100 (PERF.md): the tile kernel and the
// gather each take about as long as the one-thread-a-slot kernel with
// global atomics, so the design is slower than that kernel at every site.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// K2: threads a block of each kernel, and a tile's halo in nodes each
// side of the column (x, y)
constexpr int kDepositThreads = 256;
constexpr int kRingThreads = 128;
constexpr int kDepositHalo = 2;
// mask words of an item's lines: (S + 4)^2 lines at S <= 13
constexpr int kMaskWords = 10;

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

// The geometry of one K2 launch: the plane's columns, the items (a
// column and a range of Z z nodes; nr ranges a column) and their tiles.
struct DepositGeom {
  int ncell, S, nmesh, nxg, slab, row0, stride, gz, Z, nr;
  size_t row;  // floats a plane row
  float scale, shift;
};

// A real slot's CIC cell: its lower corner node (ix, iy relative to the
// column's tile origin, iz absolute) and the weights of its two nodes a
// side, from its coordinates in cells relative to the tile origin, as
// the TPU kernel, rounded op by op as the plain version (no multiply-add
// contraction); w[3] is the mass.
struct SlotCell {
  int ix, iy, iz;
  float wx[2], wy[2], wz[2], m;
};

__device__ __forceinline__ SlotCell slot_cell(const float* __restrict__ plane,
                                              const DepositGeom& g, size_t i,
                                              int cx, int cy) {
  const float x = __fsub_rn(
      __fsub_rn(__fmul_rn(plane[i], g.scale),
                static_cast<float>((cx + g.row0) * g.S)),
      g.shift);
  const float y = __fsub_rn(__fsub_rn(__fmul_rn(plane[g.row + i], g.scale),
                                      static_cast<float>(cy * g.S)),
                            g.shift);
  const float z = __fsub_rn(__fmul_rn(plane[2 * g.row + i], g.scale),
                            g.shift);
  const float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
  const float fx = x - fx0, fy = y - fy0, fz = z - fz0;
  SlotCell c;
  c.ix = static_cast<int>(fx0);
  c.iy = static_cast<int>(fy0);
  c.iz = static_cast<int>(fz0);
  c.wx[0] = 1.0f - fx;
  c.wx[1] = fx;
  c.wy[0] = 1.0f - fy;
  c.wy[1] = fy;
  c.wz[0] = 1.0f - fz;
  c.wz[1] = fz;
  c.m = plane[3 * g.row + i];
  return c;
}

// The mesh offset of tile line (a, b) of column (cx, cy): its x plane
// (x_plane; -1 outside a slab's halo) and y node, or -1.
__device__ __forceinline__ long long line_base(const DepositGeom& g, int cx,
                                               int cy, int a, int b) {
  const int px =
      x_plane(cx * g.S + a - kDepositHalo, g.nmesh, g.nxg, g.slab);
  if (px < 0) return -1;
  const int py = wrap(cy * g.S + b - kDepositHalo, g.nmesh);
  return (static_cast<long long>(px) * g.nmesh + py) * g.nmesh;
}

// A tile node: a fixed-point mass, round(w * q) with q = 2^31 / M.
using TileWord = unsigned;
__device__ __forceinline__ void tile_add(TileWord* node, float w, float q) {
  atomicAdd(node, __float2uint_rn(w * q));
}
__device__ __forceinline__ float tile_mass(TileWord v, float unit) {
  return __uint2float_rn(v) * unit;
}

// Kernel 1: one item a block.  The column's mass M first (a block sum in
// a fixed order); then every real slot of the column: of its corners,
// those whose z node lies in the item's range go into the item's shared
// tile as fixed-point integers (round(w * 2^31 / M), so no node can
// overflow 32 bits and a node's sum does not depend on the order of the
// native integer atomics), or, off the tile across the column, flag the
// item for the global path.  Then the item's core goes into the mesh as
// float32 (a store: the cores tile the mesh), its ring lines that hold
// mass go to the scratch as float32 (each at its own place, its bit set
// in the item's mask), and the item's flag word (bit 0: a corner off the
// tile).  On a slab it also zeroes the halo planes that no core covers
// (nodes -1, nml and nml + 1), which only kernel 2 adds into.
__global__ void __launch_bounds__(kDepositThreads)
deposit_tile_kernel(const float* __restrict__ plane,
                    const int* __restrict__ counts, DepositGeom g,
                    float* __restrict__ rho, float* __restrict__ ring,
                    unsigned* __restrict__ flags, int words) {
  extern __shared__ TileWord tile[];
  __shared__ float wsum[kDepositThreads / 32];
  __shared__ int far;
  __shared__ unsigned smask[kMaskWords];
  const int L = g.S + 2 * kDepositHalo;
  const int lines = L * L;
  // a tile line's stride in shared memory: odd, so that the lanes of a
  // warp, whose slots are z-sorted and so share a z node, fall on other
  // banks in other lines
  const int LS = g.Z | 1;
  const int item = blockIdx.x;
  const int ic = item / g.nr;
  const int cx = ic / g.ncell, cy = ic % g.ncell;
  const int z0 = (item % g.nr) * g.Z;
  const int P = g.ncell + 2;
  const size_t i0 =
      static_cast<size_t>((cx + 1) * P + (cy + 1)) * g.stride + g.gz;
  const int n = counts[ic];
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < lines * LS; e += kDepositThreads)
    tile[e] = TileWord(0);
  if (threadIdx.x < kMaskWords) smask[threadIdx.x] = 0u;
  if (threadIdx.x == 0) far = 0;
  if (g.slab) {
    // planes 0, nxg - 2 and nxg - 1 (nodes -1, nml, nml + 1), shared out
    // over the blocks
    const size_t plane_n = static_cast<size_t>(g.nmesh) * g.nmesh;
    for (size_t e = static_cast<size_t>(item) * kDepositThreads + threadIdx.x;
         e < 3 * plane_n; e += static_cast<size_t>(gridDim.x) * kDepositThreads) {
      const size_t p = e / plane_n;
      rho[(p == 0 ? 0 : g.nxg - 3 + p) * plane_n + e % plane_n] = 0.0f;
    }
  }
  float m = 0.0f;
  for (int r = threadIdx.x; r < n; r += kDepositThreads)
    m += plane[3 * g.row + i0 + r];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
  if (lane == 0) wsum[threadIdx.x >> 5] = m;
  __syncthreads();
  float mass = 0.0f;
#pragma unroll
  for (int w = 0; w < kDepositThreads / 32; ++w) mass += wsum[w];
  const float q = mass > 0.0f ? 2147483648.0f / mass : 0.0f;
  const float unit = mass / 2147483648.0f;

  bool off = false;
  for (int r = threadIdx.x; r < n; r += kDepositThreads) {
    const SlotCell c = slot_cell(plane, g, i0 + r, cx, cy);
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int kz = wrap(c.iz + dz, g.nmesh) - z0;
      if (kz < 0 || kz >= g.Z) continue;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int la = c.ix + a + kDepositHalo, lb = c.iy + b + kDepositHalo;
          if (la >= 0 && la < L && lb >= 0 && lb < L) {
            tile_add(&tile[(la * L + lb) * LS + kz],
                     c.wx[a] * c.wy[b] * c.m * c.wz[dz], q);
          } else {
            off = true;
          }
        }
      }
    }
  }
  if (off) far = 1;
  __syncthreads();

  // the core: lines (a, b) in kDepositHalo .. + S, four z nodes a thread
  // where the mesh rows allow a vector store
  const int S = g.S;
  if ((g.Z & 3) == 0) {
    const int nq = g.Z >> 2;
    for (int e = threadIdx.x; e < S * S * nq; e += kDepositThreads) {
      const int line = e / nq, k = (e % nq) * 4;
      const int a = line / S + kDepositHalo, b = line % S + kDepositHalo;
      const TileWord* t = &tile[(a * L + b) * LS + k];
      *reinterpret_cast<float4*>(rho + line_base(g, cx, cy, a, b) + z0 + k) =
          make_float4(tile_mass(t[0], unit), tile_mass(t[1], unit),
                      tile_mass(t[2], unit), tile_mass(t[3], unit));
    }
  } else {
    for (int e = threadIdx.x; e < S * S * g.Z; e += kDepositThreads) {
      const int line = e / g.Z, k = e % g.Z;
      const int a = line / S + kDepositHalo, b = line % S + kDepositHalo;
      rho[line_base(g, cx, cy, a, b) + z0 + k] =
          tile_mass(tile[(a * L + b) * LS + k], unit);
    }
  }

  // the ring: a warp a line; lines that hold mass go to the scratch
  float* rl = ring + static_cast<size_t>(item) * lines * g.Z;
  for (int line = threadIdx.x >> 5; line < lines;
       line += kDepositThreads / 32) {
    const int a = line / L, b = line % L;
    if (a >= kDepositHalo && a < kDepositHalo + S && b >= kDepositHalo &&
        b < kDepositHalo + S)
      continue;
    bool any = false;
    for (int k = lane; k < g.Z; k += 32)
      any |= tile[line * LS + k] != TileWord(0);
    if (__ballot_sync(0xffffffffu, any) == 0u) continue;
    for (int k = lane; k < g.Z; k += 32)
      rl[line * g.Z + k] = tile_mass(tile[line * LS + k], unit);
    if (lane == 0) atomicOr(&smask[line / 32], 1u << (line % 32));
  }
  __syncthreads();
  unsigned* mask = flags + static_cast<size_t>(item) * words;
  if (threadIdx.x < words)
    mask[threadIdx.x] = threadIdx.x == 0 ? far : smask[threadIdx.x - 1];
}

// Kernel 2: one item a block, after every core is stored.  Each mesh
// node the item owns that a ring can reach (its core's lines within
// kDepositHalo of the column's edge, and on a slab the halo planes' lines
// beside an edge column) gathers the ring lines of the columns around it
// (the same z range) in a fixed order and adds their sum: with no corner
// off a tile anywhere, no two blocks touch one node and the mesh is the
// same bit for bit from launch to launch.  Where some item flagged a
// corner off its tile, every add is atomic and the flagged items add
// their corners off the tile with scalar atomics.
__global__ void __launch_bounds__(kRingThreads)
deposit_ring_kernel(const float* __restrict__ plane,
                    const int* __restrict__ counts, DepositGeom g, int nx,
                    float* __restrict__ rho, const float* __restrict__ ring,
                    const unsigned* __restrict__ flags, int words) {
  // the mask words of the 3 x 3 columns around the item's (same range)
  __shared__ unsigned around[9][kMaskWords + 1];
  __shared__ int src_item[9];

  const int L = g.S + 2 * kDepositHalo;
  const int lines = L * L;
  const int S = g.S;
  const int item = blockIdx.x;
  const int ic = item / g.nr, zr = item % g.nr;
  const int cx = ic / g.ncell, cy = ic % g.ncell;
  const int z0 = zr * g.Z;
  bool f = false;
  for (int i = threadIdx.x; i < gridDim.x; i += kRingThreads)
    f |= flags[static_cast<size_t>(i) * words] != 0u;
  const bool any_far = __syncthreads_or(f);
  if (threadIdx.x < 9) {
    const int sx = cx + threadIdx.x / 3 - 1, sy = cy + threadIdx.x % 3 - 1;
    const bool in = g.slab ? (sx >= 0 && sx < nx) : true;
    src_item[threadIdx.x] =
        in ? ((wrap(sx, nx) * g.ncell + wrap(sy, g.ncell)) * g.nr + zr) : -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * words; e += kRingThreads) {
    const int s = e / words, w = e % words;
    around[s][w] = src_item[s] < 0
                       ? 0u
                       : flags[static_cast<size_t>(src_item[s]) * words + w];
  }
  __syncthreads();
  // the target lines: (x node, y node) as local offsets (tx, ty) from the
  // column's first node; the core's edge lines, then on a slab the halo
  // planes' lines beside an edge column (x node -1 of the first x-row,
  // nml and nml + 1 of the last)
  // the core's edge lines (within kDepositHalo of the column's edge): the
  // first and last kDepositHalo rows whole, then the ends of the rows
  // between (every line when S <= 2 kDepositHalo)
  const int inner = S > 2 * kDepositHalo ? S - 2 * kDepositHalo : 0;
  const int edge = S * S - inner * inner;
  const int lo_halo = g.slab && cx == 0 ? 1 : 0;
  const int hi_halo = g.slab && cx == nx - 1 ? 2 : 0;
  const int targets = edge + (lo_halo + hi_halo) * S;
  for (int e = threadIdx.x; e < targets * g.Z; e += kRingThreads) {
    const int tl = e / g.Z, k = e % g.Z;
    int tx, ty;
    if (tl < edge) {
      const int rows = 2 * kDepositHalo * S;
      if (inner == 0 || tl < rows) {
        const int r = inner == 0 || tl < rows / 2 ? tl : tl + inner * S;
        tx = r / S;
        ty = r % S;
      } else {
        const int r = tl - rows;
        tx = kDepositHalo + r / (2 * kDepositHalo);
        const int c = r % (2 * kDepositHalo);
        ty = c < kDepositHalo ? c : S - 2 * kDepositHalo + c;
      }
    } else {
      const int h = (tl - edge) / S;
      ty = (tl - edge) % S;
      tx = h < lo_halo ? -1 : S + (h - lo_halo);
    }
    float sum = 0.0f;
    bool hit = false;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (src_item[s] < 0) continue;
      const int a = tx - (s / 3 - 1) * S + kDepositHalo;
      const int b = ty - (s % 3 - 1) * S + kDepositHalo;
      if (a < 0 || a >= L || b < 0 || b >= L) continue;
      if (a >= kDepositHalo && a < kDepositHalo + S && b >= kDepositHalo &&
          b < kDepositHalo + S)
        continue;
      const int line = a * L + b;
      if (!((around[s][1 + line / 32] >> (line % 32)) & 1u)) continue;
      sum += ring[(static_cast<size_t>(src_item[s]) * lines + line) * g.Z + k];
      hit = true;
    }
    if (!hit) continue;
    const long long base =
        line_base(g, cx, cy, tx + kDepositHalo, ty + kDepositHalo);
    if (base < 0) continue;
    float* node = rho + base + z0 + k;
    if (any_far) {
      atomicAdd(node, sum);
    } else {
      *node += sum;
    }
  }
  if (!around[4][0]) return;
  // the corners off the tile: the column's slots again, the corners in
  // the item's z range whose node lies off the tile across the column
  const int P = g.ncell + 2;
  const size_t i0 =
      static_cast<size_t>((cx + 1) * P + (cy + 1)) * g.stride + g.gz;
  const int n = counts[ic];
  for (int r = threadIdx.x; r < n; r += kRingThreads) {
    const SlotCell c = slot_cell(plane, g, i0 + r, cx, cy);
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int kz = wrap(c.iz + dz, g.nmesh);
      if (kz < z0 || kz >= z0 + g.Z) continue;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int la = c.ix + a + kDepositHalo, lb = c.iy + b + kDepositHalo;
          if (la >= 0 && la < L && lb >= 0 && lb < L) continue;
          const int px = x_plane(cx * S + c.ix + a, g.nmesh, g.nxg, g.slab);
          if (px < 0) continue;
          const size_t gxy = (static_cast<size_t>(px) * g.nmesh +
                              wrap(cy * S + c.iy + b, g.nmesh)) * g.nmesh;
          atomicAdd(rho + gxy + kz, c.wx[a] * c.wy[b] * c.m * c.wz[dz]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// K2.  plane (8, (nx + 2) * (ncell + 2) * stride) float32; counts
// (nx * ncell,) int32 (real slots per column, <= CK); rho receives the
// masses, every node written (the caller need not zero it): (nmesh^3,)
// with nx = ncell and slab = 0, or on a slab (slab = 1, nx = ncell / D,
// its first x-row row0 of the box's grid) the haloed (nx * S + 3, nmesh,
// nmesh).  Z: z nodes an item (a divisor of nmesh; nmesh / Z items a
// column); scratch: items * ((S + 4)^2 * Z + 1 + ceil((S + 4)^2 / 32))
// floats, no fill needed.  Two launches on `stream`.  Returns cudaGetLastError() after them (0 on success); 1
// (cudaErrorInvalidValue) for arguments the kernels do not take.
int pm_supercell_deposit_f32(const float* plane, const int* counts, int nx,
                             int ncell, int slab, int row0, int S, int nmesh,
                             int stride, int gz, int CK, int Z, double scale,
                             double shift, float* rho, float* scratch,
                             void* stream) {
  const int L = S + 2 * kDepositHalo;
  if (ncell < 1 || nx < 1 || nx > ncell || (slab == 0 && nx != ncell) ||
      slab < 0 || slab > 1 || row0 < 0 || row0 + nx > ncell ||
      (slab == 0 && row0 != 0) || S < 1 || nmesh != ncell * S ||
      stride < 1 || gz < 0 || CK < 1 || gz + CK > stride || Z < 1 ||
      nmesh % Z != 0 || L * L > 32 * kMaskWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DepositGeom g;
  g.ncell = ncell;
  g.S = S;
  g.nmesh = nmesh;
  g.nxg = slab ? nx * S + 3 : nmesh;
  g.slab = slab;
  g.row0 = row0;
  g.stride = stride;
  g.gz = gz;
  g.Z = Z;
  g.nr = nmesh / Z;
  g.row = static_cast<size_t>(nx + 2) * (ncell + 2) * stride;
  g.scale = static_cast<float>(scale);
  g.shift = static_cast<float>(shift);
  const int items = nx * ncell * g.nr;
  const int lines = L * L;
  const int words = 1 + (lines + 31) / 32;
  const size_t smem = static_cast<size_t>(lines) * (Z | 1) * sizeof(float);
  float* ring = scratch;
  unsigned* flags = reinterpret_cast<unsigned*>(
      scratch + static_cast<size_t>(items) * lines * Z);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        deposit_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  deposit_tile_kernel<<<items, kDepositThreads, smem, s>>>(
      plane, counts, g, rho, ring, flags, words);
  deposit_ring_kernel<<<items, kRingThreads, 0, s>>>(
      plane, counts, g, nx, rho, ring, flags, words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
