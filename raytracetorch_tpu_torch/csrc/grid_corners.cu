// Phase-map corner reads for Hopper (sm_90a): kernel K4, standalone.
//
// Replaces the TPU kernel function raytracetorch_tpu/ops/pallas_trace.py::
// _grid_corners_mxu (the four bilinear corners of a PHASE_GRID plate's
// [H, W] map, inside the fused TPU kernels) and its transpose, which the TPU
// backward kernels take with jax.vjp of the same one-hot matmuls.  Its plain
// PyTorch version is ops/phase_grid.py::grid_corners_plain (four clamped
// advanced-index reads; their autograd is the scatter), and the wrappers that
// launch it are ops/phase_grid.py::grid_corners_cuda and
// grid_corners_bwd_cuda.
//
// What it computes: for each of n cells (iv, iu), the map values at (iv, iu),
// (iv, iu + 1), (iv + 1, iu) and (iv + 1, iu + 1), every index clamped into
// the map (grid_corners.cuh::corner_cells).  The backward
// (rtt_grid_corners_bwd) adds the four corner cotangents of each cell into
// an [H, W] cotangent map at the same clamped cells.
//
// The TPU kernel has no per-lane gather, so it turns each read into one-hot
// f32 matmuls on the MXU (two [W, H] x [H, 128] products per tile row, at
// HIGHEST precision) and keeps the map in VMEM, which caps it at 256 x 256.
// On Hopper a thread reads its four corners directly: one thread per cell,
// the map read through the read-only path (__ldg); a 256 x 256 float32 map is
// 256 KB and stays in the 50 MB L2, so no size cap is carried over.
// Out-of-range indices clamp, as XLA's gather in the reference's eager trace
// does; the one-hot reads of the TPU kernel give 0 there instead (ROADMAP
// Queue 3).  Within the fused kernels K1, K2, K5 and K6 the same device
// functions read and scatter as they trace, so the indices never reach
// device memory.
//
// What bounds it, as measured on an H100 (PERF.md): per cell the gather reads
// 8 B of indices and writes 16 B of corners, 24 MB at 1M cells, ~7 us at
// 3.35 TB/s, and runs near that.  The scatter moves the same bytes, but its
// first design, one scalar atomicAdd (a RED) per corner into device memory,
// was bound by the count of L2 atomic operations: 4M of them took 61 us on
// the 256 x 256 map, and on example 28's 32 x 32 map, where 1M ring-former
// cells fall on 481 cells, atomics on one address serialize in L2: 0.54 ms.
//
// The scatter's design: the launcher picks one of two paths from the map's
// size.
// - A map of at most kMaxSharedCells (224 KB: what one block's shared memory
//   holds) is added up in shared memory: persistent clusters of
//   kClusterBlocks = 2 blocks of 512 threads, as many as are resident; each
//   block zeroes its own copy of the map and adds its grid-stride share of
//   the cells' cotangents into it (a warp whose live lanes all hold one patch
//   adds their sums once, a focus inside one cell being the worst case of
//   contention); then the two blocks of a cluster sum their copies through
//   distributed shared memory and add each nonzero group of 4 cells to the
//   map in device memory with one vector atomic.  Float atomics into shared
//   memory are compare-and-swap loops on Hopper, but they spread over the
//   SMs and no longer queue at one L2 address: 32 x 32 0.54 -> 0.018 ms, and
//   faster than the vector path on every map that fits, with one resident
//   block an SM as with three (PERF.md).
// - A larger map (256 x 256 is 256 KB) takes the vector path, one thread a
//   cell: the two cells of a patch row are adjacent, so they go into one
//   16-byte red.global.add.v4.f32 whenever they share a 16-byte group (3 of
//   4 positions), two scalar atomics otherwise; rows that coincide at a
//   clamped rim are summed in registers first.  About 2.5 L2 operations a
//   cell instead of 4, and the L2 takes a vector atomic as one: 256 x 256
//   0.061 -> 0.039 ms (grid_corners.cuh::scatter_corners).
// K2 and K6 scatter a plate ray's cotangents with the same vector atomics,
// no slower than scalar ones there (PERF.md).
//
// Numerics: the gather is exact.  Float atomics add in an order that changes
// from run to run, so a cell's sum may differ in its last bits between runs
// and from the plain version.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "grid_corners.cuh"

using namespace rtt;
namespace cg = cooperative_groups;

namespace {

constexpr int kCornerThreads = 256;   // threads per block of the gather and the vector scatter
constexpr int kSharedThreads = 512;   // threads per block of the shared-map scatter
constexpr int kSharedMinBlocks = 3;   // its launch bound: 48 warps an SM (maps up to 74 KB)
constexpr int kMaxSharedCells = 57344;  // 224 KB: the largest map a block holds
constexpr int kClusterBlocks = 2;     // blocks whose maps one flush sums
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kCornerThreads)
grid_corners_kernel(const float* __restrict__ map, int h, int w, const int32_t* __restrict__ iv,
                    const int32_t* __restrict__ iu, long long n, float* __restrict__ c00,
                    float* __restrict__ c01, float* __restrict__ c10, float* __restrict__ c11) {
  const long long i = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
  if (i >= n) return;
  const Corners c = read_corners(map, corner_cells(h, w, iv[i], iu[i]));
  c00[i] = c.g00;
  c01[i] = c.g01;
  c10[i] = c.g10;
  c11[i] = c.g11;
}

// The scatter of a map larger than kMaxSharedCells: one thread a cell, its
// four cotangents added into device memory by scatter_corners (vector
// atomics).
__global__ void __launch_bounds__(kCornerThreads)
grid_corners_bwd_kernel(const float* __restrict__ g00, const float* __restrict__ g01,
                        const float* __restrict__ g10, const float* __restrict__ g11,
                        const int32_t* __restrict__ iv, const int32_t* __restrict__ iu,
                        long long n, float* __restrict__ gmap, int h, int w) {
  const long long i = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
  if (i >= n) return;
  const Corners g = {g00 ? g00[i] : 0.0f, g01 ? g01[i] : 0.0f, g10 ? g10[i] : 0.0f,
                     g11 ? g11[i] : 0.0f};
  scatter_corners(gmap, h * w, corner_cells(h, w, iv[i], iu[i]), g);
}

// Add one lane's four corner cotangents g at cells c into the block's map in
// shared memory (live: the lane holds a cell).  A warp whose live lanes all
// hold one patch adds its sums once, from its lowest live lane (a focus
// inside one cell, the worst case of contention); other warps add lane by
// lane.  Every lane of the warp calls it.
__device__ __forceinline__ void add_shared(float* smap, bool live, const CornerCells& c,
                                           Corners g, int lane) {
  const unsigned act = __ballot_sync(kFull, live);
  if (act == 0u) return;
  const int first = __ffs(act) - 1;
  const int k00 = __shfl_sync(kFull, c.c00, first), k11 = __shfl_sync(kFull, c.c11, first);
  if (__all_sync(kFull, !live || (c.c00 == k00 && c.c11 == k11))) {
    if (!live) g = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g.g00 += __shfl_down_sync(kFull, g.g00, off);
      g.g01 += __shfl_down_sync(kFull, g.g01, off);
      g.g10 += __shfl_down_sync(kFull, g.g10, off);
      g.g11 += __shfl_down_sync(kFull, g.g11, off);
    }
    g = {__shfl_sync(kFull, g.g00, 0), __shfl_sync(kFull, g.g01, 0),
         __shfl_sync(kFull, g.g10, 0), __shfl_sync(kFull, g.g11, 0)};
    if (lane != first) return;
  } else if (!live) {
    return;
  }
  if (g.g00 != 0.0f) atomicAdd(smap + c.c00, g.g00);
  if (g.g01 != 0.0f) atomicAdd(smap + c.c01, g.g01);
  if (g.g10 != 0.0f) atomicAdd(smap + c.c10, g.g10);
  if (g.g11 != 0.0f) atomicAdd(smap + c.c11, g.g11);
}

// The scatter of a map of at most kMaxSharedCells: each block adds its
// grid-stride share of the cells into its own copy of the map in shared
// memory; the kClusterBlocks blocks of a cluster then sum their copies
// through distributed shared memory and add each nonzero group of 4 cells to
// the map in device memory, one vector atomic a group (scalar atomics for
// a group past the map's end or a map not 16-byte aligned).
__global__ void __launch_bounds__(kSharedThreads, kSharedMinBlocks)
grid_corners_bwd_shared_kernel(const float* __restrict__ g00, const float* __restrict__ g01,
                               const float* __restrict__ g10, const float* __restrict__ g11,
                               const int32_t* __restrict__ iv, const int32_t* __restrict__ iu,
                               long long n, float* __restrict__ gmap, int h, int w) {
  extern __shared__ float4 smap4[];
  float* smap = reinterpret_cast<float*>(smap4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int cells = h * w, groups = (cells + 3) / 4;
  for (int j = tid; j < groups; j += kSharedThreads) smap4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * kSharedThreads;
  // the loop runs the same trips in every lane of a block: the warp calls
  // of add_shared see every lane
  for (long long base = static_cast<long long>(blockIdx.x) * kSharedThreads; base < n;
       base += step) {
    const long long i = base + tid;
    const bool live = i < n;
    CornerCells c = {0, 0, 0, 0};
    Corners g = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      c = corner_cells(h, w, iv[i], iu[i]);
      g = {g00 ? g00[i] : 0.0f, g01 ? g01[i] : 0.0f, g10 ? g10[i] : 0.0f, g11 ? g11[i] : 0.0f};
    }
    add_shared(smap, live, c, g, lane);
  }
  cluster.sync();  // every map of the cluster is complete
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = (groups + kClusterBlocks - 1) / kClusterBlocks;
  const int lo = rank * chunk, hi = min(groups, lo + chunk);
  const bool vec = (reinterpret_cast<uintptr_t>(gmap) & 15) == 0;
  for (int j = lo + tid; j < hi; j += kSharedThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < kClusterBlocks; ++r) {
      const float4 u = reinterpret_cast<const float4*>(cluster.map_shared_rank(smap, r))[j];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
    if (vec && 4 * j + 4 <= cells) {
      atomicAdd(reinterpret_cast<float4*>(gmap) + j, v);
    } else {
      const float s[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && 4 * j + k < cells; ++k)
        if (s[k] != 0.0f) atomicAdd(gmap + 4 * j + k, s[k]);
    }
  }
  cluster.sync();  // no block leaves while another reads its map
}

long long blocks_of(long long n) { return (n + kCornerThreads - 1) / kCornerThreads; }

}  // namespace

// c00..c11[i] = the four corners of cell (iv[i], iu[i]) of the h x w map.
// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int rtt_grid_corners(const float* map, int h, int w, const int32_t* iv,
                                const int32_t* iu, long long n, float* c00, float* c01,
                                float* c10, float* c11, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_of(n) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid_corners_kernel<<<static_cast<unsigned>(blocks_of(n)), kCornerThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(map, h, w, iv, iu, n, c00, c01, c10,
                                                             c11);
  return static_cast<int>(cudaGetLastError());
}

// Adds the corner cotangents g00..g11 (each may be null: zero) of the n
// cells into the h x w cotangent map gmap (the caller zeroes it or passes one
// to accumulate into; a vector atomic adds +0.0 to the cells beside a pair,
// which turns a -0.0 there into +0.0).  A map of at most kMaxSharedCells
// cells takes the shared-map scatter, a larger one the vector scatter.
// Launches on `stream`; returns a cudaError_t (0 on success): a launch the
// card refuses returns its error, and nothing falls back.
extern "C" int rtt_grid_corners_bwd(const float* g00, const float* g01, const float* g10,
                                    const float* g11, const int32_t* iv, const int32_t* iu,
                                    long long n, float* gmap, int h, int w, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0 || static_cast<long long>(h) * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(h) * w > kMaxSharedCells) {
    if (blocks_of(n) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_corners_bwd_kernel<<<static_cast<unsigned>(blocks_of(n)), kCornerThreads, 0, st>>>(
        g00, g01, g10, g11, iv, iu, n, gmap, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float4) * static_cast<size_t>((h * w + 3) / 4);
  int most = 0;
  const cudaError_t err = resident_clusters<kClusterBlocks>(
      grid_corners_bwd_shared_kernel, kSharedThreads, sizeof(float) * kMaxSharedCells, smem,
      &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_cluster = static_cast<long long>(kClusterBlocks) * kSharedThreads;
  long long clusters = (n + per_cluster - 1) / per_cluster;
  if (clusters > most) clusters = most;
  return static_cast<int>(launch_clusters<kClusterBlocks>(grid_corners_bwd_shared_kernel,
                                                          clusters, kSharedThreads, smem, st,
                                                          g00, g01, g10, g11, iv, iu, n, gmap, h,
                                                          w));
}
