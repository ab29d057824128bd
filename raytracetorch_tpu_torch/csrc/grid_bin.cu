// Irradiance-grid binning for Hopper (sm_90a): kernel K3, standalone.
//
// Replaces the TPU kernel functions raytracetorch_tpu/ops/pallas_trace.py::
// _grid_partial and _grid_accumulate (the histogram, inside the fused TPU
// kernels) and _grid_partial_g with its backward _grid_partial_g_bwd (the
// gather of the grid's cotangent).  The XLA twin is raytracetorch_tpu/core/
// sensor.py::_bin_grid.  Its plain PyTorch version is core/sensor.py::
// bin_grid_plain (per slot: ops/grid.py::bin_grid_slots_plain), and the
// wrappers that launch it are ops/grid.py::bin_grid_cuda and
// grid_gather_cuda.
//
// What it computes: an [S, H, W] float32 histogram of sensor-local hits
// (x, y) with weights w and sensor slots s (a stream, or one slot for all),
// on a grid over [-e, e]^2 with the bins of grid_bin.cuh::grid_cell; hits
// outside the grid clip to the edge cells.  The backward (rtt_grid_gather)
// reads d loss / d w = g[s, iy, ix] per hit; the bins have no derivative in
// x or y.
//
// The TPU kernel recasts the histogram as one-hot bf16 matmuls on the MXU
// with a hi+lo split of each weight (Mosaic has no scatter), which carries
// about 2^-16 relative rounding per weight.  None of that is carried over:
// on Hopper the histogram is a scatter-add.  Within the fused kernels K1 and
// K5 the device function grid_add (grid_bin.cuh) bins each sensor crossing
// as it is traced, one atomicAdd into device memory, so the hits never reach
// device memory.
//
// What bounds it: per hit it reads 12 B (16 B with a slot stream), so 1M
// hits are 12-16 MB, 4-5 us at the H100's 3.35 TB/s.  With one global
// atomicAdd per hit (the first design of this kernel) contention set the
// pace instead: the bench scene puts 1M hits into about 2,000 cells of a
// 256 x 256 grid, a few hundred per cell, and atomics on one cell serialize
// in L2; all hits on one cell took 1.7 ms (PERF.md).
//
// Design: a privatised histogram in shared memory, summed across a
// thread-block cluster before it reaches device memory.
// - The window: each block keeps a band of the grid in its shared memory,
//   in every slot the same rows centred on the grid, at most kMaxSliceCells
//   cells (50 KB; kBinMinBlocks = 3 blocks of 512 threads share an SM); a
//   grid that small is held whole.  Cells outside the band are added in
//   device memory.  band_rows picks the band from the grid's shape.
// - Each block walks its grid-stride share of the hits, kBatch at a time:
//   first the batch's weights, all in flight together, then the
//   coordinates of the hits that count (a batch whose loads waited on each
//   other's branches paid one memory latency per hit).  It bins each with
//   grid_axis (grid_cell's bins, so the bin edges stay the plain
//   version's), and adds each weight into its own window, or into device
//   memory outside the band.  A warp whose hits all fall on one cell adds
//   their sum once (a focus inside one cell, the worst case of contention,
//   takes one atomic per warp: 30x faster than lane by lane, at 3% on the
//   bench spot); other warps add lane by lane, since combining lanes on
//   equal cells with __match_any_sync cost the bench spot more than it
//   saved (PERF.md).
// - A block zeroes its window only when its first hit that the window takes
//   comes in, and tells the other blocks of its cluster whether it did.
//   Blocks that had nothing to add leave after one cluster barrier: four of
//   the five launches of the eager bounce loop carry only zero weights
//   (rays off the sensor), and cost one read of their weights.
// - The flush: the kClusterBlocks = 2 blocks of a cluster sum the windows
//   that took hits through distributed shared memory (each block half of
//   the cells, the windows read in a fixed order) and add each nonzero sum
//   to the grid in device memory: one atomicAdd per cell and cluster, not
//   per block.  Cluster barriers before and after keep every window alive
//   while the other block reads it.  (Clusters of 4 and 8 blocks flushed
//   fewer atomics and ran 4-20% slower: the reads across the cluster cost
//   more.)
// - The kernel is persistent: it launches no more clusters than are
//   resident at once, and none whose threads would have no batch of hits,
//   so zeroing and flushing are paid once per resident block.
// - A grid of which less than an eighth of the rows fit the window (2 or 8
//   slots of 256^2) takes the path without a window, one thread a hit and
//   one atomicAdd into device memory each (grid_bin_global_kernel).
// - Where the band pays: hits that crowd into few cells, as a focused spot
//   does.  Hits spread over a whole 256^2 slot leave most of them outside
//   the band and few per cell inside it, so the flush adds about as many
//   atomics as it saves; that case runs a third slower than one atomic per
//   hit (PERF.md).
//
// Why the adds stay in the block's own shared memory: on Hopper a float
// atomicAdd into shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN), and into another block's a compare-and-swap loop across
// the cluster (ATOM.E.CAST.SPIN), one round trip per try.  A first design
// whose clusters held the whole grid in distributed shared memory, each hit
// added into the owning block's slice, took 0.035-0.038 ms on the bench spot
// against 0.022-0.026 for one global atomicAdd per hit (PERF.md).
// Plain loads from the other blocks' windows, once, at the flush, cost
// little.
//
// Numerics: float atomics add in an order that changes from run to run, so
// a cell's sum of non-integer weights may differ in its last bits between
// runs and from the plain version.  Unit weights (the sources of the main
// path) sum exactly up to 2^24 hits per cell, so their grid is exact and
// deterministic.  Zero weights are skipped (adding 0 changes nothing).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "grid_bin.cuh"

using namespace rtt;
namespace cg = cooperative_groups;

namespace {

constexpr int kBinThreads = 512;       // threads per block of the scatter
constexpr int kBinMinBlocks = 3;       // resident blocks an SM: 48 warps
constexpr int kBatch = 4;              // hits a thread loads before it adds them
constexpr int kMaxSliceCells = 12800;  // 50 KB of cells in a block's window
constexpr int kMinBandShare = 8;       // a band below 1/8 of the rows: no window
constexpr int kClusterBlocks = 2;      // blocks whose windows one flush sums
constexpr int kGlobalThreads = 256;    // threads per block without a window
constexpr int kGatherThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Rows of the band of an [n_slots, h, wd] grid that each block keeps in
// shared memory: all h when the grid fits kMaxSliceCells, else as many as
// fit; 0 (no window) when that is less than 1/kMinBandShare of them.
int band_rows(int n_slots, int h, int wd) {
  const long long fit = kMaxSliceCells / (static_cast<long long>(n_slots) * wd);
  const int rows = fit < h ? static_cast<int>(fit) : h;
  return static_cast<long long>(kMinBandShare) * rows >= h ? rows : 0;
}

// The window: in each of the grid's slots, rows [row0, row0 + rows) of its
// h x wd cells, slot after slot in shared memory.
struct Window {
  int rows, row0;
};

// Load a batch of kBatch hits, base + b * kBinThreads + tid, and give each
// its flat cell of the [S, H, W] grid (key -1: past n, outside the slots,
// or a zero weight) and of the window (wkey -1: outside it), and its
// weight.  The weights and slots of the batch are loaded first, all in
// flight together; then the coordinates of the hits that count (a zero
// weight's x and y are not read).
__device__ __forceinline__ void load_batch(long long base, int tid, const float* x,
                                           const float* y, const float* w, const int32_t* slot,
                                           int slot0, long long n, int n_slots, int h, int wd,
                                           float e, const Window& win, int (&key)[kBatch],
                                           int (&wkey)[kBatch], float (&wt)[kBatch]) {
  int s[kBatch];
  float xv[kBatch], yv[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long i = base + b * kBinThreads + tid;
    s[b] = -1;
    wt[b] = 0.0f;
    if (i < n) {
      s[b] = slot != nullptr ? slot[i] : slot0;
      wt[b] = w[i];
    }
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long i = base + b * kBinThreads + tid;
    xv[b] = 0.0f;
    yv[b] = 0.0f;
    if (s[b] >= 0 && s[b] < n_slots && wt[b] != 0.0f) {
      xv[b] = x[i];
      yv[b] = y[i];
    }
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    key[b] = -1;
    wkey[b] = -1;
    if (s[b] >= 0 && s[b] < n_slots && wt[b] != 0.0f) {
      const int iy = grid_axis(yv[b], h, e), ix = grid_axis(xv[b], wd, e);
      key[b] = (s[b] * h + iy) * wd + ix;
      const int wy = iy - win.row0;
      if (wy >= 0 && wy < win.rows) wkey[b] = (s[b] * win.rows + wy) * wd + ix;
    }
  }
}

// Add the weight wt of each lane's hit at flat cell `key` of the [S, H, W]
// grid, `wkey` of the window (key < 0: the lane adds nothing; wkey < 0: the
// cell lies outside the window): into the block's window or into the grid
// in device memory.  A warp whose counting lanes all hit one cell adds
// their sum once, from its lowest counting lane; other warps add lane by
// lane.  Every lane of the warp calls it.
__device__ __forceinline__ void add_hit(int key, int wkey, float wt, int lane, float* window,
                                        float* grid) {
  const unsigned act = __ballot_sync(kFull, key >= 0);
  if (act == 0u) return;
  const int first = __ffs(act) - 1;
  const int key0 = __shfl_sync(kFull, key, first);
  if (__all_sync(kFull, key < 0 || key == key0)) {
    float sum = key >= 0 ? wt : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFull, sum, off);
    sum = __shfl_sync(kFull, sum, 0);
    if (lane != first) return;
    wt = sum;
  } else if (key < 0) {
    return;
  }
  if (wkey < 0)
    atomicAdd(grid + key, wt);
  else
    atomicAdd(window + wkey, wt);
}

// The scatter with a window of `rows` rows (band_rows, > 0): launched as
// clusters of kClusterBlocks blocks.
__global__ void __launch_bounds__(kBinThreads, kBinMinBlocks)
grid_bin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const int32_t* __restrict__ slot, int slot0,
                long long n, float* __restrict__ grid, int n_slots, int h, int wd, float e,
                int rows) {
  extern __shared__ float4 window4[];
  __shared__ int took[kClusterBlocks];  // [r]: block r's window took hits
  float* window = reinterpret_cast<float*>(window4);
  cg::cluster_group cluster = cg::this_cluster();
  // the first half of a cluster barrier: the blocks of the cluster have
  // started before one writes into another's shared memory (below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const Window win = {rows, (h - rows) / 2};
  const int cells = n_slots * rows * wd;
  const long long step = static_cast<long long>(gridDim.x) * kBinThreads * kBatch;
  bool zeroed = false;  // the same in every thread of the block
  // the loop runs the same trips in every lane of a block: the warp calls
  // of add_hit see every lane
  for (long long base = static_cast<long long>(blockIdx.x) * kBinThreads * kBatch; base < n;
       base += step) {
    int key[kBatch], wkey[kBatch];
    float wt[kBatch];
    load_batch(base, tid, x, y, w, slot, slot0, n, n_slots, h, wd, e, win, key, wkey, wt);
    bool in_window = false;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) in_window = in_window || wkey[b] >= 0;
    if (!zeroed && __syncthreads_or(in_window)) {
      for (int j = tid; 4 * j < cells; j += kBinThreads)
        window4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncthreads();
      zeroed = true;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) add_hit(key[b], wkey[b], wt[b], lane, window, grid);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < kClusterBlocks) cluster.map_shared_rank(took, tid)[rank] = zeroed;
  cluster.sync();  // every window of the cluster is complete, and `took` too
  unsigned took_hits = 0u;  // bit r: block r's window took hits
  for (int r = 0; r < kClusterBlocks; ++r) took_hits |= (took[r] != 0 ? 1u : 0u) << r;
  if (took_hits == 0u) return;  // nothing to flush, and no block reads another
  const int chunk = (cells + kClusterBlocks - 1) / kClusterBlocks;
  const int lo = rank * chunk, hi = min(cells, lo + chunk);
  const int per_slot = rows * wd;
  for (int c = lo + tid; c < hi; c += kBinThreads) {
    float v = 0.0f;
    for (int r = 0; r < kClusterBlocks; ++r)
      if ((took_hits >> r) & 1u) v += cluster.map_shared_rank(window, r)[c];
    if (v != 0.0f) {
      const int s = c / per_slot;
      atomicAdd(grid + (s * h + win.row0) * wd + (c - s * per_slot), v);
    }
  }
  cluster.sync();  // no block leaves while another reads its window
}

// The scatter without a window: one thread a hit, one atomicAdd each into
// the grid in device memory.
__global__ void __launch_bounds__(kGlobalThreads)
grid_bin_global_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ w, const int32_t* __restrict__ slot, int slot0,
                       long long n, float* __restrict__ grid, int n_slots, int h, int wd,
                       float e) {
  const long long i = static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot != nullptr ? slot[i] : slot0;
  if (s < 0 || s >= n_slots) return;
  grid_add(grid, s, x[i], y[i], w[i], h, wd, e);
}

__global__ void __launch_bounds__(kGatherThreads)
grid_gather_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ y, const int32_t* __restrict__ slot, int slot0,
                   long long n, float* __restrict__ out, int n_slots, int h, int wd, float e) {
  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot != nullptr ? slot[i] : slot0;
  out[i] = (s < 0 || s >= n_slots)
               ? 0.0f
               : g[static_cast<size_t>(s) * h * wd + grid_cell(x[i], y[i], h, wd, e)];
}

}  // namespace

// Adds the n hits into the [n_slots, h, wd] grid (the caller zeroes it or
// passes a grid to accumulate into).  `slot` may be null: then every hit
// goes to slot0.  Launches on `stream`; returns a cudaError_t (0 on
// success): a launch the card refuses returns its error, and nothing falls
// back.
extern "C" int rtt_grid_bin(const float* x, const float* y, const float* w, const int32_t* slot,
                            int slot0, long long n, float* grid, int n_slots, int h, int wd,
                            float e, void* stream) {
  if (n <= 0) return 0;
  if (n_slots <= 0 || h <= 0 || wd <= 0 ||
      static_cast<long long>(n_slots) * h * wd > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = band_rows(n_slots, h, wd);
  if (rows == 0) {
    const long long blocks = (n + kGlobalThreads - 1) / kGlobalThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_bin_global_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, st>>>(
        x, y, w, slot, slot0, n, grid, n_slots, h, wd, e);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * static_cast<size_t>((n_slots * rows * wd + 3) / 4 * 4);
  int most = 0;
  const cudaError_t err = resident_clusters<kClusterBlocks>(
      grid_bin_kernel, kBinThreads, sizeof(float) * kMaxSliceCells, smem, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_cluster = static_cast<long long>(kClusterBlocks) * kBinThreads * kBatch;
  long long clusters = (n + per_cluster - 1) / per_cluster;
  if (clusters > most) clusters = most;
  return static_cast<int>(launch_clusters<kClusterBlocks>(grid_bin_kernel, clusters, kBinThreads,
                                                          smem, st, x, y, w, slot, slot0, n, grid,
                                                          n_slots, h, wd, e, rows));
}

// out[i] = g[slot_i, iy_i, ix_i] (0 for a slot outside 0..n_slots-1): the
// cotangent of each hit's weight.  Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int rtt_grid_gather(const float* g, const float* x, const float* y,
                               const int32_t* slot, int slot0, long long n, float* out,
                               int n_slots, int h, int wd, float e, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid_gather_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, x, y, slot, slot0, n, out,
                                                            n_slots, h, wd, e);
  return static_cast<int>(cudaGetLastError());
}
