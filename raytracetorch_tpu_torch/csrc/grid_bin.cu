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
// on Hopper the histogram is a scatter-add, one thread per hit, each an
// atomicAdd (a RED, its result unused) into the grid in device memory.
// Within the fused kernels K1 and K5 the same device function bins each
// sensor crossing as it is traced, so the hits never reach device memory.
//
// What bounds it: per hit it reads 12 B (16 B with a slot stream), so 1M
// hits are 12-16 MB, 4-5 us at the H100's 3.35 TB/s, plus one atomic.  A
// 256 x 256 float32 grid is 256 KB, above the 227 KB of shared memory a
// block can have, so a per-block histogram in shared memory does not fit at
// that size, and the atomics go to L2.  There, hits on one cell serialize:
// a focused spot (the bench scene puts 1M hits into roughly 1,500 cells, a
// few hundred per cell) makes contention, not bytes, the bound.
// Privatisation (per-block sub-grids of the busy region) and warp
// aggregation (__match_any_sync on the cell, one atomic per distinct cell
// per warp) are left to a later change.
//
// Numerics: float atomics add in an order that changes from run to run, so
// a cell's sum of non-integer weights may differ in its last bits between
// runs and from the plain version.  Unit weights (the sources of the main
// path) sum exactly up to 2^24 hits per cell, so their grid is exact and
// deterministic.  Zero weights are skipped (adding 0 changes nothing).

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"

using namespace rtt;

namespace {

constexpr int kBinThreads = 256;

__global__ void __launch_bounds__(kBinThreads)
grid_bin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const int32_t* __restrict__ slot, int slot0,
                long long n, float* __restrict__ grid, int n_slots, int h, int wd, float e) {
  const long long i = static_cast<long long>(blockIdx.x) * kBinThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot != nullptr ? slot[i] : slot0;
  if (s < 0 || s >= n_slots) return;
  grid_add(grid, s, x[i], y[i], w[i], h, wd, e);
}

__global__ void __launch_bounds__(kBinThreads)
grid_gather_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ y, const int32_t* __restrict__ slot, int slot0,
                   long long n, float* __restrict__ out, int n_slots, int h, int wd, float e) {
  const long long i = static_cast<long long>(blockIdx.x) * kBinThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot != nullptr ? slot[i] : slot0;
  out[i] = (s < 0 || s >= n_slots)
               ? 0.0f
               : g[static_cast<size_t>(s) * h * wd + grid_cell(x[i], y[i], h, wd, e)];
}

long long blocks_of(long long n) { return (n + kBinThreads - 1) / kBinThreads; }

}  // namespace

// Adds the n hits into the [n_slots, h, wd] grid (the caller zeroes it or
// passes a grid to accumulate into).  `slot` may be null: then every hit
// goes to slot0.  Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int rtt_grid_bin(const float* x, const float* y, const float* w, const int32_t* slot,
                            int slot0, long long n, float* grid, int n_slots, int h, int wd,
                            float e, void* stream) {
  if (n <= 0) return 0;
  if (blocks_of(n) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid_bin_kernel<<<static_cast<unsigned>(blocks_of(n)), kBinThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, y, w, slot, slot0, n, grid, n_slots,
                                                         h, wd, e);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = g[slot_i, iy_i, ix_i] (0 for a slot outside 0..n_slots-1): the
// cotangent of each hit's weight.  Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int rtt_grid_gather(const float* g, const float* x, const float* y,
                               const int32_t* slot, int slot0, long long n, float* out,
                               int n_slots, int h, int wd, float e, void* stream) {
  if (n <= 0) return 0;
  if (blocks_of(n) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid_gather_kernel<<<static_cast<unsigned>(blocks_of(n)), kBinThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, x, y, slot, slot0, n, out,
                                                            n_slots, h, wd, e);
  return static_cast<int>(cudaGetLastError());
}
