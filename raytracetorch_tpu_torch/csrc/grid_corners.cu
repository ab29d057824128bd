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
// 256 KB and stays in the 50 MB L2, so no size cap is carried over and no
// copy into shared memory (227 KB at most) is made.  Out-of-range indices
// clamp, as XLA's gather in the reference's eager trace does; the one-hot
// reads of the TPU kernel give 0 there instead (ROADMAP Queue 3).  The
// transpose is a scatter-add: one atomicAdd (a RED) per nonzero corner
// cotangent into the cotangent map in device memory.  Within the fused
// kernels K1, K2, K5 and K6 the same device functions read and scatter as
// they trace, so the indices never reach device memory.
//
// What bounds it: per cell it reads 8 B of indices and writes 16 B of
// corners (the backward reads 16 B of cotangents and 8 B of indices), plus
// the map once: 24 MB at 1M cells, ~7 us at the H100's 3.35 TB/s.  The
// gather's reads hit L2.  The scatter's atomics on a smooth, well-lit map
// spread over many cells; rays that land in one cell serialize there (1M
// rays on a 32 x 32 map put ~1,000 on each lit cell), so on small maps
// contention, not bytes, bounds it.  Warp aggregation of the atomics is left
// to a later change.
//
// Numerics: the gather is exact.  Float atomics add in an order that changes
// from run to run, so a cell's sum may differ in its last bits between runs
// and from the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_corners.cuh"

using namespace rtt;

namespace {

constexpr int kCornerThreads = 256;

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

__global__ void __launch_bounds__(kCornerThreads)
grid_corners_bwd_kernel(const float* __restrict__ g00, const float* __restrict__ g01,
                        const float* __restrict__ g10, const float* __restrict__ g11,
                        const int32_t* __restrict__ iv, const int32_t* __restrict__ iu,
                        long long n, float* __restrict__ gmap, int h, int w) {
  const long long i = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
  if (i >= n) return;
  const Corners g = {g00 ? g00[i] : 0.0f, g01 ? g01[i] : 0.0f, g10 ? g10[i] : 0.0f,
                     g11 ? g11[i] : 0.0f};
  scatter_corners(gmap, corner_cells(h, w, iv[i], iu[i]), g);
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
// to accumulate into).  Launches on `stream`; returns a cudaError_t.
extern "C" int rtt_grid_corners_bwd(const float* g00, const float* g01, const float* g10,
                                    const float* g11, const int32_t* iv, const int32_t* iu,
                                    long long n, float* gmap, int h, int w, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_of(n) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid_corners_bwd_kernel<<<static_cast<unsigned>(blocks_of(n)), kCornerThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g00, g01, g10, g11, iv, iu, n,
                                                                 gmap, h, w);
  return static_cast<int>(cudaGetLastError());
}
