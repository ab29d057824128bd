// Phase-map corner reads for Hopper (sm_90a): the device functions of kernel
// K4, shared by its standalone launcher (grid_corners.cu) and by the fused
// kernels that trace pixelated phase plates: K1 (trace_seq_fwd.cu) and K5
// (trace_nonseq_fwd.cu) read the corners in apply_physics
// (trace_seq_common.cuh); K2 (trace_seq_bwd.cu) and K6 (trace_nonseq_bwd.cu)
// read them again and scatter their cotangents in row_backward
// (trace_seq_adjoint.cuh).  The design notes are in grid_corners.cu.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rtt {

// Flat offsets of the four corners of the bilinear patch at cell (iv, iu) of
// an h x w map: (iv, iu), (iv, iu + 1), (iv + 1, iu), (iv + 1, iu + 1), each
// index clamped into 0..h-1 and 0..w-1 as XLA's gather clamps (at the far
// rim iu + 1 == w reads column w - 1).
struct CornerCells {
  int c00, c01, c10, c11;
};

__device__ __forceinline__ int clamp_cell(int i, int n) { return min(max(i, 0), n - 1); }

// clamp(i + 1, 0, n - 1) without overflow at i = INT_MAX
__device__ __forceinline__ int clamp_next_cell(int i, int n) {
  return i >= n - 1 ? n - 1 : max(i + 1, 0);
}

__device__ __forceinline__ CornerCells corner_cells(int h, int w, int iv, int iu) {
  const int v0 = clamp_cell(iv, h) * w, v1 = clamp_next_cell(iv, h) * w;
  const int u0 = clamp_cell(iu, w), u1 = clamp_next_cell(iu, w);
  return {v0 + u0, v0 + u1, v1 + u0, v1 + u1};
}

struct Corners {
  float g00, g01, g10, g11;
};

// The four corner values, read through the read-only data path.  A map of
// up to 256 x 256 floats (256 KB) stays resident in the 50 MB L2.
__device__ __forceinline__ Corners read_corners(const float* map, const CornerCells& c) {
  return {__ldg(map + c.c00), __ldg(map + c.c01), __ldg(map + c.c10), __ldg(map + c.c11)};
}

// Add the four corner cotangents into the map's cotangent gmap at the cells
// they were read from (the transpose of read_corners).  Zeros are skipped.
__device__ __forceinline__ void scatter_corners(float* gmap, const CornerCells& c,
                                                const Corners& g) {
  if (g.g00 != 0.0f) atomicAdd(gmap + c.c00, g.g00);
  if (g.g01 != 0.0f) atomicAdd(gmap + c.c01, g.g01);
  if (g.g10 != 0.0f) atomicAdd(gmap + c.c10, g.g10);
  if (g.g11 != 0.0f) atomicAdd(gmap + c.c11, g.g11);
}

}  // namespace rtt
