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

// Add two cotangents at flat cells a and b of an n-cell map, b == a or
// a + 1 (a row of the patch: columns u0 and u1 = u0 or u0 + 1).  Equal cells
// are summed in registers first.  Two cells of one 16-byte group go in one
// vector atomic (red.global.add.v4.f32: the L2 takes it as one operation),
// its other two lanes adding 0; a pair that straddles two groups, or whose
// group reaches past the map, takes two scalar atomics.  Zeros are skipped.
// The 16-byte groups are taken from the absolute address, so any float
// alignment of gmap is safe, and no lane outside cells 0..n-1 is touched.
__device__ __forceinline__ void scatter_pair(float* gmap, int n, int a, float ga, int b,
                                             float gb) {
  if (a == b) {
    ga += gb;
    if (ga != 0.0f) atomicAdd(gmap + a, ga);
    return;
  }
  if (ga == 0.0f && gb == 0.0f) return;
  const int q = static_cast<int>((reinterpret_cast<uintptr_t>(gmap + a) >> 2) & 3);
  if (q == 3 || a - q < 0 || a - q + 4 > n) {
    if (ga != 0.0f) atomicAdd(gmap + a, ga);
    if (gb != 0.0f) atomicAdd(gmap + b, gb);
    return;
  }
  const float4 v = make_float4(q == 0 ? ga : 0.0f, q == 0 ? gb : (q == 1 ? ga : 0.0f),
                               q == 1 ? gb : (q == 2 ? ga : 0.0f), q == 2 ? gb : 0.0f);
  atomicAdd(reinterpret_cast<float4*>(gmap + a - q), v);
}

// Add the four corner cotangents into the n-cell map cotangent gmap at the
// cells they were read from (the transpose of read_corners): one row pair
// at a time (scatter_pair), both rows summed first where they coincide (a
// cell clamped at the map's top or bottom rim).  About 2.5 L2 operations a
// cell instead of 4 scalar atomics.  Zeros are skipped.
__device__ __forceinline__ void scatter_corners(float* gmap, int n, const CornerCells& c,
                                                const Corners& g) {
  if (c.c10 == c.c00) {
    scatter_pair(gmap, n, c.c00, g.g00 + g.g10, c.c01, g.g01 + g.g11);
    return;
  }
  scatter_pair(gmap, n, c.c00, g.g00, c.c01, g.g01);
  scatter_pair(gmap, n, c.c10, g.g10, c.c11, g.g11);
}

}  // namespace rtt
