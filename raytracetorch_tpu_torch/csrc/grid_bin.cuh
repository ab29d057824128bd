// Irradiance-grid binning for Hopper (sm_90a): the device functions of
// kernel K3, shared by its standalone launcher (grid_bin.cu) and by the fused
// kernels that bin sensor hits as they trace (K1, trace_seq_fwd.cu; K5,
// trace_nonseq_fwd.cu) or read the grid's cotangent (K2, trace_seq_bwd.cu).
// The design notes are in grid_bin.cu.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rtt {

// The cell of a sensor-local coordinate v along an axis of n cells spanning
// [-e, e]: clip(trunc((v + e) / (2e) * n), 0, n - 1) (core/sensor.py::
// bin_indices).  The add, the division and the product are each rounded on
// their own (__fadd_rn, __fdiv_rn, __fmul_rn), so no fused multiply-add
// moves a bin edge away from the plain version's.  Truncation and clip run
// in float (NaN goes to cell 0), so no hit overflows an int.
__device__ __forceinline__ int grid_axis(float v, int n, float e) {
  const float f = __fmul_rn(__fdiv_rn(__fadd_rn(v, e), 2.0f * e), static_cast<float>(n));
  return static_cast<int>(fminf(fmaxf(truncf(f), 0.0f), static_cast<float>(n - 1)));
}

// Flat cell (iy * w + ix) of a sensor-local hit on an h x w grid spanning
// [-e, e]^2.
__device__ __forceinline__ int grid_cell(float x, float y, int h, int w, float e) {
  return grid_axis(y, h, e) * w + grid_axis(x, w, e);
}

// Add weight wt at the hit's cell of slot `slot` of the [S, h, w] grid in
// device memory.  A zero weight adds nothing and is skipped.
__device__ __forceinline__ void grid_add(float* grid, int slot, float x, float y, float wt, int h,
                                         int w, float e) {
  if (wt != 0.0f)
    atomicAdd(grid + static_cast<size_t>(slot) * h * w + grid_cell(x, y, h, w, e), wt);
}

}  // namespace rtt
