// Shared by the fused sequential kernels K1 (trace_seq_fwd.cu) and K2
// (trace_seq_bwd.cu): the flat-row layout, the constants of the trace
// engine, small vector helpers, the bound checks and the warp sum.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rtt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWidth = 160;
constexpr int kKindWidth = 8;
constexpr int kMoments = 7;

// Offsets of the float columns in a flat row (core/table.py ROW_FIELDS).
constexpr int kQ = 0, kNSign = 5, kRw = 6, kTw = 15, kRs = 18, kTs = 27;
constexpr int kSb = 30, kVb = 34, kPh = 42;

// Columns of a kinds row (ops/fused_trace.py::kind_rows).
constexpr int kPhCol = 0, kSbCol = 1, kVbCol = 2, kPlaneCol = 3;
constexpr int kSensorCol = 4, kSlotCol = 5, kInvertCol = 6;

// constants.py and geom/surfaces.py
constexpr float kBig = 1e30f;
constexpr float kIntersectEps = 1e-6f;
constexpr float kSolverEps = 1e-6f;
constexpr float kNormalEps = 1e-8f;
constexpr float kRelEps = 1e-5f;

enum PhysKind { TRANSMIT = 0, BLOCK = 1, REFLECT = 2, SNELL = 3, APERTURE = 6 };
enum SBKind { SB_NONE = 0, SB_DISK = 1, SB_HEMI = 4 };
enum VBKind { VB_NONE = 0, VB_APER_R2 = 1, VB_Z_BETWEEN = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// u + s * v
__device__ __forceinline__ V3 fma3(V3 u, float s, V3 v) {
  return {u.x + s * v.x, u.y + s * v.y, u.z + s * v.z};
}

// v @ R with R a row-major 3x3
__device__ __forceinline__ V3 rot(V3 v, const float* R) {
  return {v.x * R[0] + v.y * R[3] + v.z * R[6],
          v.x * R[1] + v.y * R[4] + v.z * R[7],
          v.x * R[2] + v.y * R[5] + v.z * R[8]};
}

// v @ R.T
__device__ __forceinline__ V3 rot_t(V3 v, const float* R) {
  return {v.x * R[0] + v.y * R[1] + v.z * R[2],
          v.x * R[3] + v.y * R[4] + v.z * R[5],
          v.x * R[6] + v.y * R[7] + v.z * R[8]};
}

__device__ __forceinline__ bool sb_check(int kind, const float* sb, V3 h) {
  if (kind == SB_DISK) {
    const float a = h.x - sb[1], b = h.y - sb[2];
    return a * a + b * b <= sb[0];
  }
  if (kind == SB_HEMI) return fabsf(h.z * sb[0]) < 1.0f + kIntersectEps;
  return true;
}

__device__ __forceinline__ bool vb_check(int kind, const float* vb, V3 h) {
  if (kind == VB_APER_R2) return h.x * h.x + h.y * h.y <= vb[0];
  if (kind == VB_Z_BETWEEN) return h.z >= vb[0] && h.z <= vb[1];
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rtt
