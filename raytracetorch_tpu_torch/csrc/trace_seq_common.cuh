// Shared by the fused kernels K1 (trace_seq_fwd.cu), K2 (trace_seq_bwd.cu)
// and K5 (trace_nonseq_fwd.cu): the flat-row layout, the constants of the
// trace engine, small vector helpers, the bound checks, the warp sum, and one
// row's intersection, normal and physics as K1 and K5 evaluate them.

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
enum SBKind { SB_NONE = 0, SB_DISK = 1, SB_HEMI = 4, SB_HEMI_APER = 5 };
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
  if (kind == SB_HEMI_APER)
    return fabsf(h.z * sb[0]) < 1.0f + kIntersectEps && h.x * h.x + h.y * h.y <= sb[1];
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

// The kinds of one table row, read from its int32 kinds row.
struct RowKinds {
  int ph, sb, vb, slot;
  bool plane, sensor, invert;
};

__device__ __forceinline__ RowKinds read_row_kinds(const int32_t* kd) {
  return {kd[kPhCol], kd[kSbCol], kd[kVbCol], kd[kSlotCol], kd[kPlaneCol] != 0,
          kd[kSensorCol] != 0, kd[kInvertCol] != 0};
}

// One row's hit: the ray parameter t (0 where invalid), validity and the hit
// in the surface frame.
struct RowHit {
  float t;
  bool valid;
  V3 hs;
};

// Intersect a ray (world frame) with row r (core/intersect.py): plane fast
// path or the quadric solver, surface-local bound per root, the minimum
// positive root above the world-scale epsilon, then the volume bound.
__device__ __forceinline__ RowHit intersect_row(const float* r, const RowKinds& kd, V3 p, V3 d) {
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  const V3 o = rot(V3{p.x - r[kTw], p.y - r[kTw + 1], p.z - r[kTw + 2]}, Rw);
  const V3 ds = rot(d, Rw);
  float t1, t2;
  bool v1, v2;
  if (kd.plane) {
    // q = (0,0,0,-2,0): the solver's linear branch, t = 2 oz / B_safe
    const float B = -2.0f * ds.z;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    t1 = (2.0f * o.z) / B_safe;
    v1 = fabsf(B) >= kSolverEps;
    t2 = t1;
    v2 = false;
  } else {
    // geom/surfaces.py::solve_roots
    const float A = q[0] * ds.x * ds.x + q[1] * ds.y * ds.y + q[2] * ds.z * ds.z;
    const float B =
        2.0f * (q[0] * o.x * ds.x + q[1] * o.y * ds.y + q[2] * o.z * ds.z) + q[3] * ds.z;
    const float C = q[0] * o.x * o.x + q[1] * o.y * o.y + q[2] * o.z * o.z + q[3] * o.z + q[4];
    const float disc = B * B - 4.0f * A * C;
    const bool hit = disc >= 0.0f;
    const float sq = sqrtf((hit ? disc : 1.0f) + 1e-24f);
    const bool linear = fabsf(A) < kSolverEps;
    const float A_safe = linear ? 1.0f : A;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    const float t_lin = -C / B_safe;
    t1 = linear ? t_lin : (-B - sq) / (2.0f * A_safe);
    t2 = linear ? t_lin : (-B + sq) / (2.0f * A_safe);
    v1 = (linear && fabsf(B) >= kSolverEps) || (!linear && hit);
    v2 = v1;
  }
  if (kd.sb != SB_NONE) {
    bool keep1 = sb_check(kd.sb, r + kSb, fma3(o, t1, ds));
    bool keep2 = sb_check(kd.sb, r + kSb, fma3(o, t2, ds));
    if (kd.invert) {
      keep1 = !keep1;
      keep2 = !keep2;
    }
    v1 = v1 && keep1;
    v2 = v2 && keep2;
  }
  // geom/surfaces.py::min_positive with the world-scale epsilon
  const float scale = sqrtf(dot3(o, o) + dot3(p, p) + 1e-12f);
  const float eps = kIntersectEps + kRelEps * scale;
  const float tm1 = (v1 && t1 > eps) ? t1 : kBig;
  const float tm2 = (v2 && t2 > eps) ? t2 : kBig;
  const float t_best = fminf(tm1, tm2);
  RowHit h;
  h.valid = t_best < kBig * 0.5f;
  h.t = h.valid ? t_best : 0.0f;
  h.hs = fma3(o, h.t, ds);
  if (kd.vb != VB_NONE) {
    const V3 e = rot_t(h.hs, r + kRs);
    const V3 he = {e.x + r[kTs], e.y + r[kTs + 1], e.z + r[kTs + 2]};
    h.valid = h.valid && vb_check(kd.vb, r + kVb, he);
  }
  return h;
}

// World-frame unit normal at a surface-frame hit (core/intersect.py::
// normal_world).
__device__ __forceinline__ V3 world_normal(const float* r, bool plane, V3 hs) {
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  if (plane) return {Rw[2], Rw[5], Rw[8]};
  const float gx = 2.0f * q[0] * hs.x;
  const float gy = 2.0f * q[1] * hs.y;
  const float gz = 2.0f * q[2] * hs.z + q[3];
  const float g2 = gx * gx + gy * gy + gz * gz;
  const bool degen = g2 < kNormalEps * kNormalEps;
  const float inv = (r[kNSign] < 0.0f ? -1.0f : 1.0f) / (sqrtf(degen ? 1.0f : g2) + kNormalEps);
  const V3 nl = degen ? V3{0.0f, 0.0f, 1.0f} : V3{gx * inv, gy * inv, gz * inv};
  return rot_t(nl, Rw);
}

// The row's physics (core/static_dispatch.py::apply_physics_one): the new
// direction nd and the intensity factor imod of a ray d meeting normal nw at
// surface-frame hit hs.
__device__ __forceinline__ void apply_physics(const float* r, int ph, int sbk, V3 d, V3 nw, V3 hs,
                                              V3& nd, float& imod) {
  nd = d;
  imod = 1.0f;
  if (ph == BLOCK) {
    nd = {0.0f, 0.0f, 0.0f};
    imod = 0.0f;
  } else if (ph == REFLECT) {
    nd = fma3(d, -2.0f * dot3(d, nw), nw);
  } else if (ph == SNELL) {
    const float dn = dot3(d, nw);
    const bool from_in = dn < 0.0f;
    const float eff_sign = from_in ? 1.0f : -1.0f;
    const float cos_i = fabsf(dn);
    const float n1 = from_in ? r[kPh] : r[kPh + 1];
    const float n2 = from_in ? r[kPh + 1] : r[kPh];
    const float mu = n1 / (fabsf(n2) < 1e-12f ? 1e-12f : n2);
    const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
    if (sin2_t > 1.0f) {  // total internal reflection
      nd = fma3(d, -2.0f * dn, nw);
    } else {
      const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
      const float coef = (mu * cos_i - cos_t) * eff_sign;
      nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
    }
  } else if (ph == APERTURE) {
    // the filter re-checks its own RAW (non-inverted) bound
    const float mod = sb_check(sbk, r + kSb, hs) ? 1.0f : 0.0f;
    nd = {d.x * mod, d.y * mod, d.z * mod};
    imod = mod;
  }
}

}  // namespace rtt
