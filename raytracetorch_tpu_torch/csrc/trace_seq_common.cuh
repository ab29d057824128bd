// Shared by the fused kernels K1 (trace_seq_fwd.cu), K2 (trace_seq_bwd.cu),
// K5 (trace_nonseq_fwd.cu) and K6 (trace_nonseq_bwd.cu): the flat-row layout,
// the constants of the trace engine, small vector helpers, the bound checks,
// the warp sum, and one row's intersection, normal and physics as K1 and K5
// evaluate them.  The adjoints (trace_seq_adjoint.cuh) take their branch
// decisions from these same functions, through their optional outputs, so a
// backward never re-decides a branch in another copy of the arithmetic.
//
// Pixelated phase plates (PHASE_GRID rows) read their [H, W] maps through
// kernel K4's device functions (grid_corners.cuh).  The functions that can
// meet such a row, or a RECT bound, take a compile-time kPlates: a kernel
// instantiated with kPlates = false (a scene with neither) has no plate code
// at all, so it runs the instructions it ran before plates existed.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_corners.cuh"

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
constexpr int kMapCol = 7;  // a PHASE_GRID row's map (plate) index

// constants.py and geom/surfaces.py
constexpr float kBig = 1e30f;
constexpr float kIntersectEps = 1e-6f;
constexpr float kSolverEps = 1e-6f;
constexpr float kNormalEps = 1e-8f;
constexpr float kRelEps = 1e-5f;

enum PhysKind { TRANSMIT = 0, BLOCK = 1, REFLECT = 2, SNELL = 3, APERTURE = 6, PHASE_GRID = 15 };
enum SBKind { SB_NONE = 0, SB_DISK = 1, SB_RECT = 2, SB_HEMI = 4, SB_HEMI_APER = 5 };
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

// A surface bound.  The RECT bound (a phase plate's or a rectangular stop's)
// is plate code: only the kPlates instantiation tests it.
template <bool kPlates>
__device__ __forceinline__ bool sb_check(int kind, const float* sb, V3 h) {
  if (kind == SB_DISK) {
    const float a = h.x - sb[1], b = h.y - sb[2];
    return a * a + b * b <= sb[0];
  }
  if (kPlates && kind == SB_RECT) return fabsf(h.x) <= sb[0] && fabsf(h.y) <= sb[1];
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
  int ph, sb, vb, slot, map;
  bool plane, sensor, invert;
};

__device__ __forceinline__ RowKinds read_row_kinds(const int32_t* kd) {
  return {kd[kPhCol], kd[kSbCol], kd[kVbCol], kd[kSlotCol], kd[kMapCol], kd[kPlaneCol] != 0,
          kd[kSensorCol] != 0, kd[kInvertCol] != 0};
}

// One row's hit: the ray parameter t (0 where invalid), validity, the hit in
// the surface frame, and the branches the adjoint needs: which root is the
// minimum (both on a tie) and whether the quadric solver took its linear path.
struct RowHit {
  float t;
  bool valid;
  V3 hs;
  bool root1, root2, linear;
};

// Intersect a ray (world frame) with row r (core/intersect.py): plane fast
// path or the quadric solver, surface-local bound per root, the minimum
// positive root above the world-scale epsilon, then the volume bound.
template <bool kPlates>
__device__ __forceinline__ RowHit intersect_row(const float* r, const RowKinds& kd, V3 p, V3 d) {
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  const V3 o = rot(V3{p.x - r[kTw], p.y - r[kTw + 1], p.z - r[kTw + 2]}, Rw);
  const V3 ds = rot(d, Rw);
  float t1, t2;
  bool v1, v2, linear = false;
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
    linear = fabsf(A) < kSolverEps;
    const float A_safe = linear ? 1.0f : A;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    const float t_lin = -C / B_safe;
    t1 = linear ? t_lin : (-B - sq) / (2.0f * A_safe);
    t2 = linear ? t_lin : (-B + sq) / (2.0f * A_safe);
    v1 = (linear && fabsf(B) >= kSolverEps) || (!linear && hit);
    v2 = v1;
  }
  if (kd.sb != SB_NONE) {
    bool keep1 = sb_check<kPlates>(kd.sb, r + kSb, fma3(o, t1, ds));
    bool keep2 = sb_check<kPlates>(kd.sb, r + kSb, fma3(o, t2, ds));
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
  h.root1 = tm1 <= tm2;
  h.root2 = tm2 <= tm1;
  h.linear = linear;
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
// normal_world).  `degen_out`, when given, receives whether the quadric's
// gradient was degenerate (the normal then defaults to +z).
__device__ __forceinline__ V3 world_normal(const float* r, bool plane, V3 hs,
                                           bool* degen_out = nullptr) {
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  if (plane) return {Rw[2], Rw[5], Rw[8]};
  const float gx = 2.0f * q[0] * hs.x;
  const float gy = 2.0f * q[1] * hs.y;
  const float gz = 2.0f * q[2] * hs.z + q[3];
  const float g2 = gx * gx + gy * gy + gz * gz;
  const bool degen = g2 < kNormalEps * kNormalEps;
  if (degen_out != nullptr) *degen_out = degen;
  const float inv = (r[kNSign] < 0.0f ? -1.0f : 1.0f) / (sqrtf(degen ? 1.0f : g2) + kNormalEps);
  const V3 nl = degen ? V3{0.0f, 0.0f, 1.0f} : V3{gx * inv, gy * inv, gz * inv};
  return rot_t(nl, Rw);
}

// The phase maps of a scene's PHASE_GRID rows, and one ray's wavelength.
struct Plates {
  const float* maps;     // every map, row-major, one after the other
  const int32_t* desc;   // per map: its offset in maps, h, w
  float wl;              // the ray's wavelength in um (not > 0: unset)
};

// The bilinear patch of a PHASE_GRID row's map at a surface-frame hit
// (core/physics.py::phase_grid_dir): the cell coordinates u, v (clipped to
// [0, n - 1 - 1e-6], that bound rounded once to float32), the cell iu, iv
// they truncate to, the four corner cells (clamped into the map) and their
// values.
struct PlatePatch {
  const float* map;
  int h, w;
  float hx, hy, u, v, fu, fv;
  bool u_clip, v_clip;  // u, v was outside its range (no derivative)
  CornerCells cells;
  Corners g;
};

__device__ __forceinline__ float cell_clip(int n) {
  return __double2float_rn(static_cast<double>(n - 1) - 1e-6);
}

__device__ __forceinline__ PlatePatch plate_patch(const float* r, const Plates& pl, int map,
                                                  V3 hs) {
  PlatePatch pt;
  const int32_t* dsc = pl.desc + 3 * map;
  pt.map = pl.maps + dsc[0];
  pt.h = dsc[1];
  pt.w = dsc[2];
  pt.hx = r[kPh + 4];
  pt.hy = r[kPh + 5];
  const float u_raw = (hs.x + pt.hx) / (2.0f * pt.hx) * static_cast<float>(pt.w - 1);
  const float v_raw = (hs.y + pt.hy) / (2.0f * pt.hy) * static_cast<float>(pt.h - 1);
  const float u_max = cell_clip(pt.w), v_max = cell_clip(pt.h);
  pt.u_clip = !(u_raw >= 0.0f && u_raw <= u_max);
  pt.v_clip = !(v_raw >= 0.0f && v_raw <= v_max);
  pt.u = fminf(fmaxf(u_raw, 0.0f), u_max);  // NaN -> 0: no index leaves the map
  pt.v = fminf(fmaxf(v_raw, 0.0f), v_max);
  const int iu = static_cast<int>(pt.u), iv = static_cast<int>(pt.v);
  pt.fu = pt.u - static_cast<float>(iu);
  pt.fv = pt.v - static_cast<float>(iv);
  pt.cells = corner_cells(pt.h, pt.w, iv, iu);
  pt.g = read_corners(pt.map, pt.cells);
  return pt;
}

// The physics branches the adjoint needs (all false unless set below).
struct PhysBranch {
  bool from_in;   // SNELL, PHASE_GRID: d.n < 0
  bool dn_pos;    // SNELL: d.n > 0
  bool tir;       // SNELL: total internal reflection
  bool n2_small;  // SNELL: |n2| < 1e-12
  bool pass;      // APERTURE: the filter passes the ray
  bool pg_ok;     // PHASE_GRID: the kicked ray propagates (not evanescent)
  bool u_clip;    // PHASE_GRID: u was clipped
  bool v_clip;    // PHASE_GRID: v was clipped
};

// The row's physics (core/static_dispatch.py::apply_physics_one): the new
// direction nd and the intensity factor imod of a ray d meeting normal nw at
// surface-frame hit hs.  `br`, when given, receives the branches taken.  A
// PHASE_GRID row (kPlates only) reads map kd_map of `pl`.
template <bool kPlates>
__device__ __forceinline__ void apply_physics(const float* r, int ph, int sbk, int kd_map, V3 d,
                                              V3 nw, V3 hs, const Plates& pl, V3& nd, float& imod,
                                              PhysBranch* br = nullptr) {
  nd = d;
  imod = 1.0f;
  if (kPlates && ph == PHASE_GRID) {
    // core/physics.py::phase_grid_dir: n2 d_out_t = n1 d_in_t + m lam grad(phi)
    const bool from_in = dot3(d, nw) < 0.0f;
    const float n1 = from_in ? r[kPh] : r[kPh + 1];
    const float n2 = from_in ? r[kPh + 1] : r[kPh];
    const float* Rw = r + kRw;
    const V3 dl = rot(d, Rw);
    const float lam_mm = (pl.wl > 0.0f ? pl.wl : r[kPh + 3]) * 1e-3f;
    const PlatePatch pt = plate_patch(r, pl, kd_map, hs);
    const float su = static_cast<float>(pt.w - 1) / (2.0f * pt.hx);
    const float sv = static_cast<float>(pt.h - 1) / (2.0f * pt.hy);
    const float gx =
        ((1.0f - pt.fv) * (pt.g.g01 - pt.g.g00) + pt.fv * (pt.g.g11 - pt.g.g10)) * su;
    const float gy =
        ((1.0f - pt.fu) * (pt.g.g10 - pt.g.g00) + pt.fu * (pt.g.g11 - pt.g.g01)) * sv;
    const float kick = r[kPh + 2] * lam_mm;
    const float tx = n1 * dl.x + kick * gx;
    const float ty = n1 * dl.y + kick * gy;
    const float t2 = tx * tx + ty * ty;
    const float n2sq = n2 * n2;
    const bool ok = t2 < n2sq;
    const float tz = sqrtf(ok ? fmaxf(n2sq - t2, 0.0f) : 1.0f);
    const float zs = fabsf(dl.z) < 1e-12f ? 1.0f : dl.z;
    const float sign = zs > 0.0f ? 1.0f : (zs < 0.0f ? -1.0f : zs);
    const float inv = 1.0f / n2;
    nd = rot_t(V3{tx * inv, ty * inv, ok ? tz * sign * inv : dl.z}, Rw);
    imod = ok ? 1.0f : 0.0f;
    if (br != nullptr) {
      br->from_in = from_in;
      br->pg_ok = ok;
      br->u_clip = pt.u_clip;
      br->v_clip = pt.v_clip;
    }
  } else if (ph == BLOCK) {
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
    const bool n2_small = fabsf(n2) < 1e-12f;
    const float mu = n1 / (n2_small ? 1e-12f : n2);
    const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
    if (br != nullptr) {
      br->from_in = from_in;
      br->dn_pos = dn > 0.0f;
      br->tir = sin2_t > 1.0f;
      br->n2_small = n2_small;
    }
    if (sin2_t > 1.0f) {  // total internal reflection
      nd = fma3(d, -2.0f * dn, nw);
    } else {
      const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
      const float coef = (mu * cos_i - cos_t) * eff_sign;
      nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
    }
  } else if (ph == APERTURE) {
    // the filter re-checks its own RAW (non-inverted) bound
    const float mod = sb_check<kPlates>(sbk, r + kSb, hs) ? 1.0f : 0.0f;
    nd = {d.x * mod, d.y * mod, d.z * mod};
    imod = mod;
    if (br != nullptr) br->pass = mod != 0.0f;
  }
}

// One bounce of the non-sequential loop (core/trace.py::bounce_step), as K5
// runs it and K6 replays it: every row is intersected and the nearest valid
// row wins with a strict t < best_t (the first of equals wins); then the
// winner's normal and physics, and the move p += t d, d = the new direction,
// I *= the winner's factor.  Returns the winner row, or -1 when no row wins
// (nothing moves).  `hw` receives the winner's hit; `degen` and `br`, when
// given, the winner's branches.  The caller records a sensor winner.  Only
// the winner reads its phase map.
template <bool kPlates>
__device__ __forceinline__ int nonseq_bounce(const float* tab, const int32_t* knd, int n_rows,
                                             const Plates& pl, V3& p, V3& d, float& inten,
                                             RowHit& hw, bool* degen = nullptr,
                                             PhysBranch* br = nullptr) {
  float best_t = kBig;
  int k_win = -1;
  for (int k = 0; k < n_rows; ++k) {
    const RowHit h =
        intersect_row<kPlates>(tab + k * kRowWidth, read_row_kinds(knd + k * kKindWidth), p,
                               d);
    if (h.valid && h.t < best_t) {
      best_t = h.t;
      k_win = k;
      hw = h;
    }
  }
  if (k_win < 0) return -1;
  const float* r = tab + k_win * kRowWidth;
  const RowKinds kd = read_row_kinds(knd + k_win * kKindWidth);
  V3 nd;
  float imod;
  apply_physics<kPlates>(r, kd.ph, kd.sb, kd.map, d, world_normal(r, kd.plane, hw.hs, degen),
                         hw.hs, pl, nd, imod, br);
  p = fma3(p, best_t, d);
  d = nd;
  inten = inten * imod;
  return k_win;
}

}  // namespace rtt
