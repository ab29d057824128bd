// The adjoint shared by K2 (trace_seq_bwd.cu) and K6 (trace_nonseq_bwd.cu):
// one row's forward step with its branch bits, one row's vector-Jacobian
// product, the table-cotangent columns and their per-warp reduction.  A
// PHASE_GRID row's adjoint (the hand-written transpose of core/physics.py::
// phase_grid_dir) scatters its four corner cotangents into the map's
// cotangent with kernel K4's device function (grid_corners.cuh).
//
// Both backward kernels replay their forward and save each applied row's
// input state and branch bits; the reverse sweep takes the saved branches and
// never re-decides one from a re-rounded state.  The bits come from the
// functions K1 and K5 run (trace_seq_common.cuh: intersect_row, world_normal,
// apply_physics, through their optional branch outputs), so a replay reaches
// the forward's state bit for bit and its bits belong to the branch the
// forward took.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

namespace rtt {

// Table columns with a nonzero cotangent, in the order of the partials
// buffer (ops/fused_trace.py GRAD_COLS): q[0:5], Rw[0:9], tw[0:3], ph[0:2];
// with phase plates (PLATE_GRAD_COLS) also ph[2:6]: the order, the design
// wavelength and the half extents of a PHASE_GRID row.
constexpr int kGradCols = 19;
constexpr int kPlateGradCols = 23;
constexpr int kGQ = 0, kGRw = 5, kGTw = 14, kGPh = 17;

template <bool kPlates>
__host__ __device__ constexpr int grad_cols() {
  return kPlates ? kPlateGradCols : kGradCols;
}

// Branch decisions of one row, saved by the forward replay.
constexpr uint32_t kActive = 1u << 0;   // valid && intensity > 0
constexpr uint32_t kRoot1 = 1u << 1;    // root 1 is the minimum
constexpr uint32_t kRoot2 = 1u << 2;    // root 2 is the minimum (both: tie)
constexpr uint32_t kLinear = 1u << 3;   // |A| < SOLVER_EPS
constexpr uint32_t kDegen = 1u << 4;    // degenerate normal gradient
constexpr uint32_t kFromIn = 1u << 5;   // d.n < 0
constexpr uint32_t kDnPos = 1u << 6;    // d.n > 0
constexpr uint32_t kTir = 1u << 7;      // total internal reflection
constexpr uint32_t kN2Small = 1u << 8;  // |n2| < 1e-12
constexpr uint32_t kMod = 1u << 9;      // APERTURE passes the ray
constexpr uint32_t kPgOk = 1u << 10;    // PHASE_GRID: not evanescent
constexpr uint32_t kUClip = 1u << 11;   // PHASE_GRID: u clipped
constexpr uint32_t kVClip = 1u << 12;   // PHASE_GRID: v clipped

// The grid's cotangent g[S, h, w] over [-e, e]^2 (g null: no grid, or a
// zero cotangent).
struct GridCt {
  const float* g;
  int h, w;
  float e;
};

// The physics reads the normal's value: REFLECT and SNELL (and, for the
// side d.n < 0 alone, PHASE_GRID, whose adjoint takes that side from its
// bits and gives the normal no cotangent).
__device__ __forceinline__ bool uses_normal(int ph) { return ph == REFLECT || ph == SNELL; }

// The bits of a row's branches, from the hit, the normal's degeneracy and the
// physics branches (without kActive).
__device__ __forceinline__ uint32_t branch_bits(const RowHit& h, bool degen,
                                                const PhysBranch& br) {
  return (h.root1 ? kRoot1 : 0u) | (h.root2 ? kRoot2 : 0u) | (h.linear ? kLinear : 0u) |
         (degen ? kDegen : 0u) | (br.from_in ? kFromIn : 0u) | (br.dn_pos ? kDnPos : 0u) |
         (br.tir ? kTir : 0u) | (br.n2_small ? kN2Small : 0u) | (br.pass ? kMod : 0u) |
         (br.pg_ok ? kPgOk : 0u) | (br.u_clip ? kUClip : 0u) | (br.v_clip ? kVClip : 0u);
}

// One row of K1's chain: updates (p, d, inten) where the row is active and
// returns the row's bits.
template <bool kPlates>
__device__ __forceinline__ uint32_t row_forward(const float* r, const RowKinds& kd,
                                                const Plates& pl, V3& p, V3& d, float& inten) {
  const RowHit h = intersect_row<kPlates>(r, kd, p, d);
  bool degen = false;
  const V3 nw = uses_normal(kd.ph) || (kPlates && kd.ph == PHASE_GRID)
                    ? world_normal(r, kd.plane, h.hs, &degen)
                    : V3{0.0f, 0.0f, 1.0f};
  PhysBranch br = {};
  V3 nd;
  float imod;
  apply_physics<kPlates>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, &br);
  uint32_t bits = branch_bits(h, degen, br);
  if (h.valid && inten > 0.0f) {
    bits |= kActive;
    p = fma3(p, h.t, d);
    d = nd;
    inten = inten * imod;
  }
  return bits;
}

// Adjoint of a PHASE_GRID row's physics (core/physics.py::phase_grid_dir)
// at surface-frame hit hs: g_nd, the cotangent of the new direction, adds
// the cotangents of the incoming direction d (g_d), of the hit's x and y
// (g_hs), and of the row's Rw and ph[0:6] (tg); the four corner cotangents
// are added into gmaps (the maps' cotangent, laid out as pl.maps; null: not
// wanted).  The sides (from_in), the evanescence and the clips come from the
// row's bits; the cell is recomputed from the re-derived hit.
__device__ __forceinline__ void phase_grid_backward(const float* r, const RowKinds& kd,
                                                    const Plates& pl, float* gmaps, V3 d, V3 hs,
                                                    uint32_t bits, V3 g_nd, V3& g_d, V3& g_hs,
                                                    float* tg) {
  const float* Rw = r + kRw;
  // ---- the forward's values ----
  const bool from_in = bits & kFromIn, ok = bits & kPgOk;
  const float n1 = from_in ? r[kPh] : r[kPh + 1];
  const float n2 = from_in ? r[kPh + 1] : r[kPh];
  const V3 dl = rot(d, Rw);
  const bool use_lam0 = !(pl.wl > 0.0f);
  const float lam_mm = (use_lam0 ? r[kPh + 3] : pl.wl) * 1e-3f;
  const float order = r[kPh + 2];
  const PlatePatch pt = plate_patch(r, pl, kd.map, hs);
  const Corners& c = pt.g;
  const float wm1 = static_cast<float>(pt.w - 1), hm1 = static_cast<float>(pt.h - 1);
  const float su = wm1 / (2.0f * pt.hx), sv = hm1 / (2.0f * pt.hy);
  const float P = (1.0f - pt.fv) * (c.g01 - c.g00) + pt.fv * (c.g11 - c.g10);
  const float Q = (1.0f - pt.fu) * (c.g10 - c.g00) + pt.fu * (c.g11 - c.g01);
  const float gx = P * su, gy = Q * sv;
  const float kick = order * lam_mm;
  const float tx = n1 * dl.x + kick * gx;
  const float ty = n1 * dl.y + kick * gy;
  const float n2sq = n2 * n2;
  const float tz = sqrtf(ok ? fmaxf(n2sq - (tx * tx + ty * ty), 0.0f) : 1.0f);
  const float zs = fabsf(dl.z) < 1e-12f ? 1.0f : dl.z;
  const float sign = zs > 0.0f ? 1.0f : (zs < 0.0f ? -1.0f : zs);
  const float inv = 1.0f / n2;
  const float ol[3] = {tx * inv, ty * inv, ok ? tz * sign * inv : dl.z};

  // ---- nd = ol @ Rw.T ----
  const V3 g_ol = rot(g_nd, Rw);
  const float gnd[3] = {g_nd.x, g_nd.y, g_nd.z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += gnd[i] * ol[j];
  // ---- ol = (tx inv, ty inv, ok ? tz sign inv : dl.z) ----
  float g_inv = g_ol.x * tx + g_ol.y * ty;
  float g_tx = g_ol.x * inv, g_ty = g_ol.y * inv;
  V3 g_dl = {0.0f, 0.0f, 0.0f};
  float g_n2sq = 0.0f;
  if (ok) {
    // tz = sqrt(n2^2 - t2), t2 = tx^2 + ty^2
    g_inv += g_ol.z * tz * sign;
    const float g_s = g_ol.z * sign * inv / (2.0f * tz);
    g_n2sq = g_s;
    g_tx -= 2.0f * tx * g_s;
    g_ty -= 2.0f * ty * g_s;
  } else {
    g_dl.z = g_ol.z;
  }
  const float g_n2 = -(g_inv * inv * inv) + 2.0f * n2 * g_n2sq;
  // ---- tx = n1 dl.x + kick gx, ty = n1 dl.y + kick gy ----
  const float g_n1 = g_tx * dl.x + g_ty * dl.y;
  g_dl.x += g_tx * n1;
  g_dl.y += g_ty * n1;
  const float g_kick = g_tx * gx + g_ty * gy;
  const float g_gx = g_tx * kick, g_gy = g_ty * kick;
  // ---- kick = order lam_mm, lam_mm = (wl > 0 ? wl : lam0) 1e-3 ----
  tg[kGPh + 2] += g_kick * lam_mm;
  if (use_lam0) tg[kGPh + 3] += g_kick * order * 1e-3f;
  // ---- gx = P su, gy = Q sv, the bilinear patch ----
  const float g_P = g_gx * su, g_Q = g_gy * sv;
  const float g_su = g_gx * P, g_sv = g_gy * Q;
  const float g_fv = g_P * ((c.g11 - c.g10) - (c.g01 - c.g00));
  const float g_fu = g_Q * ((c.g11 - c.g01) - (c.g10 - c.g00));
  if (gmaps != nullptr) {
    const Corners gc = {-g_P * (1.0f - pt.fv) - g_Q * (1.0f - pt.fu),
                        g_P * (1.0f - pt.fv) - g_Q * pt.fu,
                        -g_P * pt.fv + g_Q * (1.0f - pt.fu), g_P * pt.fv + g_Q * pt.fu};
    scatter_corners(gmaps + (pt.map - pl.maps), pt.cells, gc);
  }
  // ---- su = (w - 1) / (2 hx), sv = (h - 1) / (2 hy) ----
  float g_hx = -(g_su * su / pt.hx), g_hy = -(g_sv * sv / pt.hy);
  // ---- f = clip(c) - trunc(clip(c)), c = (x + hx) / (2 hx) (w - 1) ----
  if (!(bits & kUClip)) {
    const float den = 2.0f * pt.hx, a = (hs.x + pt.hx) / den;
    const float g_num = g_fu * wm1 / den;
    g_hs.x += g_num;
    g_hx += g_num - 2.0f * (g_fu * wm1 * a / den);
  }
  if (!(bits & kVClip)) {
    const float den = 2.0f * pt.hy, a = (hs.y + pt.hy) / den;
    const float g_num = g_fv * hm1 / den;
    g_hs.y += g_num;
    g_hy += g_num - 2.0f * (g_fv * hm1 * a / den);
  }
  tg[kGPh + 4] += g_hx;
  tg[kGPh + 5] += g_hy;
  // ---- n1, n2 by side ----
  tg[kGPh] += from_in ? g_n1 : g_n2;
  tg[kGPh + 1] += from_in ? g_n2 : g_n1;
  // ---- dl = d @ Rw ----
  g_d = fma3(g_d, 1.0f, rot_t(g_dl, Rw));
  const float dv[3] = {d.x, d.y, d.z}, gdl[3] = {g_dl.x, g_dl.y, g_dl.z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += dv[i] * gdl[j];
}

// Adjoint of one row.  (p, d, inten) is the row's saved input state and
// (gp, gd, gi) the cotangent of its output state, replaced by the cotangent
// of its input state; tg[grad_cols<kPlates>()] receives the row's table
// cotangent.  gm is the [S, B, 7] moment cotangent and gg the grid's; a
// PHASE_GRID row (kPlates only) reads its map from pl and adds its corner
// cotangents into gmaps (null: not wanted).
template <bool kPlates>
__device__ __forceinline__ void row_backward(const float* r, const RowKinds& kd, V3 p, V3 d,
                                             float inten, uint32_t bits, int rid,
                                             const float* gm, int n_bundles, const GridCt& gg,
                                             const Plates& pl, float* gmaps, V3& gp, V3& gd,
                                             float& gi, float* tg) {
  if (!(bits & kActive)) return;  // where(active, new, old) passes through
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  const bool r1 = bits & kRoot1, r2 = bits & kRoot2;

  // ---- the row's forward values, with the saved branches ----
  // An active row is valid: its |B| >= SOLVER_EPS on the linear and plane
  // paths and disc >= 0 on the quadratic path, so B_safe = B and the sqrt
  // takes disc.
  const V3 a = {p.x - r[kTw], p.y - r[kTw + 1], p.z - r[kTw + 2]};
  const V3 o = rot(a, Rw);
  const V3 ds = rot(d, Rw);
  const bool linear = bits & kLinear;
  float A = 0.0f, B = 0.0f, C = 0.0f, sq = 1.0f, t1, t2;
  if (kd.plane) {
    B = -2.0f * ds.z;
    t1 = (2.0f * o.z) / B;
    t2 = t1;
  } else {
    A = q[0] * ds.x * ds.x + q[1] * ds.y * ds.y + q[2] * ds.z * ds.z;
    B = 2.0f * (q[0] * o.x * ds.x + q[1] * o.y * ds.y + q[2] * o.z * ds.z) + q[3] * ds.z;
    C = q[0] * o.x * o.x + q[1] * o.y * o.y + q[2] * o.z * o.z + q[3] * o.z + q[4];
    if (linear) {
      t1 = -C / B;
      t2 = t1;
    } else {
      // the forward saw disc >= 0; a re-rounded disc stays clamped there
      sq = sqrtf(fmaxf(B * B - 4.0f * A * C, 0.0f) + 1e-24f);
      t1 = (-B - sq) / (2.0f * A);
      t2 = (-B + sq) / (2.0f * A);
    }
  }
  const float t = r1 ? t1 : t2;
  const V3 hs = fma3(o, t, ds);

  const bool need_normal = uses_normal(kd.ph);
  const bool degen = bits & kDegen;
  V3 nw = {0.0f, 0.0f, 1.0f}, nl = {0.0f, 0.0f, 1.0f}, gv = {0.0f, 0.0f, 0.0f};
  float root_g2 = 1.0f, den = 1.0f, inv = 0.0f;
  if (need_normal) {
    if (kd.plane) {
      nw = {Rw[2], Rw[5], Rw[8]};
    } else {
      gv = {2.0f * q[0] * hs.x, 2.0f * q[1] * hs.y, 2.0f * q[2] * hs.z + q[3]};
      if (!degen) {
        root_g2 = sqrtf(dot3(gv, gv));
        den = root_g2 + kNormalEps;
        inv = (r[kNSign] < 0.0f ? -1.0f : 1.0f) / den;
        nl = {gv.x * inv, gv.y * inv, gv.z * inv};
      }
      nw = rot_t(nl, Rw);
    }
  }

  // ---- masked update: p' = p + t d, d' = nd, I' = I * imod ----
  const float imod = kd.ph == BLOCK || (kd.ph == APERTURE && !(bits & kMod)) ||
                             (kPlates && kd.ph == PHASE_GRID && !(bits & kPgOk))
                         ? 0.0f
                         : 1.0f;
  float g_t = dot3(gp, d);
  V3 g_d = {t * gp.x, t * gp.y, t * gp.z};
  const V3 g_nd = gd;
  float g_i = gi * imod;
  V3 g_hs = {0.0f, 0.0f, 0.0f};

  // ---- sensor moments of the incoming intensity (w = I) ----
  if (kd.sensor && rid >= 0 && rid < n_bundles) {
    const float* g = gm + (kd.slot * n_bundles + rid) * kMoments;
    const float w = inten, x = hs.x, y = hs.y;
    g_i += g[0] + g[1] * x + g[2] * y + g[3] * x * x + g[4] * y * y + g[5] * x * y;
    g_hs.x += g[1] * w + 2.0f * g[3] * w * x + g[5] * w * y;
    g_hs.y += g[2] * w + 2.0f * g[4] * w * y + g[5] * w * x;
  }
  // ---- sensor grid: the gather of _grid_partial_g_bwd, d grid[s, iy, ix] /
  // d w = 1 with w = I; the bins have no derivative in x or y ----
  if (kd.sensor && gg.g != nullptr)
    g_i += gg.g[static_cast<size_t>(kd.slot) * gg.h * gg.w +
                grid_cell(hs.x, hs.y, gg.h, gg.w, gg.e)];

  // ---- physics ----
  V3 g_nw = {0.0f, 0.0f, 0.0f};
  if (kPlates && kd.ph == PHASE_GRID) {
    phase_grid_backward(r, kd, pl, gmaps, d, hs, bits, g_nd, g_d, g_hs, tg);
  } else if (kd.ph == TRANSMIT) {
    g_d = fma3(g_d, 1.0f, g_nd);
  } else if (kd.ph == APERTURE) {
    if (bits & kMod) g_d = fma3(g_d, 1.0f, g_nd);
  } else if (kd.ph == REFLECT || (kd.ph == SNELL && (bits & kTir))) {
    // nd = d - 2 (d.n) n
    const float s = dot3(d, nw);
    const float g_s = -2.0f * dot3(g_nd, nw);
    g_d = fma3(g_d, 1.0f, g_nd);
    g_d = fma3(g_d, g_s, nw);
    g_nw = fma3(g_nw, -2.0f * s, g_nd);
    g_nw = fma3(g_nw, g_s, d);
  } else if (kd.ph == SNELL) {
    // nd = mu d + coef n, coef = (mu cos_i - cos_t) eff_sign
    const bool from_in = bits & kFromIn;
    const float dn = dot3(d, nw);
    const float eff_sign = from_in ? 1.0f : -1.0f;
    const float cos_i = fabsf(dn);
    const float n1 = from_in ? r[kPh] : r[kPh + 1];
    const float n2 = from_in ? r[kPh + 1] : r[kPh];
    const bool n2_small = bits & kN2Small;
    const float n2_safe = n2_small ? 1e-12f : n2;
    const float mu = n1 / n2_safe;
    const float one_m_c2 = 1.0f - cos_i * cos_i;
    const float sin2_t = mu * mu * one_m_c2;
    const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
    const float coef = (mu * cos_i - cos_t) * eff_sign;

    float g_mu = dot3(g_nd, d);
    g_d = fma3(g_d, mu, g_nd);
    const float g_coef = dot3(g_nd, nw);
    g_nw = fma3(g_nw, coef, g_nd);
    g_mu += g_coef * eff_sign * cos_i;
    float g_cos_i = g_coef * eff_sign * mu;
    const float g_cos_t = -g_coef * eff_sign;
    const float g_sin2 = -(g_cos_t / (2.0f * cos_t));
    g_mu += g_sin2 * 2.0f * mu * one_m_c2;
    g_cos_i += g_sin2 * mu * mu * (-2.0f * cos_i);
    const float sgn = from_in ? -1.0f : ((bits & kDnPos) ? 1.0f : 0.0f);
    const float g_dn = g_cos_i * sgn;
    const float g_n1 = g_mu / n2_safe;
    const float g_n2 = n2_small ? 0.0f : -(g_mu * mu / n2_safe);
    tg[kGPh] += from_in ? g_n1 : g_n2;
    tg[kGPh + 1] += from_in ? g_n2 : g_n1;
    g_d = fma3(g_d, g_dn, nw);
    g_nw = fma3(g_nw, g_dn, d);
  }

  // ---- normal ----
  if (need_normal) {
    if (kd.plane) {
      tg[kGRw + 2] += g_nw.x;
      tg[kGRw + 5] += g_nw.y;
      tg[kGRw + 8] += g_nw.z;
    } else {
      // nw = nl @ Rw.T
      const V3 g_nl = rot(g_nw, Rw);
      const float gnw[3] = {g_nw.x, g_nw.y, g_nw.z};
      const float nlv[3] = {nl.x, nl.y, nl.z};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += gnw[i] * nlv[j];
      if (!degen) {
        // nl = gv * inv, inv = sign / (sqrt(|gv|^2) + NORMAL_EPS)
        const float g_inv = dot3(g_nl, gv);
        const float g_den = -(g_inv * inv / den);
        const float g_g2 = g_den / (2.0f * root_g2);
        const V3 g_gv = {g_nl.x * inv + 2.0f * g_g2 * gv.x, g_nl.y * inv + 2.0f * g_g2 * gv.y,
                         g_nl.z * inv + 2.0f * g_g2 * gv.z};
        tg[kGQ + 0] += 2.0f * hs.x * g_gv.x;
        tg[kGQ + 1] += 2.0f * hs.y * g_gv.y;
        tg[kGQ + 2] += 2.0f * hs.z * g_gv.z;
        tg[kGQ + 3] += g_gv.z;
        g_hs.x += 2.0f * q[0] * g_gv.x;
        g_hs.y += 2.0f * q[1] * g_gv.y;
        g_hs.z += 2.0f * q[2] * g_gv.z;
      }
    }
  }

  // ---- intersection: hs = o + t ds, t the root taken ----
  g_t += dot3(g_hs, ds);
  V3 g_o = g_hs;
  V3 g_ds = {t * g_hs.x, t * g_hs.y, t * g_hs.z};
  if (kd.plane) {
    // t = 2 o.z / B, B = -2 ds.z
    g_o.z += 2.0f * g_t / B;
    const float g_B = -(g_t * t1 / B);
    g_ds.z += -2.0f * g_B;
  } else {
    // a tie (both roots minimal) splits the cotangent as torch.minimum does
    const float g_t1 = r1 ? (r2 ? 0.5f * g_t : g_t) : 0.0f;
    const float g_t2 = r2 ? (r1 ? 0.5f * g_t : g_t) : 0.0f;
    float g_A = 0.0f, g_B, g_C = 0.0f;
    if (linear) {
      // t = -C / B
      const float g_tl = g_t1 + g_t2;
      g_C = -(g_tl / B);
      g_B = -(g_tl * t1 / B);
    } else {
      // t1,2 = (-B -+ sq) / (2A), sq = sqrt(B^2 - 4AC + 1e-24)
      g_B = -((g_t1 + g_t2) / (2.0f * A));
      const float g_sq = (g_t2 - g_t1) / (2.0f * A);
      g_A = -((g_t1 * t1 + g_t2 * t2) / A);
      const float g_disc = g_sq / (2.0f * sq);
      g_B += 2.0f * B * g_disc;
      g_A += -4.0f * C * g_disc;
      g_C += -4.0f * A * g_disc;
    }
    // A, B, C of (q, o, ds)
    tg[kGQ + 0] += g_A * ds.x * ds.x + 2.0f * g_B * o.x * ds.x + g_C * o.x * o.x;
    tg[kGQ + 1] += g_A * ds.y * ds.y + 2.0f * g_B * o.y * ds.y + g_C * o.y * o.y;
    tg[kGQ + 2] += g_A * ds.z * ds.z + 2.0f * g_B * o.z * ds.z + g_C * o.z * o.z;
    tg[kGQ + 3] += g_B * ds.z + g_C * o.z;
    tg[kGQ + 4] += g_C;
    g_ds.x += 2.0f * q[0] * (g_A * ds.x + g_B * o.x);
    g_ds.y += 2.0f * q[1] * (g_A * ds.y + g_B * o.y);
    g_ds.z += 2.0f * q[2] * (g_A * ds.z + g_B * o.z) + g_B * q[3];
    g_o.x += 2.0f * q[0] * (g_B * ds.x + g_C * o.x);
    g_o.y += 2.0f * q[1] * (g_B * ds.y + g_C * o.y);
    g_o.z += 2.0f * q[2] * (g_B * ds.z + g_C * o.z) + g_C * q[3];
  }

  // ---- world -> surface frame: o = (p - tw) @ Rw, ds = d @ Rw ----
  const V3 g_a = rot_t(g_o, Rw);
  const float av[3] = {a.x, a.y, a.z}, dv[3] = {d.x, d.y, d.z};
  const float gov[3] = {g_o.x, g_o.y, g_o.z}, gdsv[3] = {g_ds.x, g_ds.y, g_ds.z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += av[i] * gov[j] + dv[i] * gdsv[j];
  tg[kGTw + 0] -= g_a.x;
  tg[kGTw + 1] -= g_a.y;
  tg[kGTw + 2] -= g_a.z;
  gp = fma3(gp, 1.0f, g_a);
  gd = fma3(g_d, 1.0f, rot_t(g_ds, Rw));
  gi = g_i;
}

// Reduce one row's table cotangent over the lanes of a warp and add it into
// this warp's slot for the row (lane 0 writes); every lane of the warp calls
// it, each with its own tg (zeros for a lane that did not apply the row).
// Columns that are structurally zero for the row's kinds skip their
// shuffles: q on the plane path, ph[0:2] off the SNELL and PHASE_GRID paths,
// ph[2:6] off the PHASE_GRID path.
template <bool kPlates>
__device__ __forceinline__ void reduce_row(const RowKinds& kd, const float* tg, float* slot,
                                           int lane) {
  const bool plate = kPlates && kd.ph == PHASE_GRID;
#pragma unroll
  for (int c = 0; c < grad_cols<kPlates>(); ++c) {
    if (c < kGRw && kd.plane) continue;
    if (c >= kGPh && c < kGPh + 2 && kd.ph != SNELL && !plate) continue;
    if (c >= kGPh + 2 && !plate) continue;
    const float s = warp_sum(tg[c]);
    if (lane == 0) slot[c] += s;
  }
}

}  // namespace rtt
