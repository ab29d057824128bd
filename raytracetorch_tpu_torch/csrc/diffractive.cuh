// The diffractive and ideal elements for the fused kernels' instantiation
// with them (kDiff): the direction maps of LINEAR, GRATING, MLA and DOE rows
// in a row's surface frame, the kinoform efficiency, the ELLIPSE bound, and
// the adjoint of each map.
//
// The plain versions are core/physics.py (linear_dir, grating_dir, mla_dir,
// doe_dir, kinoform_efficiency) and core/static_dispatch.py::sb_check_one,
// themselves the JAX package's core/physics.py and core/static_dispatch.py.
// The arithmetic follows them line by line, in their order, with every clamp
// they have: 1e-12 on a grating's period and on |d_z|, 1e-9 on a lenslet
// pitch, the `where(ok, ..., 1)` inside each square root, sign(where(|d_z| <
// 1e-12, 1, d_z)) and the efficiency's `safe` select.  An evanescent order
// (ok false) keeps the incoming local d_z: its direction is not of unit
// length, and the caller zeroes its intensity.
//
// Each map takes the direction already rotated into the surface frame (dl =
// d @ Rw) and returns the surface-frame direction (ol, rotated back by the
// caller: nd = ol @ Rw.T); its adjoint takes ol's cotangent and adds those
// of dl, of the surface-frame hit's x and y and of the row's parameters.
// Every derivative is autograd's of the plain version: a select passes its
// cotangent to the branch it took, torch.clamp passes it at and above its
// bound, a floor and a sign pass none.
//
// Two products decide a discrete choice: the lenslet cell, floor(x / pitch
// + 0.5), and the ELLIPSE bound's (u / a)^2 + (v / b)^2 <= 1.  Both are
// written with round-to-nearest intrinsics (no multiply-add contraction),
// so that the kernel and its plain version take the same choice for the
// same hit.
//
// The functions are __host__ __device__ and use no CUDA type, so the same
// source compiles as plain C++ for a host check against autograd.
//
// Cost (the bound's count, chip_smoke.py): LINEAR one square root and three
// divisions; GRATING one square root and a division; MLA two floors, a
// square root and four divisions; DOE a radial sum of up to 8 terms, a
// square root and a division, and with its efficiency a sine; the ELLIPSE
// bound a cosine and a sine per row (the kernels take them once per row
// and block) and two divisions per hit.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define RTT_DF_HD __host__ __device__ __forceinline__
#else
#define RTT_DF_HD inline
#endif

namespace rtt {

// A DOE row's static data in its kinds row's physics column, above the
// coating's bits: its radial term count (1-8), then its efficiency flag
// (ops/fused_trace.py::DOE_SHIFT).
constexpr int kDoeShift = 20;
constexpr int kDoeTermsMask = 0xf;
constexpr int kDoeEfficiency = 1 << 4;
constexpr int kMaxDoeTerms = 8;
// The d line, a grating's wavelength where the ray's is unset
constexpr float kGratingDefaultUm = 0.5876f;
constexpr float kPi = static_cast<float>(3.14159265358979323846);

// Products and sums rounded on their own (no contraction into an FMA), as
// the plain version's elementwise operations round them.
#ifdef __CUDA_ARCH__
RTT_DF_HD float mul_rn(float a, float b) { return __fmul_rn(a, b); }
RTT_DF_HD float add_rn(float a, float b) { return __fadd_rn(a, b); }
RTT_DF_HD float sub_rn(float a, float b) { return __fsub_rn(a, b); }
#else
RTT_DF_HD float mul_rn(float a, float b) { return a * b; }
RTT_DF_HD float add_rn(float a, float b) { return a + b; }
RTT_DF_HD float sub_rn(float a, float b) { return a - b; }
#endif

struct Loc {
  float x, y, z;
};

// sign(where(|z| < 1e-12, 1, z))
RTT_DF_HD float sign_z(float z) {
  const float zs = fabsf(z) < 1e-12f ? 1.0f : z;
  return zs > 0.0f ? 1.0f : (zs < 0.0f ? -1.0f : zs);
}

// where(|z| < 1e-12, 1e-12, z)
RTT_DF_HD float dz_safe(float z) { return fabsf(z) < 1e-12f ? 1e-12f : z; }

// ---- the ELLIPSE surface bound: [r_major, r_minor, rotation], its
// rotation's cosine c and sine s taken once per row ----

RTT_DF_HD bool ellipse_in(float x, float y, float a, float b, float c, float s) {
  const float u = sub_rn(mul_rn(x, c), mul_rn(y, s));
  const float v = add_rn(mul_rn(x, s), mul_rn(y, c));
  const float ua = u / a, vb = v / b;
  return add_rn(mul_rn(ua, ua), mul_rn(vb, vb)) <= 1.0f;
}

// ---- LINEAR (core/physics.py::linear_dir): ph[2:6] = Cx, Cy, Dx, Dy ----

struct LinearFwd {
  float zs, nx, ny, sc, inv;
};

RTT_DF_HD LinearFwd linear_fwd(Loc dl, float hx, float hy, const float* p) {
  LinearFwd f;
  f.zs = dz_safe(dl.z);
  f.nx = p[0] * hx + p[2] * dl.x / f.zs;
  f.ny = p[1] * hy + p[3] * dl.y / f.zs;
  const float s = f.nx * f.nx + f.ny * f.ny + 1.0f;
  f.sc = fmaxf(s, 1e-12f);
  f.inv = 1.0f / sqrtf(f.sc);
  return f;
}

RTT_DF_HD Loc linear_local(Loc dl, float hx, float hy, const float* p) {
  const LinearFwd f = linear_fwd(dl, hx, hy, p);
  return {f.nx * f.inv, f.ny * f.inv, f.inv};
}

// g_ol, ol's cotangent -> adds dl's (g_dl), the hit's (g_hx, g_hy) and
// Cx, Cy, Dx, Dy's (g_p[0:4]).
RTT_DF_HD void linear_local_ct(Loc dl, float hx, float hy, const float* p, Loc g_ol, Loc& g_dl,
                               float& g_hx, float& g_hy, float* g_p) {
  const LinearFwd f = linear_fwd(dl, hx, hy, p);
  float g_nx = g_ol.x * f.inv, g_ny = g_ol.y * f.inv;
  const float g_inv = g_ol.x * f.nx + g_ol.y * f.ny + g_ol.z;
  // inv = 1 / sqrt(max(s, 1e-12)); s >= 1 passes the clamp
  const float sq = sqrtf(f.sc);
  const float g_sq = -(g_inv * f.inv * f.inv);
  const float g_s = f.sc >= 1e-12f ? g_sq / (2.0f * sq) : 0.0f;
  g_nx += 2.0f * f.nx * g_s;
  g_ny += 2.0f * f.ny * g_s;
  // nx = Cx hx + (Dx dl.x) / zs, ny likewise
  g_p[0] += g_nx * hx;
  g_p[1] += g_ny * hy;
  g_hx += g_nx * p[0];
  g_hy += g_ny * p[1];
  const float qx = p[2] * dl.x, qy = p[3] * dl.y;
  const float g_qx = g_nx / f.zs, g_qy = g_ny / f.zs;
  g_p[2] += g_qx * dl.x;
  g_p[3] += g_qy * dl.y;
  g_dl.x += g_qx * p[2];
  g_dl.y += g_qy * p[3];
  const float g_zs = -(g_nx * (qx / f.zs) / f.zs) - g_ny * (qy / f.zs) / f.zs;
  if (!(fabsf(dl.z) < 1e-12f)) g_dl.z += g_zs;
}

// ---- GRATING (core/physics.py::grating_dir): ph[2] period (um), ph[3]
// order, ph[4] reflective (> 0.5); wl the ray's raw wavelength ----

struct GratingFwd {
  float wl, pc, shift, tx, ty, tz, sgn;
  bool ok;
};

RTT_DF_HD GratingFwd grating_fwd(Loc dl, float period, float order, float refl, float wl_raw) {
  GratingFwd f;
  f.wl = wl_raw > 0.0f ? wl_raw : kGratingDefaultUm;
  f.pc = fmaxf(period, 1e-12f);
  f.shift = order * f.wl / f.pc;
  f.tx = dl.x + f.shift;
  f.ty = dl.y;
  const float t2 = f.tx * f.tx + f.ty * f.ty;
  f.ok = t2 < 1.0f;
  f.tz = sqrtf(f.ok ? fmaxf(1.0f - t2, 0.0f) : 1.0f);
  f.sgn = sign_z(dl.z) * (refl > 0.5f ? -1.0f : 1.0f);
  return f;
}

RTT_DF_HD Loc grating_local(Loc dl, float period, float order, float refl, float wl_raw,
                            bool& ok) {
  const GratingFwd f = grating_fwd(dl, period, order, refl, wl_raw);
  ok = f.ok;
  return {f.tx, f.ty, f.ok ? f.tz * f.sgn : dl.z};
}

// g_ol -> adds dl's (g_dl), the period's and order's (g_period, g_order)
// and the ray's wavelength's (g_wl; none where it is unset).
RTT_DF_HD void grating_local_ct(Loc dl, float period, float order, float refl, float wl_raw,
                                Loc g_ol, Loc& g_dl, float& g_period, float& g_order,
                                float& g_wl) {
  const GratingFwd f = grating_fwd(dl, period, order, refl, wl_raw);
  float g_tx = g_ol.x, g_ty = g_ol.y;
  if (f.ok) {
    // tz = sqrt(max(1 - t2, 0)), t2 = tx^2 + ty^2
    const float g_tz2 = g_ol.z * f.sgn / (2.0f * f.tz);
    g_tx -= 2.0f * f.tx * g_tz2;
    g_ty -= 2.0f * f.ty * g_tz2;
  } else {
    g_dl.z += g_ol.z;
  }
  g_dl.x += g_tx;
  g_dl.y += g_ty;
  // shift = (order wl) / max(period, 1e-12)
  const float g_ow = g_tx / f.pc;
  const float g_pc = -(g_tx * f.shift / f.pc);
  g_period += period > 1e-12f ? g_pc : (period == 1e-12f ? 0.5f * g_pc : 0.0f);
  g_order += g_ow * f.wl;
  if (wl_raw > 0.0f) g_wl += g_ow * order;
}

// ---- MLA (core/physics.py::mla_dir): ph[0] pitch, ph[1] f ----

struct MlaFwd {
  float zs, cx, cy, inv_f, nx, ny, s, inv, sgn;
};

RTT_DF_HD MlaFwd mla_fwd(Loc dl, float hx, float hy, float pitch, float f_len) {
  MlaFwd f;
  f.zs = dz_safe(dl.z);
  const float inv_p = 1.0f / fmaxf(pitch, 1e-9f);
  f.cx = floorf(add_rn(mul_rn(hx, inv_p), 0.5f));
  f.cy = floorf(add_rn(mul_rn(hy, inv_p), 0.5f));
  f.inv_f = 1.0f / f_len;
  f.nx = dl.x / f.zs - (hx - pitch * f.cx) * f.inv_f;
  f.ny = dl.y / f.zs - (hy - pitch * f.cy) * f.inv_f;
  f.s = f.nx * f.nx + f.ny * f.ny + 1.0f;
  f.inv = 1.0f / sqrtf(f.s);
  f.sgn = sign_z(dl.z);
  return f;
}

RTT_DF_HD Loc mla_local(Loc dl, float hx, float hy, float pitch, float f_len) {
  const MlaFwd f = mla_fwd(dl, hx, hy, pitch, f_len);
  return {f.nx * f.inv * f.sgn, f.ny * f.inv * f.sgn, f.inv * f.sgn};
}

// g_ol -> adds dl's, the hit's and the pitch's and focal length's
// (g_pitch through pitch * floor(.), whose floor passes none; g_f).
RTT_DF_HD void mla_local_ct(Loc dl, float hx, float hy, float pitch, float f_len, Loc g_ol,
                            Loc& g_dl, float& g_hx, float& g_hy, float& g_pitch,
                            float& g_f) {
  const MlaFwd f = mla_fwd(dl, hx, hy, pitch, f_len);
  float g_nx = g_ol.x * f.sgn * f.inv, g_ny = g_ol.y * f.sgn * f.inv;
  const float g_inv = f.sgn * (g_ol.x * f.nx + g_ol.y * f.ny + g_ol.z);
  // inv = 1 / sqrt(s)
  const float sq = sqrtf(f.s);
  const float g_s = -(g_inv * f.inv * f.inv) / (2.0f * sq);
  g_nx += 2.0f * f.nx * g_s;
  g_ny += 2.0f * f.ny * g_s;
  // nx = dl.x / zs - (x - pitch cx) inv_f
  g_dl.x += g_nx / f.zs;
  g_dl.y += g_ny / f.zs;
  const float g_zs = -(g_nx * (dl.x / f.zs) / f.zs) - g_ny * (dl.y / f.zs) / f.zs;
  if (!(fabsf(dl.z) < 1e-12f)) g_dl.z += g_zs;
  const float ex = hx - pitch * f.cx, ey = hy - pitch * f.cy;
  const float g_ex = -(g_nx * f.inv_f), g_ey = -(g_ny * f.inv_f);
  const float g_inv_f = -(g_nx * ex) - g_ny * ey;
  g_hx += g_ex;
  g_hy += g_ey;
  g_pitch += -(g_ex * f.cx) - g_ey * f.cy;
  g_f += -(g_inv_f * f.inv_f * f.inv_f);
}

// ---- DOE (core/physics.py::doe_dir): ph[2] order, ph[3] design wavelength
// lam0 (um), c[0:n] the radial coefficients (the row's ff columns); n1, n2
// the media of incidence and transmission ----

struct DoeFwd {
  float wl, lam_mm, r2, gscale, kick, tx, ty, n2sq, tz, sgn, inv;
  bool ok;
};

RTT_DF_HD DoeFwd doe_fwd(Loc dl, float hx, float hy, const float* c, int n, float order,
                         float lam0, float wl_raw, float n1, float n2) {
  DoeFwd f;
  f.wl = wl_raw > 0.0f ? wl_raw : lam0;
  f.lam_mm = f.wl * 1e-3f;
  f.r2 = hx * hx + hy * hy;
  f.gscale = 0.0f;
  float rpow = 1.0f;  // r^(2(k-1))
  for (int k = 0; k < n; ++k) {
    f.gscale = f.gscale + (2.0f * static_cast<float>(k + 1)) * c[k] * rpow;
    rpow = rpow * f.r2;
  }
  f.kick = order * f.lam_mm * f.gscale;
  f.tx = n1 * dl.x + f.kick * hx;
  f.ty = n1 * dl.y + f.kick * hy;
  const float t2 = f.tx * f.tx + f.ty * f.ty;
  f.n2sq = n2 * n2;
  f.ok = t2 < f.n2sq;
  f.tz = sqrtf(f.ok ? fmaxf(f.n2sq - t2, 0.0f) : 1.0f);
  f.sgn = sign_z(dl.z);
  f.inv = 1.0f / n2;
  return f;
}

RTT_DF_HD Loc doe_local(Loc dl, float hx, float hy, const float* c, int n, float order,
                        float lam0, float wl_raw, float n1, float n2, bool& ok) {
  const DoeFwd f = doe_fwd(dl, hx, hy, c, n, order, lam0, wl_raw, n1, n2);
  ok = f.ok;
  return {f.tx * f.inv, f.ty * f.inv, f.ok ? f.tz * f.sgn * f.inv : dl.z};
}

// What a DOE row's adjoint adds to beside dl and the hit: the coefficients'
// cotangents (c[0:n]), the order's and the design wavelength's, the ray's
// wavelength's (none where it is unset: lam0 takes it) and the media's.
struct DoeCt {
  float c[kMaxDoeTerms];
  float order, lam0, wl, n1, n2;
};

// g_ol -> adds dl's, the hit's and dc's; g_n2_extra is a further cotangent
// of n2 (the medium after the row, for the optical path length).
RTT_DF_HD void doe_local_ct(Loc dl, float hx, float hy, const float* c, int n, float order,
                            float lam0, float wl_raw, float n1, float n2, Loc g_ol,
                            float g_n2_extra, Loc& g_dl, float& g_hx, float& g_hy,
                            DoeCt& dc) {
  const DoeFwd f = doe_fwd(dl, hx, hy, c, n, order, lam0, wl_raw, n1, n2);
  // ol = (tx inv, ty inv, ok ? (tz sign) inv : dl.z)
  float g_inv = g_ol.x * f.tx + g_ol.y * f.ty;
  float g_tx = g_ol.x * f.inv, g_ty = g_ol.y * f.inv;
  float g_n2sq = 0.0f;
  if (f.ok) {
    g_inv += g_ol.z * f.tz * f.sgn;
    // tz = sqrt(max(n2^2 - t2, 0))
    const float g_a = g_ol.z * f.sgn * f.inv / (2.0f * f.tz);
    g_n2sq = g_a;
    g_tx -= 2.0f * f.tx * g_a;
    g_ty -= 2.0f * f.ty * g_a;
  } else {
    g_dl.z += g_ol.z;
  }
  dc.n2 += -(g_inv * f.inv * f.inv) + 2.0f * n2 * g_n2sq + g_n2_extra;
  // tx = n1 dl.x + kick x, ty = n1 dl.y + kick y
  dc.n1 += g_tx * dl.x + g_ty * dl.y;
  g_dl.x += g_tx * n1;
  g_dl.y += g_ty * n1;
  const float g_kick = g_tx * hx + g_ty * hy;
  g_hx += g_tx * f.kick;
  g_hy += g_ty * f.kick;
  // kick = (order lam_mm) gscale, lam_mm = wl 1e-3
  const float g_ol_m = g_kick * f.gscale;
  const float g_gs = g_kick * (order * f.lam_mm);
  dc.order += g_ol_m * f.lam_mm;
  const float g_wl = g_ol_m * order * 1e-3f;
  if (wl_raw > 0.0f)
    dc.wl += g_wl;
  else
    dc.lam0 += g_wl;
  // gscale = sum_k (2k c_k) r2^(k-1)
  float g_r2 = 0.0f, rpow = 1.0f, drpow = 0.0f;  // r2^(k-1), its derivative
  for (int k = 0; k < n; ++k) {
    const float two_k = 2.0f * static_cast<float>(k + 1);
    dc.c[k] += g_gs * two_k * rpow;
    g_r2 += g_gs * two_k * c[k] * drpow;
    drpow = drpow * f.r2 + rpow;
    rpow = rpow * f.r2;
  }
  g_hx += 2.0f * hx * g_r2;
  g_hy += 2.0f * hy * g_r2;
}

// The kinoform efficiency (core/physics.py::kinoform_efficiency):
// sinc^2(lam0 / wl - order), 1 where |a| <= 1e-9 (the `safe` select).
RTT_DF_HD float kinoform_eff(float order, float lam0, float wl_raw) {
  const float wl = wl_raw > 0.0f ? wl_raw : lam0;
  const float a = lam0 / wl - order;
  if (!(fabsf(a) > 1e-9f)) return 1.0f;
  const float x = a * kPi;
  const float q = sinf(x) / x;
  return q * q;
}

// g_eta, the efficiency's cotangent -> adds the order's, lam0's and the
// ray's wavelength's (dc); the constant branch passes none.
RTT_DF_HD void kinoform_eff_ct(float order, float lam0, float wl_raw, float g_eta, DoeCt& dc) {
  const float wl = wl_raw > 0.0f ? wl_raw : lam0;
  const float a = lam0 / wl - order;
  if (!(fabsf(a) > 1e-9f)) return;
  const float x = a * kPi;
  const float sx = sinf(x), cx = cosf(x);
  const float q = sx / x;
  // eta = q^2, q = sin(x) / x
  const float g_q = g_eta * 2.0f * q;
  const float g_x = g_q / x * cx - g_q * q / x;
  const float g_a = g_x * kPi;
  // a = lam0 / wl - order
  dc.order -= g_a;
  dc.lam0 += g_a / wl;
  const float g_w = -(g_a * (lam0 / wl) / wl);
  if (wl_raw > 0.0f)
    dc.wl += g_w;
  else
    dc.lam0 += g_w;
}

}  // namespace rtt
