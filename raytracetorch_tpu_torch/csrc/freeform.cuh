// Freeform (XY-polynomial) surfaces for the fused kernels' instantiation with
// them (kFreeform): the sag and its partials, the Newton refinement of a
// base-conic root onto the sag, the normal from the sag's gradient, and the
// adjoints of the refinement and of the normal for K2 and K6.
//
// The TPU kernels intersect a freeform row through raytracetorch_tpu/core/
// intersect.py:69-79 (ff_refine) and take its normal at :149-156 (ff_normal),
// both in raytracetorch_tpu/geom/surfaces.py :309-395; their adjoints
// (_kernel_v2_bwd, _kernel_nonseq_bwd*) are jax.vjp of that code, so they
// differentiate the 8 unrolled Newton steps, not the implicit function of
// the converged root (which would differ by O(|G|)).  The plain version is
// geom/surfaces.py (ff_sag_grad, ff_refine, ff_normal) under autograd, which
// this file follows operation by operation in the forward.
//
// The surface: S(x, y) = c r^2 / (1 + sqrt(1 - kc2 r^2)) + sum_k a_k
// r^(2k+4) + sum_m c_m x^i_m y^j_m, kc2 = (1 + k) c^2.  A row's base conic
// sits in q as for an even asphere, a4..a10 in asph[0:4], the c_m in its ff
// columns, and its exponent pairs, static per scene, in a side buffer of
// kFfSide int32 words a row (ops/fused_trace.py::ff_side): the term count
// (0: not a freeform row), then each pair packed as i | j << 16.  The terms
// are summed in that order after the radial part, and x^i is the multiply
// chain x * x * ... from the left (geom/surfaces.py::_ipow): another order
// is another float32 result.
//
// The reverse of one Newton step t' = t - G / G' (G = z - S, G' = d_z - S_x
// d_x - S_y d_y, held off zero at 1e-12) needs the second partials S_xx,
// S_xy, S_yy of the whole surface: the radial part's through S'(r^2) and
// S''(r^2) (the even asphere's closed forms, with the conic's clamp as
// torch.clamp differentiates it), the monomials' summed term by term.  The
// step inputs are kept in a per-thread array of kFfSteps floats, then the
// steps are reversed.  A coefficient's cotangent goes into `tf[m]` (the
// row's ff columns, reduced with the others).
//
// The functions are __host__ __device__ and use no CUDA type, so the same
// source compiles as plain C++ for a host check against the plain version.

#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define RTT_FF_HD __host__ __device__ __forceinline__
#else
#define RTT_FF_HD inline
#endif

namespace rtt {

// MAX_FF_TERMS: the terms a face (the table's ff columns).
constexpr int kMaxFfTerms = 32;
// Side-buffer words a row: the term count, then the packed pairs.
constexpr int kFfSide = 1 + kMaxFfTerms;
// The Newton steps of ff_refine.
constexpr int kFfSteps = 8;

// A freeform row: its base conic, even-asphere terms, coefficients (the flat
// row's ff columns) and packed exponent pairs (count, then i | j << 16).
struct Freeform {
  float c, kc2, a[4];
  const float* cm;
  const int32_t* pw;
};

RTT_FF_HD Freeform freeform_of(const float* q, const float* asph, const float* ff,
                               const int32_t* pw) {
  return {q[0], q[2] * q[0], {asph[0], asph[1], asph[2], asph[3]}, ff, pw};
}

RTT_FF_HD int ff_terms(const Freeform& s) { return s.pw[0]; }
RTT_FF_HD int ff_i(const Freeform& s, int m) { return s.pw[1 + m] & 0xffff; }
RTT_FF_HD int ff_j(const Freeform& s, int m) { return s.pw[1 + m] >> 16; }

// v^n as geom/surfaces.py::_ipow: v, then out = out * v n - 1 times; 1 for
// n = 0.
RTT_FF_HD float ff_ipow(float v, int n) {
  if (n <= 0) return 1.0f;
  float out = v;
  for (int k = 1; k < n; ++k) out = out * v;
  return out;
}

struct FfSag {
  float s, gx, gy;
};

// geom/surfaces.py::ff_sag_grad: the sag and its partials at (x, y).
RTT_FF_HD FfSag ff_sag_grad(const Freeform& f, float x, float y) {
  const float r2 = x * x + y * y;
  const float term = fmaxf(1.0f - f.kc2 * r2, 0.0f);
  const float sq = sqrtf(term + 1e-24f);
  const float den1 = 1.0f + sq;
  float sag = f.c * r2 / den1;
  float dsag = f.c / den1 + f.c * r2 * f.kc2 / (2.0f * sq * (den1 * den1));
  float rp = r2 * r2, drp = r2, i = 2.0f;
  for (int k = 0; k < 4; ++k) {
    sag = sag + f.a[k] * rp;
    dsag = dsag + i * f.a[k] * drp;
    rp = rp * r2;
    drp = drp * r2;
    i = i + 1.0f;
  }
  float gx = 2.0f * x * dsag, gy = 2.0f * y * dsag;
  const int nt = ff_terms(f);
  for (int m = 0; m < nt; ++m) {
    const int pi = ff_i(f, m), pj = ff_j(f, m);
    const float cm = f.cm[m];
    const float xi = ff_ipow(x, pi), yj = ff_ipow(y, pj);
    sag = sag + cm * xi * yj;
    if (pi > 0) gx = gx + cm * static_cast<float>(pi) * ff_ipow(x, pi - 1) * yj;
    if (pj > 0) gy = gy + cm * static_cast<float>(pj) * xi * ff_ipow(y, pj - 1);
  }
  return {sag, gx, gy};
}

struct FfG {
  float g, dg;
};

// G(t) = z - S(x, y) along o + t d and G'(t) = d_z - S_x d_x - S_y d_y.
RTT_FF_HD FfG ff_g(const Freeform& f, float ox, float oy, float oz, float dx, float dy, float dz,
                   float t) {
  const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
  const FfSag s = ff_sag_grad(f, x, y);
  return {z - s.s, dz - s.gx * dx - s.gy * dy};
}

// One Newton step t - G / G', G' held off zero at 1e-12 with its sign.
RTT_FF_HD float ff_step(const Freeform& f, float ox, float oy, float oz, float dx, float dy,
                        float dz, float t) {
  const FfG G = ff_g(f, ox, oy, oz, dx, dy, dz, t);
  const float dg = fabsf(G.dg) < 1e-12f ? (G.dg < 0.0f ? -1e-12f : 1e-12f) : G.dg;
  return t - G.g / dg;
}

// The kFfSteps Newton steps from a base-conic root t; ts, when given,
// receives each step's input.
RTT_FF_HD float ff_steps(const Freeform& f, float ox, float oy, float oz, float dx, float dy,
                         float dz, float t, float* ts = nullptr) {
  for (int i = 0; i < kFfSteps; ++i) {
    if (ts != nullptr) ts[i] = t;
    t = ff_step(f, ox, oy, oz, dx, dy, dz, t);
  }
  return t;
}

// geom/surfaces.py::ff_refine: refine a base-conic root t onto the surface;
// `valid` stays true where |G| < 1e-4 after the steps and t > eps
// (INTERSECT_EPS).
RTT_FF_HD float ff_refine(const Freeform& f, float ox, float oy, float oz, float dx, float dy,
                          float dz, float t, bool& valid, float eps) {
  t = ff_steps(f, ox, oy, oz, dx, dy, dz, t);
  valid = valid && fabsf(ff_g(f, ox, oy, oz, dx, dy, dz, t).g) < 1e-4f && t > eps;
  return t;
}

// geom/surfaces.py::ff_normal: (-S_x, -S_y, 1) / |.| at a surface-frame hit.
RTT_FF_HD void ff_normal(const Freeform& f, float x, float y, float& nx, float& ny, float& nz) {
  const FfSag s = ff_sag_grad(f, x, y);
  const float inv = 1.0f / sqrtf(s.gx * s.gx + s.gy * s.gy + 1.0f + 1e-24f);
  nx = -s.gx * inv;
  ny = -s.gy * inv;
  nz = inv;
}

// ---- Adjoints ----

// The cotangents of a freeform row's radial terms: its c, kc2 = (1 + k) c^2
// and a4..a10 (the coefficients' go to tf).
struct FfCt {
  float c, kc2, a[4];
};

// Adjoint of ff_sag_grad at (x, y): the cotangents (gS, gSx, gSy) of (S,
// S_x, S_y) add those of x and y into gx_out, gy_out, of the radial terms
// into ct and of the coefficients into tf[0:terms].
RTT_FF_HD void ff_sag_grad_backward(const Freeform& f, float x, float y, float gS, float gSx,
                                    float gSy, float& gx_out, float& gy_out, FfCt& ct,
                                    float* tf) {
  // ---- the radial part's forward values ----
  const float r2 = x * x + y * y;
  const float raw = 1.0f - f.kc2 * r2;
  const float sq = sqrtf(fmaxf(raw, 0.0f) + 1e-24f);
  const float den1 = 1.0f + sq;
  const float r4 = r2 * r2, r6 = r4 * r2, r8 = r6 * r2;
  const float W = 2.0f * sq * (den1 * den1);
  const float inv = 1.0f / W;
  const float dsag = f.c / den1 + f.c * r2 * f.kc2 * inv + 2.0f * f.a[0] * r2 +
                     3.0f * f.a[1] * r4 + 4.0f * f.a[2] * r6 + 5.0f * f.a[3] * r8;
  // ---- S_x = 2 x S' + P_x, S_y = 2 y S' + P_y, S = S_r + P ----
  const float g_dsag = 2.0f * x * gSx + 2.0f * y * gSy;
  float g_x = 2.0f * dsag * gSx, g_y = 2.0f * dsag * gSy;
  // ---- S' = c / den1 + c r2 kc2 inv + 2 a4 r2 + 3 a6 r4 + ... ----
  float g_sq = -g_dsag * f.c / (den1 * den1);
  float g_r2 = g_dsag * (f.c * f.kc2 * inv + 2.0f * f.a[0] + 6.0f * f.a[1] * r2 +
                         12.0f * f.a[2] * r4 + 20.0f * f.a[3] * r6);
  ct.c += g_dsag * (1.0f / den1 + r2 * f.kc2 * inv);
  ct.kc2 += g_dsag * f.c * r2 * inv;
  const float g_inv = g_dsag * f.c * r2 * f.kc2;
  ct.a[0] += 2.0f * r2 * g_dsag;
  ct.a[1] += 3.0f * r4 * g_dsag;
  ct.a[2] += 4.0f * r6 * g_dsag;
  ct.a[3] += 5.0f * r8 * g_dsag;
  // ---- inv = 1 / W, W = 2 sq den1^2 ----
  const float g_W = -g_inv * inv * inv;
  g_sq += g_W * (2.0f * den1 * den1 + 4.0f * sq * den1);
  // ---- S_r = c r2 / den1 + a4 r4 + a6 r6 + a8 r8 + a10 r10 ----
  ct.c += gS * r2 / den1;
  g_r2 += gS * (f.c / den1 + 2.0f * f.a[0] * r2 + 3.0f * f.a[1] * r4 + 4.0f * f.a[2] * r6 +
                5.0f * f.a[3] * r8);
  g_sq -= gS * f.c * r2 / (den1 * den1);
  ct.a[0] += gS * r4;
  ct.a[1] += gS * r6;
  ct.a[2] += gS * r8;
  ct.a[3] += gS * r8 * r2;
  // ---- sq = sqrt(max(1 - kc2 r2, 0) + 1e-24) (torch.clamp: the bound
  // itself passes) ----
  const float g_raw = raw >= 0.0f ? g_sq / (2.0f * sq) : 0.0f;
  ct.kc2 -= g_raw * r2;
  g_r2 -= g_raw * f.kc2;
  g_x += 2.0f * x * g_r2;
  g_y += 2.0f * y * g_r2;
  // ---- the monomials c_m x^i y^j and their partials ----
  const int nt = ff_terms(f);
  for (int m = 0; m < nt; ++m) {
    const int pi = ff_i(f, m), pj = ff_j(f, m);
    const float cm = f.cm[m];
    const float fi = static_cast<float>(pi), fj = static_cast<float>(pj);
    const float xi2 = ff_ipow(x, pi - 2), yj2 = ff_ipow(y, pj - 2);
    const float xi1 = pi >= 2 ? xi2 * x : ff_ipow(x, pi - 1);
    const float yj1 = pj >= 2 ? yj2 * y : ff_ipow(y, pj - 1);
    const float xi = pi >= 1 ? xi1 * x : 1.0f;
    const float yj = pj >= 1 ? yj1 * y : 1.0f;
    // d(x^i y^j), d(i x^(i-1) y^j), d(j x^i y^(j-1)) by x and by y
    const float px = pi > 0 ? fi * xi1 * yj : 0.0f;
    const float py = pj > 0 ? fj * xi * yj1 : 0.0f;
    const float pxx = pi > 1 ? fi * (fi - 1.0f) * xi2 * yj : 0.0f;
    const float pxy = pi > 0 && pj > 0 ? fi * fj * xi1 * yj1 : 0.0f;
    const float pyy = pj > 1 ? fj * (fj - 1.0f) * xi * yj2 : 0.0f;
    tf[m] += gS * xi * yj + gSx * px + gSy * py;
    g_x += cm * (gS * px + gSx * pxx + gSy * pxy);
    g_y += cm * (gS * py + gSx * pxy + gSy * pyy);
  }
  gx_out += g_x;
  gy_out += g_y;
}

// Adjoint of one ff_step at ray parameter t: `lam`, the cotangent of the
// step's result, adds the cotangents of o and d into go*, gd* and of the
// surface's terms into ct and tf; returns the cotangent of t.
RTT_FF_HD float ff_step_backward(const Freeform& f, float ox, float oy, float oz, float dx,
                                 float dy, float dz, float t, float lam, float& gox, float& goy,
                                 float& goz, float& gdx, float& gdy, float& gdz, FfCt& ct,
                                 float* tf) {
  const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
  const FfSag s = ff_sag_grad(f, x, y);
  const float g = z - s.s;
  const float dg = dz - s.gx * dx - s.gy * dy;
  const bool clamped = fabsf(dg) < 1e-12f;
  const float dgc = clamped ? (dg < 0.0f ? -1e-12f : 1e-12f) : dg;
  // ---- t' = t - g / dgc ----
  const float g_g = -lam / dgc;
  const float g_dg = clamped ? 0.0f : lam * (g / dgc) / dgc;
  // ---- dg = d_z - S_x d_x - S_y d_y; g = z - S ----
  gdz += g_dg;
  gdx -= g_dg * s.gx;
  gdy -= g_dg * s.gy;
  float g_x = 0.0f, g_y = 0.0f;
  ff_sag_grad_backward(f, x, y, -g_g, -g_dg * dx, -g_dg * dy, g_x, g_y, ct, tf);
  // ---- x, y, z = o + t d ----
  gox += g_x;
  goy += g_y;
  goz += g_g;
  gdx += g_x * t;
  gdy += g_y * t;
  gdz += g_g * t;
  return lam + g_x * dx + g_y * dy + g_g * dz;
}

// Adjoint of ff_refine's steps from the base-conic root t0: `lam`, the
// cotangent of the refined root, -> the cotangent of t0, adding those of o,
// d and the surface's terms.  The steps' inputs are recomputed once, kept in
// a per-thread array.
RTT_FF_HD float ff_refine_backward(const Freeform& f, float ox, float oy, float oz, float dx,
                                   float dy, float dz, float t0, float lam, float& gox,
                                   float& goy, float& goz, float& gdx, float& gdy, float& gdz,
                                   FfCt& ct, float* tf) {
  float ts[kFfSteps];
  ff_steps(f, ox, oy, oz, dx, dy, dz, t0, ts);
  for (int i = kFfSteps - 1; i >= 0; --i)
    lam = ff_step_backward(f, ox, oy, oz, dx, dy, dz, ts[i], lam, gox, goy, goz, gdx, gdy, gdz,
                           ct, tf);
  return lam;
}

// Adjoint of ff_normal at surface-frame hit (x, y): (gnx, gny, gnz), the
// normal's cotangent, adds the cotangents of x and y into ghx, ghy, of the
// radial terms into ct and of the coefficients into tf.
RTT_FF_HD void ff_normal_backward(const Freeform& f, float x, float y, float gnx, float gny,
                                  float gnz, float& ghx, float& ghy, FfCt& ct, float* tf) {
  const FfSag s = ff_sag_grad(f, x, y);
  const float rS = sqrtf(s.gx * s.gx + s.gy * s.gy + 1.0f + 1e-24f);
  const float inv = 1.0f / rS;
  // ---- n = (-S_x inv, -S_y inv, inv), inv = 1 / sqrt(S_x^2 + S_y^2 + 1) ----
  const float g_inv = -gnx * s.gx - gny * s.gy + gnz;
  const float g_q = -g_inv * inv * inv / (2.0f * rS);  // the cotangent of S_x^2 + S_y^2
  const float gSx = -gnx * inv + 2.0f * s.gx * g_q;
  const float gSy = -gny * inv + 2.0f * s.gy * g_q;
  ff_sag_grad_backward(f, x, y, 0.0f, gSx, gSy, ghx, ghy, ct, tf);
}

}  // namespace rtt
