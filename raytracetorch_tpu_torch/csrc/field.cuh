// The polarized field of the fused kernels K1 (trace_seq_fwd.cu), K2
// (trace_seq_bwd.cu), K5 (trace_nonseq_fwd.cu) and K6 (trace_nonseq_bwd.cu),
// in their instantiation with the field (kField):
// the s/p basis, the flux-normalized Fresnel amplitudes, the polarized
// reflectance, one row's transport of the complex E-vector, and the
// hand-written adjoint of each, through coated interfaces and metal mirrors
// too (their stacks' amplitudes, thin_film.cuh).
//
// Replaces the field code of the TPU kernels raytracetorch_tpu/ops/
// pallas_trace.py::_kernel_v2 (its field streams :544-567, the transport
// :1653-1661 and the |E|^2 weights :1632-1633 of _chain_pure) and of
// _kernel_v2_bwd (the field's inputs and cotangents :1720-1736,
// :1822-1831), and of _kernel_nonseq (:1035, :1047, :1131-1168) and
// _kernel_nonseq_bwd(_scan) (:2054-2149, :2182-2406) through
// _nonseq_bounce_core (:861, :971-975), which run
// raytracetorch_tpu/core/field.py and the polarized
// branches of core/static_dispatch.py.  The plain PyTorch versions are the
// port's core/field.py (sp_basis, fresnel_amplitudes, transport_field) and
// core/static_dispatch.py::polarized_RT, run by the eager chain.
//
// A ray's field is six floats, the real and imaginary parts of E (Fld).  A
// row's transport (field_transport) by its physics kind:
// - SNELL, FRESNEL, FRESNEL_W, REFLECT_W: E is split on the s/p basis of
//   the incoming direction and the normal, multiplied by the transmission
//   amplitudes (or, where the new direction's normal component flipped
//   sign, the complex reflection amplitudes: TIR or a FRESNEL reflection
//   draw) and rebuilt on the s/p basis of the new direction; the Fresnel
//   kinds renormalize it to the incoming |E|^2 (their branch power lives in
//   the draw or the intensity factor), with a guarded divide: a branch of
//   zero amplitude gets scale 0.  A coated interface (FieldRow::stack
//   kStackCoated) takes its stack's complex amplitudes, which the caller
//   evaluates (thin_film.cuh::stack_field, the layers in the order the ray
//   meets them; under TIR the bare interface's reflection); a coated SNELL
//   row is not renormalized, so |E|^2 carries the coating's T;
// - a metal REFLECT row (kStackMetal): the same split and rebuild with its
//   (coated) metal's complex reflections, renormalized;
// - JONES: the transverse field times J = R(theta) diag(a1 e^{-i delta/2},
//   a2 e^{i delta/2}) R(-theta), its axes the row's Rw column 0 projected
//   transverse to the ray (column 1 where the ray runs along column 0), the
//   retardance scaled by lam0 / lam on a chromatic plate and by the
//   crystal's dn(lam) / dn(lam0) (kCrystalCoef, the port's
//   utils/birefringence.py, which a CPU test holds this header to);
// - DOE, PHASE_GRID: the s/p components rebuilt around the new direction,
//   times sqrt(imod); a perfect REFLECT mirrors E like a direction; BLOCK
//   zeroes it; every other kind scales it by sqrt(imod).
// The polarized reflectance and transmittance (polarized_r, polarized_rt)
// weigh an interface's or a mirror's Rs, Rp (Ts, Tp) by the field's s and p
// powers: the FRESNEL draw's R and the weighted kinds' factors.
// The adjoints differentiate the branch the forward took, with the same
// guards (1e-24 under the square roots, the degenerate bases), the
// convention of PyTorch autograd of the plain version: a guarded branch
// that a select drops gets no cotangent, a clamp passes its bound.
//
// Every function is __host__ __device__, on its own small vector type F3,
// so the header also compiles with g++: a host harness can hold the
// adjoints to autograd of core/field.py before any chip run.

#pragma once

#include <cmath>

#include "thin_film.cuh"

#ifdef __CUDACC__
#define RTT_FD_HD __host__ __device__ __forceinline__
#else
#define RTT_FD_HD inline
#endif

namespace rtt {

// The physics kinds the field branches on (trace_seq_common.cuh::PhysKind).
constexpr int kFkBlock = 1, kFkReflect = 2, kFkSnell = 3, kFkFresnel = 4, kFkFresnelW = 8,
              kFkReflectW = 9, kFkJones = 11, kFkDoe = 13, kFkPhaseGrid = 15;

struct F3 {
  float x, y, z;
};

RTT_FD_HD float fdot(F3 a, F3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RTT_FD_HD F3 fcross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
RTT_FD_HD F3 fscale(F3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
RTT_FD_HD F3 fadd(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
// acc + s * v
RTT_FD_HD F3 faxpy(F3 acc, float s, F3 v) {
  return {acc.x + s * v.x, acc.y + s * v.y, acc.z + s * v.z};
}
RTT_FD_HD float fsign(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// The complex field of one ray, E = r + i i.
struct Fld {
  F3 r, i;
};

// |E|^2, as core/field.py::FieldState.power sums it.
RTT_FD_HD float fpower(const Fld& e) { return fdot(e.r, e.r) + fdot(e.i, e.i); }

// ---- the s/p basis (core/field.py::sp_basis) ----

// s = normalize(d x n), or at normal incidence (|d x n|^2 < 1e-12) a unit
// perpendicular built from d's smallest component; p = s x d.
struct SpBasis {
  F3 s, p;
  F3 sv;      // d x n
  float inv;  // 1 / |d x n| (not degenerate)
  F3 f;       // the fallback's perpendicular (degenerate)
  float f2;   // its length
  bool degen;
};

RTT_FD_HD SpBasis sp_basis(F3 d, F3 n) {
  SpBasis b;
  b.sv = {d.y * n.z - d.z * n.y, d.z * n.x - d.x * n.z, d.x * n.y - d.y * n.x};
  const float s2 = b.sv.x * b.sv.x + b.sv.y * b.sv.y + b.sv.z * b.sv.z;
  b.degen = s2 < 1e-12f;
  b.inv = 0.0f;
  b.f = {0.0f, 0.0f, 0.0f};
  b.f2 = 1.0f;
  if (!b.degen) {
    b.inv = 1.0f / sqrtf(s2);
    b.s = fscale(b.sv, b.inv);
  } else {
    const float ax = fabsf(d.x) < 0.9f ? 1.0f : 0.0f, ay = 1.0f - ax;
    b.f = {ay * d.z, -(ax * d.z), ax * d.y - ay * d.x};
    b.f2 = sqrtf(b.f.x * b.f.x + b.f.y * b.f.y + b.f.z * b.f.z + 1e-24f);
    b.s = {b.f.x / b.f2, b.f.y / b.f2, b.f.z / b.f2};
  }
  b.p = fcross(b.s, d);
  return b;
}

// Adjoint of sp_basis: g_s, g_p (the cotangents of s and p) add those of d
// and n.
RTT_FD_HD void sp_basis_ct(const SpBasis& b, F3 d, F3 n, F3 g_s, F3 g_p, F3& g_d, F3& g_n) {
  // p = s x d
  g_s = fadd(g_s, fcross(d, g_p));
  g_d = fadd(g_d, fcross(g_p, b.s));
  if (!b.degen) {
    // s = sv inv, inv = 1 / sqrt(s2)
    const float g_inv = fdot(g_s, b.sv);
    F3 g_sv = fscale(g_s, b.inv);
    const float g_s2 = -(g_inv * b.inv * b.inv) * 0.5f * b.inv;
    g_sv = faxpy(g_sv, 2.0f * g_s2, b.sv);
    // sv = d x n
    g_d = fadd(g_d, fcross(n, g_sv));
    g_n = fadd(g_n, fcross(g_sv, d));
  } else {
    // s = f / f2, f2 = sqrt(|f|^2 + 1e-24)
    const float g_f2 = -(g_s.x * b.f.x + g_s.y * b.f.y + g_s.z * b.f.z) / (b.f2 * b.f2);
    const float g_q = g_f2 * 0.5f / b.f2;
    const F3 g_f = faxpy(fscale(g_s, 1.0f / b.f2), 2.0f * g_q, b.f);
    const float ax = fabsf(d.x) < 0.9f ? 1.0f : 0.0f, ay = 1.0f - ax;
    g_d.z += ay * g_f.x - ax * g_f.y;
    g_d.y += ax * g_f.z;
    g_d.x -= ay * g_f.z;
  }
}

// ---- the flux-normalized Fresnel amplitudes (core/field.py::
// fresnel_amplitudes) ----

struct Amps {
  float ts, tp;              // real transmission (flux-normalized; 0 under TIR)
  float rs_r, rs_i, rp_r, rp_i;
  float ct, kappa;           // cos_t (1 under TIR) and sqrt(sin2_t - 1) (0 else)
  bool tir;
};

RTT_FD_HD void tir_r(float a, float b, float& re, float& im) {
  const float den = a * a + b * b + 1e-24f;
  re = (a * a - b * b) / den;
  im = -2.0f * a * b / den;
}

RTT_FD_HD Amps fresnel_amps(float n1, float n2, float ci, float sin2) {
  Amps m;
  m.tir = sin2 > 1.0f;
  m.ct = sqrtf(m.tir ? 1.0f : fmaxf(1.0f - sin2, 0.0f));
  m.kappa = sqrtf(m.tir ? fmaxf(sin2 - 1.0f, 0.0f) : 0.0f);
  const float ds = n1 * ci + n2 * m.ct + 1e-12f, dp = n2 * ci + n1 * m.ct + 1e-12f;
  const float num = 2.0f * n1 * ci;
  const float flux = sqrtf(fmaxf(n2 * m.ct, 0.0f) / fmaxf(n1 * ci, 1e-12f));
  m.ts = m.tir ? 0.0f : num / ds * flux;
  m.tp = m.tir ? 0.0f : num / dp * flux;
  if (m.tir) {
    tir_r(n1 * ci, n2 * m.kappa, m.rs_r, m.rs_i);
    tir_r(n2 * ci, n1 * m.kappa, m.rp_r, m.rp_i);
  } else {
    m.rs_r = (n1 * ci - n2 * m.ct) / ds;
    m.rp_r = (n2 * ci - n1 * m.ct) / dp;
    m.rs_i = 0.0f;
    m.rp_i = 0.0f;
  }
  return m;
}

// Adjoint of tir_r(a, b): the cotangents of (re, im) add those of a, b.
RTT_FD_HD void tir_r_ct(float a, float b, float g_re, float g_im, float& g_a, float& g_b) {
  const float den = a * a + b * b + 1e-24f;
  const float re = (a * a - b * b) / den, im = -2.0f * a * b / den;
  const float g_nr = g_re / den, g_ni = g_im / den;
  const float g_den = -(g_re * re / den) - g_im * im / den;
  g_a += 2.0f * a * g_nr - 2.0f * b * g_ni + 2.0f * a * g_den;
  g_b += -2.0f * b * g_nr - 2.0f * a * g_ni + 2.0f * b * g_den;
}

// Adjoint of fresnel_amps: the cotangents of ts, tp, rs and rp add those of
// n1, n2, ci and sin2.
RTT_FD_HD void fresnel_amps_ct(float n1, float n2, float ci, float sin2, const Amps& m,
                               float g_ts, float g_tp, float g_rsr, float g_rsi, float g_rpr,
                               float g_rpi, float& g_n1, float& g_n2, float& g_ci,
                               float& g_sin2) {
  const float ct = m.ct;
  if (m.tir) {
    // ct = 1 (no cotangent); kappa = sqrt(max(sin2 - 1, 0))
    float g_a = 0.0f, g_b = 0.0f;
    tir_r_ct(n1 * ci, n2 * m.kappa, g_rsr, g_rsi, g_a, g_b);
    g_n1 += g_a * ci;
    g_ci += g_a * n1;
    g_n2 += g_b * m.kappa;
    float g_kappa = g_b * n2;
    g_a = 0.0f;
    g_b = 0.0f;
    tir_r_ct(n2 * ci, n1 * m.kappa, g_rpr, g_rpi, g_a, g_b);
    g_n2 += g_a * ci;
    g_ci += g_a * n2;
    g_n1 += g_b * m.kappa;
    g_kappa += g_b * n1;
    if (sin2 - 1.0f >= 0.0f) g_sin2 += g_kappa * 0.5f / m.kappa;
    return;
  }
  const float ds = n1 * ci + n2 * ct + 1e-12f, dp = n2 * ci + n1 * ct + 1e-12f;
  const float num = 2.0f * n1 * ci;
  const float A = fmaxf(n2 * ct, 0.0f), B = fmaxf(n1 * ci, 1e-12f);
  const float flux = sqrtf(A / B);
  const float tsr = num / ds, tpr = num / dp;
  // ts = tsr flux, tp = tpr flux
  const float g_flux = g_ts * tsr + g_tp * tpr;
  float g_tsr = g_ts * flux, g_tpr = g_tp * flux;
  float g_num = g_tsr / ds + g_tpr / dp;
  float g_ds = -(g_tsr * num / (ds * ds)), g_dp = -(g_tpr * num / (dp * dp));
  // rs = (n1 ci - n2 ct) / ds, rp = (n2 ci - n1 ct) / dp
  const float as = n1 * ci - n2 * ct, ap = n2 * ci - n1 * ct;
  const float g_as = g_rsr / ds, g_ap = g_rpr / dp;
  g_ds -= g_rsr * as / (ds * ds);
  g_dp -= g_rpr * ap / (dp * dp);
  float g_ct = 0.0f;
  // flux = sqrt(A / B)
  const float g_q = g_flux * 0.5f / flux;
  const float g_A = g_q / B, g_B = -(g_q * A / (B * B));
  if (n2 * ct >= 0.0f) {
    g_n2 += g_A * ct;
    g_ct += g_A * n2;
  }
  if (n1 * ci >= 1e-12f) {
    g_n1 += g_B * ci;
    g_ci += g_B * n1;
  }
  // num = 2 n1 ci
  g_n1 += 2.0f * g_num * ci;
  g_ci += g_num * 2.0f * n1;
  // ds = n1 ci + n2 ct, dp = n2 ci + n1 ct; as, ap
  g_n1 += (g_ds + g_as) * ci + (g_dp - g_ap) * ct;
  g_n2 += (g_ds - g_as) * ct + (g_dp + g_ap) * ci;
  g_ci += (g_ds + g_as) * n1 + (g_dp + g_ap) * n2;
  g_ct += (g_ds - g_as) * n2 + (g_dp - g_ap) * n1;
  // ct = sqrt(max(1 - sin2, 0))
  if (1.0f - sin2 >= 0.0f) g_sin2 -= g_ct * 0.5f / ct;
}

// ---- the polarized reflectance (core/static_dispatch.py::polarized_RT) ----

// The field's s and p powers (|Es|^2, |Ep|^2) on the basis b.
RTT_FD_HD void sp_powers(const Fld& e, const SpBasis& b, float& fs, float& fp) {
  const float sr = fdot(e.r, b.s), si = fdot(e.i, b.s);
  const float pr = fdot(e.r, b.p), pi = fdot(e.i, b.p);
  fs = sr * sr + si * si;
  fp = pr * pr + pi * pi;
}

// R_pol = (Rs fs + Rp fp) / max(fs + fp, 1e-20) of a bare interface away
// from TIR, Rs and Rp the squares of fresnel_R's two ratios (1e-8 in each
// denominator) at (ci, ct, n1, n2).
struct PolR {
  float R, rs, rp, fs, fp, xs, xp;
};

RTT_FD_HD PolR polarized_r(const Fld& e, const SpBasis& b, float ci, float ct, float n1,
                           float n2) {
  PolR o;
  o.xs = (n1 * ci - n2 * ct) / (n1 * ci + n2 * ct + 1e-8f);
  o.xp = (n1 * ct - n2 * ci) / (n1 * ct + n2 * ci + 1e-8f);
  o.rs = o.xs * o.xs;
  o.rp = o.xp * o.xp;
  sp_powers(e, b, o.fs, o.fp);
  o.R = (o.rs * o.fs + o.rp * o.fp) / fmaxf(o.fs + o.fp, 1e-20f);
  return o;
}

// Adjoint of polarized_r's weighting: g_R adds the cotangents of the field
// (g_e) and of the basis (g_s, g_p), and returns those of Rs and Rp.
RTT_FD_HD void polarized_r_ct(const Fld& e, const SpBasis& b, const PolR& o, float g_R,
                              Fld& g_e, F3& g_s, F3& g_p, float& g_rs, float& g_rp) {
  const float sum = o.fs + o.fp;
  const float frac = fmaxf(sum, 1e-20f);
  const float g_num = g_R / frac;
  const float g_frac = -(g_R * (o.rs * o.fs + o.rp * o.fp) / (frac * frac));
  const float g_sum = sum >= 1e-20f ? g_frac : 0.0f;
  const float g_fs = g_num * o.rs + g_sum, g_fp = g_num * o.rp + g_sum;
  g_rs = g_num * o.fs;
  g_rp = g_num * o.fp;
  const float sr = fdot(e.r, b.s), si = fdot(e.i, b.s);
  const float pr = fdot(e.r, b.p), pi = fdot(e.i, b.p);
  const float g_sr = 2.0f * sr * g_fs, g_si = 2.0f * si * g_fs;
  const float g_pr = 2.0f * pr * g_fp, g_pi = 2.0f * pi * g_fp;
  g_e.r = faxpy(faxpy(g_e.r, g_sr, b.s), g_pr, b.p);
  g_e.i = faxpy(faxpy(g_e.i, g_si, b.s), g_pi, b.p);
  g_s = faxpy(faxpy(g_s, g_sr, e.r), g_si, e.i);
  g_p = faxpy(faxpy(g_p, g_pr, e.r), g_pi, e.i);
}

// R_pol and T_pol = (Rs fs + Rp fp, Ts fs + Tp fp) / max(fs + fp, 1e-20)
// of a coated interface or a metal mirror (core/static_dispatch.py::
// polarized_RT; the metal's polarized R in apply_physics_one), Rs, Rp, Ts,
// Tp from its stack.
struct PolRT {
  float R, T, fs, fp, rs, rp, ts, tp;
};

RTT_FD_HD PolRT polarized_rt(const Fld& e, const SpBasis& b, float rs, float rp, float ts,
                             float tp) {
  PolRT o;
  sp_powers(e, b, o.fs, o.fp);
  o.rs = rs;
  o.rp = rp;
  o.ts = ts;
  o.tp = tp;
  const float frac = fmaxf(o.fs + o.fp, 1e-20f);
  o.R = (rs * o.fs + rp * o.fp) / frac;
  o.T = (ts * o.fs + tp * o.fp) / frac;
  return o;
}

// Adjoint of polarized_rt: g_R, g_T add the cotangents of the field (g_e)
// and of the basis (g_s, g_p), and return those of Rs, Rp, Ts and Tp.
RTT_FD_HD void polarized_rt_ct(const Fld& e, const SpBasis& b, const PolRT& o, float g_R,
                               float g_T, Fld& g_e, F3& g_s, F3& g_p, float& g_rs, float& g_rp,
                               float& g_ts, float& g_tp) {
  const float sum = o.fs + o.fp;
  const float frac = fmaxf(sum, 1e-20f);
  const float g_nr = g_R / frac, g_nt = g_T / frac;
  const float g_frac = -(g_R * o.R + g_T * o.T) / frac;
  const float g_sum = sum >= 1e-20f ? g_frac : 0.0f;
  const float g_fs = g_nr * o.rs + g_nt * o.ts + g_sum;
  const float g_fp = g_nr * o.rp + g_nt * o.tp + g_sum;
  g_rs = g_nr * o.fs;
  g_rp = g_nr * o.fp;
  g_ts = g_nt * o.fs;
  g_tp = g_nt * o.fp;
  const float sr = fdot(e.r, b.s), si = fdot(e.i, b.s);
  const float pr = fdot(e.r, b.p), pi = fdot(e.i, b.p);
  const float g_sr = 2.0f * sr * g_fs, g_si = 2.0f * si * g_fs;
  const float g_pr = 2.0f * pr * g_fp, g_pi = 2.0f * pi * g_fp;
  g_e.r = faxpy(faxpy(g_e.r, g_sr, b.s), g_pr, b.p);
  g_e.i = faxpy(faxpy(g_e.i, g_si, b.s), g_pi, b.p);
  g_s = faxpy(faxpy(g_s, g_sr, e.r), g_si, e.i);
  g_p = faxpy(faxpy(g_p, g_pr, e.r), g_pi, e.i);
}

// ---- the waveplate crystals (utils/birefringence.py) ----

// n^2 of one index of crystal `xtal` (1 quartz, 2 MgF2, 3 calcite; `side`
// 0 ordinary, 1 extraordinary) at l2 = lambda^2 (lambda in um), and
// d(n^2)/d(l2) into *dn2.  kCrystalCoef holds per crystal the ordinary then
// the extraordinary index's coefficients: Ghosh's form n^2 = A + B l2 /
// (l2 - C) + D l2 / (l2 - E) as (A, B, C, D, E, 0) (quartz, calcite), or
// the three-term Sellmeier n^2 = 1 + sum B_i l2 / (l2 - C_i^2) as (B1, C1,
// B2, C2, B3, C3) (MgF2).  A local table: device code reads no namespace
// array.  tests/test_torch_field_kernels.py parses it.
RTT_FD_HD float crystal_n2(int xtal, int side, float l2, float* dn2) {
  constexpr float kCrystalCoef[3][2][6] = {
      // QUARTZ
      {{1.28604141f, 1.07044083f, 1.00585997e-2f, 1.10202242f, 100.0f, 0.0f},
       {1.28851804f, 1.09509924f, 1.02101864e-2f, 1.15662475f, 100.0f, 0.0f}},
      // MGF2
      {{0.48755108f, 0.04338408f, 0.39875031f, 0.09461442f, 2.3120353f, 23.793604f},
       {0.41344023f, 0.03684262f, 0.50497499f, 0.09076162f, 2.4904862f, 23.771995f}},
      // CALCITE
      {{1.73358749f, 0.96464345f, 1.94325203e-2f, 1.82831454f, 120.0f, 0.0f},
       {1.35859695f, 0.82427830f, 1.06689543e-2f, 0.14429128f, 120.0f, 0.0f}},
  };
  const float* c = kCrystalCoef[xtal - 1][side];
  if (xtal != 2) {
    const float u = l2 - c[2], v = l2 - c[4];
    *dn2 = -(c[1] * c[2]) / (u * u) - c[3] * c[4] / (v * v);
    return c[0] + c[1] * l2 / u + c[3] * l2 / v;
  }
  float n2 = 1.0f, d = 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float cc = c[2 * j + 1] * c[2 * j + 1];
    const float u = l2 - cc;
    n2 = n2 + c[2 * j] * l2 / u;
    d -= c[2 * j] * cc / (u * u);
  }
  *dn2 = d;
  return n2;
}

// dn = n_e - n_o of crystal `xtal` (1 quartz, 2 MgF2, 3 calcite) at lam um,
// and d(dn)/d(lam) into *ddn.
RTT_FD_HD float crystal_dn(int xtal, float lam, float* ddn) {
  const float l2 = lam * lam;
  float do2, de2;
  const float no = sqrtf(crystal_n2(xtal, 0, l2, &do2));
  const float ne = sqrtf(crystal_n2(xtal, 1, l2, &de2));
  *ddn = (de2 / (2.0f * ne) - do2 / (2.0f * no)) * 2.0f * lam;
  return ne - no;
}

// A JONES row's retardance (core/field.py::jones_retardance): delta = ret,
// times lam0 / lam on a chromatic plate (lam the ray's wavelength wl, or
// lam0 where it is unset), times dn(lam) / dn(lam0) of crystal `xtal` (0:
// none).  `jones` holds the row's static bits (bit 0 chromatic, bits 1-2
// the crystal).  With `g` (the cotangent of delta) not null, the
// cotangents of ret, lam0 and wl are added into g_ret, g_lam0 and g_wl.
RTT_FD_HD float jones_delta(int jones, float ret, float lam0, float wl, float g = 0.0f,
                            float* g_ret = nullptr, float* g_lam0 = nullptr,
                            float* g_wl = nullptr) {
  if (!(jones & 1)) {
    if (g_ret != nullptr) *g_ret += g;
    return ret;
  }
  const bool set = wl > 0.0f;
  const float lam = set ? wl : lam0;
  const float a = ret * lam0;
  const float b = a / lam;
  const int xtal = (jones >> 1) & 3;
  float delta = b, dn = 1.0f, dn0 = 1.0f, ddn = 0.0f, ddn0 = 0.0f;
  if (xtal != 0) {
    dn = crystal_dn(xtal, lam, &ddn);
    dn0 = crystal_dn(xtal, lam0, &ddn0);
    delta = b * dn / dn0;
  }
  if (g_ret != nullptr) {
    // delta = ((ret lam0) / lam) dn / dn0
    float g_b = g, g_lam = 0.0f, g_l0 = 0.0f;
    if (xtal != 0) {
      g_b = g * dn / dn0;
      const float g_dn = g * b / dn0;
      const float g_dn0 = -(g * b * dn / (dn0 * dn0));
      g_lam += g_dn * ddn;
      g_l0 += g_dn0 * ddn0;
    }
    const float g_a = g_b / lam;
    g_lam -= g_b * a / (lam * lam);
    *g_ret += g_a * lam0;
    g_l0 += g_a * ret;
    if (set)
      *g_wl += g_lam;
    else
      g_l0 += g_lam;
    *g_lam0 += g_l0;
  }
  return delta;
}

// ---- one row's transport (core/field.py::transport_field) ----

// What a row's transport reads.  n1, n2: the media of incidence and
// transmission (by the side of d . nw); imod: the row's intensity factor
// (after a fuzzy program's); theta, a1, a2, delta: a JONES row's angle,
// amplitudes and retardance (jones_delta); xw, yw: its Rw columns 0 and 1.
// stack: kStackCoated a Fresnel kind with layers, kStackMetal a metal
// mirror, else kStackNone; ts, tp, rs, rp: such a row's stack's complex
// amplitudes at the ray's incidence (thin_film.cuh::stack_field).
constexpr int kStackNone = 0, kStackCoated = 1, kStackMetal = 2;

struct FieldRow {
  int ph;
  F3 d, nd, nw;
  float n1, n2, imod;
  float theta, a1, a2, delta;
  F3 xw, yw;
  int stack;
  Cx ts, tp, rs, rp;
};

// The cotangents a row's transport adjoint adds (a stack's amplitudes':
// the caller takes them through the stack, thin_film.cuh::stack_field_ct).
struct FieldRowCt {
  F3 d, nd, nw;
  float n1, n2, imod;
  float theta, a1, a2, delta;
  F3 xw, yw;
  Cx ts, tp, rs, rp;
};

RTT_FD_HD bool field_fresnel_kind(int ph) {
  return ph == kFkSnell || ph == kFkFresnel || ph == kFkFresnelW || ph == kFkReflectW;
}

// (ar + i ai)(er + i ei)
RTT_FD_HD void cmul(float ar, float ai, float er, float ei, float& o_r, float& o_i) {
  o_r = ar * er - ai * ei;
  o_i = ar * ei + ai * er;
}

// Adjoint of cmul: the cotangents of (o_r, o_i) add those of a and e.
RTT_FD_HD void cmul_ct(float ar, float ai, float er, float ei, float g_r, float g_i, float& g_ar,
                       float& g_ai, float& g_er, float& g_ei) {
  g_ar += g_r * er + g_i * ei;
  g_ai += -(g_r * ei) + g_i * er;
  g_er += g_r * ar + g_i * ai;
  g_ei += -(g_r * ai) + g_i * ar;
}

// The JONES row's axes: e1 the projected (and normalized) Rw column, ax, bx
// the rotated ones.
struct JonesAxes {
  F3 w, e1u, e1, e2, ax, bx;
  float inv, c, ca, sa;
  bool degen;
};

RTT_FD_HD JonesAxes jones_axes(const FieldRow& fr) {
  JonesAxes j;
  const F3 d = fr.nd;
  const float cx = fdot(fr.xw, d);
  const F3 e1x = {fr.xw.x - cx * d.x, fr.xw.y - cx * d.y, fr.xw.z - cx * d.z};
  j.degen = fdot(e1x, e1x) < 1e-12f;
  j.w = j.degen ? fr.yw : fr.xw;
  j.c = fdot(j.w, d);
  j.e1u = j.degen ? F3{fr.yw.x - j.c * d.x, fr.yw.y - j.c * d.y, fr.yw.z - j.c * d.z} : e1x;
  j.inv = 1.0f / sqrtf(fdot(j.e1u, j.e1u) + 1e-24f);
  j.e1 = fscale(j.e1u, j.inv);
  j.e2 = fcross(d, j.e1);
  j.ca = cosf(fr.theta);
  j.sa = sinf(fr.theta);
  j.ax = {j.ca * j.e1.x + j.sa * j.e2.x, j.ca * j.e1.y + j.sa * j.e2.y,
          j.ca * j.e1.z + j.sa * j.e2.z};
  j.bx = {-j.sa * j.e1.x + j.ca * j.e2.x, -j.sa * j.e1.y + j.ca * j.e2.y,
          -j.sa * j.e1.z + j.ca * j.e2.z};
  return j;
}

// E on the basis (u, v) with complex amplitudes: u * (a_r + i a_i) + v *
// (b_r + i b_i).
RTT_FD_HD Fld rebuild(F3 u, float a_r, float a_i, F3 v, float b_r, float b_i) {
  return {fadd(fscale(u, a_r), fscale(v, b_r)), fadd(fscale(u, a_i), fscale(v, b_i))};
}

// Adjoint of rebuild: g (the new field's cotangent) adds those of u, v and
// of the amplitudes.
RTT_FD_HD void rebuild_ct(const Fld& g, F3 u, float a_r, float a_i, F3 v, float b_r, float b_i,
                          F3& g_u, F3& g_v, float& g_ar, float& g_ai, float& g_br, float& g_bi) {
  g_ar += fdot(g.r, u);
  g_ai += fdot(g.i, u);
  g_br += fdot(g.r, v);
  g_bi += fdot(g.i, v);
  g_u = faxpy(faxpy(g_u, a_r, g.r), a_i, g.i);
  g_v = faxpy(faxpy(g_v, b_r, g.r), b_i, g.i);
}

// The Fresnel transport's forward values (a metal mirror's too): the bases,
// the bare amplitudes m (not a metal's), the field's s/p components and the
// amplitudes taken, as (re, im): t_* transmission, r_* reflection (a
// coated row's its stack's, FieldRow::ts .. rp, but r under TIR).
struct FresnelT {
  SpBasis bi, bo;
  Amps m;
  float dot, ci, sin2;
  float es_r, es_i, ep_r, ep_i;
  float ts_r, ts_i, tp_r, tp_i, rs_r, rs_i, rp_r, rp_i;
  float as_r, as_i, ap_r, ap_i;
  bool reflected;
};

RTT_FD_HD FresnelT fresnel_transport(const FieldRow& fr, const Fld& e) {
  FresnelT t;
  t.dot = fdot(fr.d, fr.nw);
  t.ci = fabsf(t.dot);
  const bool metal = fr.stack == kStackMetal;
  t.sin2 = 0.0f;
  t.m = Amps{};
  if (!metal) {
    const float q = fr.n1 / fr.n2;
    t.sin2 = q * q * (1.0f - t.ci * t.ci);
    t.m = fresnel_amps(fr.n1, fr.n2, t.ci, t.sin2);
  }
  t.ts_r = t.m.ts;
  t.tp_r = t.m.tp;
  t.ts_i = t.tp_i = 0.0f;
  t.rs_r = t.m.rs_r;
  t.rs_i = t.m.rs_i;
  t.rp_r = t.m.rp_r;
  t.rp_i = t.m.rp_i;
  if (fr.stack != kStackNone) {
    t.ts_r = fr.ts.re;
    t.ts_i = fr.ts.im;
    t.tp_r = fr.tp.re;
    t.tp_i = fr.tp.im;
    if (!t.m.tir) {
      t.rs_r = fr.rs.re;
      t.rs_i = fr.rs.im;
      t.rp_r = fr.rp.re;
      t.rp_i = fr.rp.im;
    }
  }
  t.bi = sp_basis(fr.d, fr.nw);
  t.bo = sp_basis(fr.nd, fr.nw);
  t.es_r = fdot(e.r, t.bi.s);
  t.es_i = fdot(e.i, t.bi.s);
  t.ep_r = fdot(e.r, t.bi.p);
  t.ep_i = fdot(e.i, t.bi.p);
  t.reflected = metal || fdot(fr.nd, fr.nw) * t.dot < 0.0f;
  if (t.reflected) {
    cmul(t.rs_r, t.rs_i, t.es_r, t.es_i, t.as_r, t.as_i);
    cmul(t.rp_r, t.rp_i, t.ep_r, t.ep_i, t.ap_r, t.ap_i);
  } else {
    cmul(t.ts_r, t.ts_i, t.es_r, t.es_i, t.as_r, t.as_i);
    cmul(t.tp_r, t.tp_i, t.ep_r, t.ep_i, t.ap_r, t.ap_i);
  }
  return t;
}

// The renormalization of the Fresnel kinds: the new field scaled to the
// incoming |E|^2 (0 where the new one's power is 1e-20 or less).
RTT_FD_HD float renorm_scale(float p_in, float p_raw) {
  return p_raw > 1e-20f ? sqrtf(p_in / p_raw) : 0.0f;
}

// One row's transport of the field e (an active row; the caller keeps e
// where the row is inactive).
RTT_FD_HD Fld field_transport(const FieldRow& fr, const Fld& e) {
  if (field_fresnel_kind(fr.ph) || fr.stack == kStackMetal) {
    const FresnelT t = fresnel_transport(fr, e);
    Fld o = rebuild(t.bi.s, t.as_r, t.as_i, t.bo.p, t.ap_r, t.ap_i);
    if (fr.ph != kFkSnell) {
      const float sc = renorm_scale(fpower(e), fpower(o));
      o = {fscale(o.r, sc), fscale(o.i, sc)};
    }
    return o;
  }
  if (fr.ph == kFkJones) {
    const JonesAxes j = jones_axes(fr);
    const float ch = cosf(0.5f * fr.delta), sh = sinf(0.5f * fr.delta);
    float oa_r, oa_i, ob_r, ob_i;
    cmul(fr.a1 * ch, -(fr.a1 * sh), fdot(e.r, j.ax), fdot(e.i, j.ax), oa_r, oa_i);
    cmul(fr.a2 * ch, fr.a2 * sh, fdot(e.r, j.bx), fdot(e.i, j.bx), ob_r, ob_i);
    return rebuild(j.ax, oa_r, oa_i, j.bx, ob_r, ob_i);
  }
  if (fr.ph == kFkDoe || fr.ph == kFkPhaseGrid) {
    const SpBasis bi = sp_basis(fr.d, fr.nw), bo = sp_basis(fr.nd, fr.nw);
    const float amp = sqrtf(fmaxf(fr.imod, 0.0f));
    return rebuild(bi.s, amp * fdot(e.r, bi.s), amp * fdot(e.i, bi.s), bo.p,
                   amp * fdot(e.r, bi.p), amp * fdot(e.i, bi.p));
  }
  if (fr.ph == kFkReflect)
    return {faxpy(e.r, -2.0f * fdot(e.r, fr.nw), fr.nw),
            faxpy(e.i, -2.0f * fdot(e.i, fr.nw), fr.nw)};
  if (fr.ph == kFkBlock) return {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  const float amp = sqrtf(fmaxf(fr.imod, 0.0f));
  return {fscale(e.r, amp), fscale(e.i, amp)};
}

// Adjoint of field_transport: g_o, the cotangent of the new field, gives
// the incoming field's (returned) and adds into c the cotangents of the
// row's inputs.
RTT_FD_HD Fld field_transport_ct(const FieldRow& fr, const Fld& e, const Fld& g_o,
                                 FieldRowCt& c) {
  Fld g_e = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (field_fresnel_kind(fr.ph) || fr.stack == kStackMetal) {
    const FresnelT t = fresnel_transport(fr, e);
    Fld g_raw = g_o;
    if (fr.ph != kFkSnell) {
      // o = raw sc, sc = sqrt(p_in / p_raw) where p_raw > 1e-20, else 0
      const Fld raw = rebuild(t.bi.s, t.as_r, t.as_i, t.bo.p, t.ap_r, t.ap_i);
      const float p_in = fpower(e), p_raw = fpower(raw);
      const float sc = renorm_scale(p_in, p_raw);
      g_raw = {fscale(g_o.r, sc), fscale(g_o.i, sc)};
      if (p_raw > 1e-20f) {
        const float g_sc = fdot(g_o.r, raw.r) + fdot(g_o.i, raw.i);
        const float g_q = g_sc * 0.5f / sc;
        const float g_pin = g_q / p_raw, g_praw = -(g_q * p_in / (p_raw * p_raw));
        g_e.r = faxpy(g_e.r, 2.0f * g_pin, e.r);
        g_e.i = faxpy(g_e.i, 2.0f * g_pin, e.i);
        g_raw.r = faxpy(g_raw.r, 2.0f * g_praw, raw.r);
        g_raw.i = faxpy(g_raw.i, 2.0f * g_praw, raw.i);
      }
    }
    F3 g_s = {0.0f, 0.0f, 0.0f}, g_pin = {0.0f, 0.0f, 0.0f}, g_pout = {0.0f, 0.0f, 0.0f};
    float g_asr = 0.0f, g_asi = 0.0f, g_apr = 0.0f, g_api = 0.0f;
    rebuild_ct(g_raw, t.bi.s, t.as_r, t.as_i, t.bo.p, t.ap_r, t.ap_i, g_s, g_pout, g_asr, g_asi,
               g_apr, g_api);
    float g_esr = 0.0f, g_esi = 0.0f, g_epr = 0.0f, g_epi = 0.0f;
    float g_tsr = 0.0f, g_tsi = 0.0f, g_tpr = 0.0f, g_tpi = 0.0f;
    float g_rsr = 0.0f, g_rsi = 0.0f, g_rpr = 0.0f, g_rpi = 0.0f;
    if (t.reflected) {
      cmul_ct(t.rs_r, t.rs_i, t.es_r, t.es_i, g_asr, g_asi, g_rsr, g_rsi, g_esr, g_esi);
      cmul_ct(t.rp_r, t.rp_i, t.ep_r, t.ep_i, g_apr, g_api, g_rpr, g_rpi, g_epr, g_epi);
    } else {
      cmul_ct(t.ts_r, t.ts_i, t.es_r, t.es_i, g_asr, g_asi, g_tsr, g_tsi, g_esr, g_esi);
      cmul_ct(t.tp_r, t.tp_i, t.ep_r, t.ep_i, g_apr, g_api, g_tpr, g_tpi, g_epr, g_epi);
    }
    // es = (E . s), ep = (E . p_in)
    g_e.r = faxpy(faxpy(g_e.r, g_esr, t.bi.s), g_epr, t.bi.p);
    g_e.i = faxpy(faxpy(g_e.i, g_esi, t.bi.s), g_epi, t.bi.p);
    g_s = faxpy(faxpy(g_s, g_esr, e.r), g_esi, e.i);
    g_pin = faxpy(faxpy(g_pin, g_epr, e.r), g_epi, e.i);
    sp_basis_ct(t.bi, fr.d, fr.nw, g_s, g_pin, c.d, c.nw);
    sp_basis_ct(t.bo, fr.nd, fr.nw, F3{0.0f, 0.0f, 0.0f}, g_pout, c.nd, c.nw);
    float g_ci = 0.0f;
    if (fr.stack != kStackNone && !t.m.tir) {
      // a stack's amplitudes (a metal's m is zeros: never TIR); under TIR a
      // coated row reflects with the bare r, and its stack's t is not read
      c.ts = {c.ts.re + g_tsr, c.ts.im + g_tsi};
      c.tp = {c.tp.re + g_tpr, c.tp.im + g_tpi};
      c.rs = {c.rs.re + g_rsr, c.rs.im + g_rsi};
      c.rp = {c.rp.re + g_rpr, c.rp.im + g_rpi};
    }
    if (fr.stack != kStackMetal) {
      // the bare amplitudes of (n1, n2, ci, sin2); sin2 = (n1 / n2)^2 (1 -
      // ci^2); a coated row's are its stack's but under TIR, where it
      // reflects with the bare r alone
      float g_sin2 = 0.0f;
      if (fr.stack == kStackNone || t.m.tir)
        fresnel_amps_ct(fr.n1, fr.n2, t.ci, t.sin2, t.m, g_tsr, g_tpr, g_rsr, g_rsi, g_rpr,
                        g_rpi, c.n1, c.n2, g_ci, g_sin2);
      const float q = fr.n1 / fr.n2, om = 1.0f - t.ci * t.ci;
      const float g_q = g_sin2 * om * 2.0f * q;
      g_ci += g_sin2 * q * q * (-2.0f * t.ci);
      c.n1 += g_q / fr.n2;
      c.n2 -= g_q * fr.n1 / (fr.n2 * fr.n2);
    }
    // ci = |d . nw|
    const float g_dot = g_ci * fsign(t.dot);
    c.d = faxpy(c.d, g_dot, fr.nw);
    c.nw = faxpy(c.nw, g_dot, fr.d);
    return g_e;
  }
  if (fr.ph == kFkJones) {
    const JonesAxes j = jones_axes(fr);
    const F3 d = fr.nd;
    const float ch = cosf(0.5f * fr.delta), sh = sinf(0.5f * fr.delta);
    const float j1r = fr.a1 * ch, j1i = -(fr.a1 * sh), j2r = fr.a2 * ch, j2i = fr.a2 * sh;
    const float ea_r = fdot(e.r, j.ax), ea_i = fdot(e.i, j.ax);
    const float eb_r = fdot(e.r, j.bx), eb_i = fdot(e.i, j.bx);
    float oa_r, oa_i, ob_r, ob_i;
    cmul(j1r, j1i, ea_r, ea_i, oa_r, oa_i);
    cmul(j2r, j2i, eb_r, eb_i, ob_r, ob_i);
    F3 g_ax = {0.0f, 0.0f, 0.0f}, g_bx = {0.0f, 0.0f, 0.0f};
    float g_oar = 0.0f, g_oai = 0.0f, g_obr = 0.0f, g_obi = 0.0f;
    rebuild_ct(g_o, j.ax, oa_r, oa_i, j.bx, ob_r, ob_i, g_ax, g_bx, g_oar, g_oai, g_obr, g_obi);
    float g_j1r = 0.0f, g_j1i = 0.0f, g_j2r = 0.0f, g_j2i = 0.0f;
    float g_ear = 0.0f, g_eai = 0.0f, g_ebr = 0.0f, g_ebi = 0.0f;
    cmul_ct(j1r, j1i, ea_r, ea_i, g_oar, g_oai, g_j1r, g_j1i, g_ear, g_eai);
    cmul_ct(j2r, j2i, eb_r, eb_i, g_obr, g_obi, g_j2r, g_j2i, g_ebr, g_ebi);
    g_e.r = faxpy(faxpy(g_e.r, g_ear, j.ax), g_ebr, j.bx);
    g_e.i = faxpy(faxpy(g_e.i, g_eai, j.ax), g_ebi, j.bx);
    g_ax = faxpy(faxpy(g_ax, g_ear, e.r), g_eai, e.i);
    g_bx = faxpy(faxpy(g_bx, g_ebr, e.r), g_ebi, e.i);
    // j1 = (a1 ch, -a1 sh), j2 = (a2 ch, a2 sh)
    c.a1 += g_j1r * ch - g_j1i * sh;
    c.a2 += g_j2r * ch + g_j2i * sh;
    const float g_ch = g_j1r * fr.a1 + g_j2r * fr.a2;
    const float g_sh = -(g_j1i * fr.a1) + g_j2i * fr.a2;
    c.delta += 0.5f * (-(g_ch * sh) + g_sh * ch);
    // ax = ca e1 + sa e2, bx = -sa e1 + ca e2
    const float g_ca = fdot(g_ax, j.e1) + fdot(g_bx, j.e2);
    const float g_sa = fdot(g_ax, j.e2) - fdot(g_bx, j.e1);
    c.theta += -(g_ca * j.sa) + g_sa * j.ca;
    F3 g_e1 = faxpy(fscale(g_ax, j.ca), -j.sa, g_bx);
    const F3 g_e2 = faxpy(fscale(g_ax, j.sa), j.ca, g_bx);
    // e2 = d x e1
    c.nd = fadd(c.nd, fcross(j.e1, g_e2));
    g_e1 = fadd(g_e1, fcross(g_e2, d));
    // e1 = e1u inv, inv = 1 / sqrt(|e1u|^2 + 1e-24)
    const float g_inv = fdot(g_e1, j.e1u);
    F3 g_e1u = fscale(g_e1, j.inv);
    const float g_n = -(g_inv * j.inv * j.inv) * 0.5f * j.inv;
    g_e1u = faxpy(g_e1u, 2.0f * g_n, j.e1u);
    // e1u = w - (w . d) d
    const float g_c = -fdot(g_e1u, d);
    c.nd = faxpy(c.nd, -j.c, g_e1u);
    c.nd = faxpy(c.nd, g_c, j.w);
    const F3 g_w = faxpy(g_e1u, g_c, d);
    if (j.degen)
      c.yw = fadd(c.yw, g_w);
    else
      c.xw = fadd(c.xw, g_w);
    return g_e;
  }
  if (fr.ph == kFkDoe || fr.ph == kFkPhaseGrid) {
    const SpBasis bi = sp_basis(fr.d, fr.nw), bo = sp_basis(fr.nd, fr.nw);
    const float amp = sqrtf(fmaxf(fr.imod, 0.0f));
    const float es_r = fdot(e.r, bi.s), es_i = fdot(e.i, bi.s);
    const float ep_r = fdot(e.r, bi.p), ep_i = fdot(e.i, bi.p);
    F3 g_s = {0.0f, 0.0f, 0.0f}, g_pin = {0.0f, 0.0f, 0.0f}, g_pout = {0.0f, 0.0f, 0.0f};
    float g_asr = 0.0f, g_asi = 0.0f, g_apr = 0.0f, g_api = 0.0f;
    rebuild_ct(g_o, bi.s, amp * es_r, amp * es_i, bo.p, amp * ep_r, amp * ep_i, g_s, g_pout,
               g_asr, g_asi, g_apr, g_api);
    const float g_amp = g_asr * es_r + g_asi * es_i + g_apr * ep_r + g_api * ep_i;
    if (fr.imod >= 0.0f) c.imod += g_amp * 0.5f / amp;
    g_e.r = faxpy(faxpy(g_e.r, amp * g_asr, bi.s), amp * g_apr, bi.p);
    g_e.i = faxpy(faxpy(g_e.i, amp * g_asi, bi.s), amp * g_api, bi.p);
    g_s = faxpy(faxpy(g_s, amp * g_asr, e.r), amp * g_asi, e.i);
    g_pin = faxpy(faxpy(g_pin, amp * g_apr, e.r), amp * g_api, e.i);
    sp_basis_ct(bi, fr.d, fr.nw, g_s, g_pin, c.d, c.nw);
    sp_basis_ct(bo, fr.nd, fr.nw, F3{0.0f, 0.0f, 0.0f}, g_pout, c.nd, c.nw);
    return g_e;
  }
  if (fr.ph == kFkReflect) {
    // E' = E - 2 (E . n) n, real and imaginary parts alike
    const F3 n = fr.nw;
    const float sr = fdot(e.r, n), si = fdot(e.i, n);
    const float gr = fdot(g_o.r, n), gi = fdot(g_o.i, n);
    g_e.r = faxpy(g_o.r, -2.0f * gr, n);
    g_e.i = faxpy(g_o.i, -2.0f * gi, n);
    c.nw = faxpy(faxpy(c.nw, -2.0f * sr, g_o.r), -2.0f * gr, e.r);
    c.nw = faxpy(faxpy(c.nw, -2.0f * si, g_o.i), -2.0f * gi, e.i);
    return g_e;
  }
  if (fr.ph == kFkBlock) return g_e;
  const float amp = sqrtf(fmaxf(fr.imod, 0.0f));
  if (fr.imod >= 0.0f) c.imod += (fdot(g_o.r, e.r) + fdot(g_o.i, e.i)) * 0.5f / amp;
  return {fscale(g_o.r, amp), fscale(g_o.i, amp)};
}

}  // namespace rtt
