// Thin-film stacks and metal substrates for the fused kernels' coated
// instantiation (kCoat): the intensity reflectance and transmittance of a
// multilayer by the characteristic-matrix method, and its adjoint.
//
// The plain version is utils/coatings.py (coating_rt, metal_reflectance),
// itself the JAX package's utils/coatings.py; the kernels' callers are in
// trace_seq_common.cuh (coated FRESNEL, FRESNEL_W, REFLECT_W and metal
// REFLECT rows) and trace_seq_adjoint.cuh.  The arithmetic follows the plain
// version line by line, in its order, with every clamp it has: 1e-12 under
// a layer's real cosine, 1e-30 and 1e-24 in the complex square root, 1e-24
// on every complex division and on |eta0 B + C|^2, 1e-6 under the p
// admittance and the substrate index; the complex square root takes its
// smaller half without the JAX package's cancellation, as the plain
// version does (utils/coatings.py::_c_sqrt).
//
// Two paths, chosen per row, as in the plain version:
// - real (dielectric layers): a layer's cosine by Snell's law, real; the
//   substrate a dielectric (real admittance) or a metal n - ik (complex
//   admittance, metal_eta);
// - complex (some layer absorbs, k != 0): every layer's index n - ik, its
//   cosine, admittance and phase thickness complex, cos and sin of the
//   phase by exp sums (c_trig).
// A stack of more than one layer that a ray meets from its higher-index
// side is read in reverse order (`rev`): one pass in the order the ray
// needs, not both orders and a select.
//
// The adjoint is reverse mode through the layer product: the forward pass
// saves the (B, C) vector before each layer (8 complex pairs at most, in
// local memory), and the reverse pass recomputes each layer's own values
// (its cosine, admittance and phase) and reverses its update, then the
// substrate's and the incidence medium's.  Every clamp's derivative is
// autograd's of the plain version, which takes torch.maximum (as
// jnp.maximum): zero below the bound, half at a tie, all of it above.  At
// exactly normal incidence 1 - cos_i^2 sits on its bound 0 and the complex
// square roots on their +1e-24 floors: the derivatives there are finite
// and equal the plain version's.
//
// The functions are __host__ __device__ and use no CUDA type, so the same
// source compiles as plain C++ for a host check against autograd; they are
// __noinline__ on the device, so that a kernel's ray state is not spilled
// around the stack's registers at every row that has none.
//
// The polarized field (field.cuh) reads a stack's R, T and complex
// amplitudes (r and the flux-normalized t) from one (B, C) per polarization
// (stack_field) and their adjoint through one reverse sweep
// (stack_field_ct), whose layer sweep (stack_bc_ct) repeats stack_rt_ct's.
//
// Cost (the bound's count, PERF.md): per coated row, ray and polarization,
// for each layer one sin and one cos and about 30 floating-point operations
// on the real path; the complex path adds a complex square root, two
// complex divisions and two exp; the adjoint about three times the
// forward.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define RTT_TF_HD __host__ __device__ __forceinline__
#define RTT_TF_NOINLINE __host__ __device__ __noinline__
#else
#define RTT_TF_HD inline
#define RTT_TF_NOINLINE
#endif

namespace rtt {

constexpr int kMaxCoatLayers = 8;
// The per-row side buffer of the coated instantiation: the layers'
// extinction coefficients (absorbing stacks), then a dispersive metal's 6 n
// and 6 k knots on METAL_GRID_UM (ops/fused_trace.py::coat_side).
constexpr int kCoatSide = 20;
constexpr int kSideK = 0, kSideKnotN = 8, kSideKnotK = 14;
// A coated row's static data in its kinds row's physics column, above the
// kind (bits 0-7) and the dispersion (bits 8-11): the layer count, and
// whether the row is a metal mirror, whose metal disperses, or whose stack
// absorbs (ops/fused_trace.py::COAT_SHIFT).
constexpr int kCoatShift = 12;
constexpr int kCoatCountMask = 0xf;
constexpr int kCoatMetal = 1 << 4, kCoatMetalNk = 1 << 5, kCoatAbsorbing = 1 << 6;

// 2 pi as the plain version's float32 product reads it
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kDLineUm = 0.5876f;

// METAL_GRID_UM's knot i, in double: each segment's width is taken in
// double, as the plain version's Python floats are, then rounded once
RTT_TF_HD constexpr double metal_grid(int i) {
  return i == 0 ? 0.40 : i == 1 ? 0.50 : i == 2 ? 0.60 : i == 3 ? 0.70 : i == 4 ? 0.80 : 1.00;
}

struct Cx {
  float re, im;
};

RTT_TF_HD Cx cmul(Cx a, Cx b) { return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re}; }

// g conj(b): the cotangent of a in a b (and of b with a) from g, a b's
RTT_TF_HD Cx cmul_ct(Cx g, Cx b) { return {g.re * b.re + g.im * b.im, g.im * b.re - g.re * b.im}; }

RTT_TF_HD Cx cadd(Cx a, Cx b) { return {a.re + b.re, a.im + b.im}; }

// The derivative of max(x, c) (jnp.maximum, torch.maximum): all of g above
// the bound, half at a tie, none below.
RTT_TF_HD float max_ct(float x, float c, float g) {
  return x > c ? g : (x == c ? 0.5f * g : 0.0f);
}

RTT_TF_HD Cx cdiv(Cx a, Cx b) {
  const float den = fmaxf(b.re * b.re + b.im * b.im, 1e-24f);
  return {(a.re * b.re + a.im * b.im) / den, (a.im * b.re - a.re * b.im) / den};
}

// Adjoint of z = cdiv(a, b): g, z's cotangent, adds a's and b's.
RTT_TF_HD void cdiv_ct(Cx a, Cx b, Cx g, Cx& ga, Cx& gb) {
  const float b2 = b.re * b.re + b.im * b.im;
  const float den = fmaxf(b2, 1e-24f);
  const Cx z = {(a.re * b.re + a.im * b.im) / den, (a.im * b.re - a.re * b.im) / den};
  const float gnr = g.re / den, gni = g.im / den;
  const float g_den = -(g.re * z.re + g.im * z.im) / den;
  ga.re += gnr * b.re - gni * b.im;
  ga.im += gnr * b.im + gni * b.re;
  gb.re += gnr * a.re + gni * a.im;
  gb.im += gnr * a.im - gni * a.re;
  const float g_b2 = max_ct(b2, 1e-24f, g_den);
  gb.re += 2.0f * b.re * g_b2;
  gb.im += 2.0f * b.im * g_b2;
}

// The principal square root, with the plain version's floors and its
// cancellation-free smaller half: (|a| + |Re a|) / 2 and Im(a)^2 / (2 (|a| +
// |Re a|)) (utils/coatings.py::_c_sqrt says why).
struct CsqrtFwd {
  float r2, r, s, big, small, xr, xi, re, im;
  bool pos;
};

RTT_TF_HD CsqrtFwd csqrt_fwd(Cx a) {
  CsqrtFwd f;
  f.r2 = a.re * a.re + a.im * a.im;
  f.r = sqrtf(fmaxf(f.r2, 1e-30f));
  f.s = f.r + fabsf(a.re);
  f.big = 0.5f * f.s;
  f.small = 0.5f * (a.im * a.im) / f.s;
  f.pos = a.re >= 0.0f;
  f.xr = f.pos ? f.big : f.small;
  f.xi = f.pos ? f.small : f.big;
  f.re = sqrtf(fmaxf(f.xr, 0.0f) + 1e-24f);
  f.im = sqrtf(fmaxf(f.xi, 0.0f) + 1e-24f);
  return f;
}

RTT_TF_HD Cx csqrt(Cx a) {
  const CsqrtFwd f = csqrt_fwd(a);
  return {f.re, a.im < 0.0f ? -f.im : f.im};
}

// Adjoint of csqrt: g, the root's cotangent -> a's.
RTT_TF_HD Cx csqrt_ct(Cx a, Cx g) {
  const CsqrtFwd f = csqrt_fwd(a);
  const float g_im = a.im < 0.0f ? -g.im : g.im;
  const float g_xr = max_ct(f.xr, 0.0f, g.re / (2.0f * f.re));
  const float g_xi = max_ct(f.xi, 0.0f, g_im / (2.0f * f.im));
  const float g_big = f.pos ? g_xr : g_xi, g_small = f.pos ? g_xi : g_xr;
  // big = s / 2, small = (Im a)^2 / 2 / s, s = |a| + |Re a|
  const float g_s = 0.5f * g_big - g_small * f.small / f.s;
  const float sgn = a.re > 0.0f ? 1.0f : (a.re < 0.0f ? -1.0f : 0.0f);
  const float g_r2 = max_ct(f.r2, 1e-30f, g_s / (2.0f * f.r));
  return {g_s * sgn + 2.0f * a.re * g_r2, g_small * a.im / f.s + 2.0f * a.im * g_r2};
}

// (cos, sin) of a complex phase (a, b), cosh and sinh as exp sums.
RTT_TF_HD void ctrig(Cx dl, Cx& c, Cx& s) {
  const float ca = cosf(dl.re), sa = sinf(dl.re);
  const float eb = expf(dl.im), enb = expf(-dl.im);
  const float chb = 0.5f * (eb + enb), shb = 0.5f * (eb - enb);
  c = {ca * chb, -sa * shb};
  s = {sa * chb, ca * shb};
}

// Adjoint of ctrig: gc, gs, the cotangents of cos and sin -> the phase's.
RTT_TF_HD Cx ctrig_ct(Cx dl, Cx gc, Cx gs) {
  const float ca = cosf(dl.re), sa = sinf(dl.re);
  const float eb = expf(dl.im), enb = expf(-dl.im);
  const float chb = 0.5f * (eb + enb), shb = 0.5f * (eb - enb);
  const float g_ca = gc.re * chb + gs.im * shb;
  const float g_sa = -gc.im * shb + gs.re * chb;
  const float g_chb = gc.re * ca + gs.re * sa;
  const float g_shb = -gc.im * sa + gs.im * ca;
  const float g_eb = 0.5f * (g_chb + g_shb), g_enb = 0.5f * (g_chb - g_shb);
  return {-g_ca * sa + g_sa * ca, g_eb * eb - g_enb * enb};
}

// One stack evaluation's inputs: the row's coat columns (index, thickness)
// per layer, outermost first; the layers' extinction (the complex path); the
// order; the media and the substrate's extinction (a metal); the cosine of
// incidence and the wavelength (um).
struct StackIn {
  const float* coat;
  const float* k;
  int n;
  bool rev, absorbing, metal;
  float n_in, n_out, k_out, cos_i, lam;
};

// The cotangents of a stack's inputs (d in the coat columns' layer order).
struct StackCt {
  float n_in, n_out, k_out, cos_i, lam;
  float d[kMaxCoatLayers];
};

// The storage index of the layer the ray meets j-th.
RTT_TF_HD int layer_at(const StackIn& a, int j) { return a.rev ? a.n - 1 - j : j; }

// The complex cosine of a layer of index nc by Snell's law from the
// invariant kin2 = (n_in sin_i)^2: csqrt(1 - kin2 / nc^2).
RTT_TF_HD Cx c_cos(float kin2, Cx nc) {
  const Cx r2 = cdiv(Cx{kin2, 0.0f}, cmul(nc, nc));
  return csqrt(Cx{1.0f - r2.re, -r2.im});
}

// Adjoint of c_cos: g, the cosine's cotangent, adds kin2's and nc's.
RTT_TF_HD void c_cos_ct(float kin2, Cx nc, Cx g, float& g_kin2, Cx& g_nc) {
  const Cx nc2 = cmul(nc, nc);
  const Cx r2 = cdiv(Cx{kin2, 0.0f}, nc2);
  const Cx g_arg = csqrt_ct(Cx{1.0f - r2.re, -r2.im}, g);
  Cx g_a = {0.0f, 0.0f}, g_nc2 = {0.0f, 0.0f};
  cdiv_ct(Cx{kin2, 0.0f}, nc2, Cx{-g_arg.re, -g_arg.im}, g_a, g_nc2);
  g_kin2 += g_a.re;
  const Cx g1 = cmul_ct(g_nc2, nc);  // both factors are nc
  g_nc.re += 2.0f * g1.re;
  g_nc.im += 2.0f * g1.im;
}

// The tilted admittance of index nc with cosine cl: s nc cl, p nc / cl.
RTT_TF_HD Cx c_eta(Cx nc, Cx cl, bool p) { return p ? cdiv(nc, cl) : cmul(nc, cl); }

RTT_TF_HD void c_eta_ct(Cx nc, Cx cl, bool p, Cx g, Cx& g_nc, Cx& g_cl) {
  if (p) {
    cdiv_ct(nc, cl, g, g_nc, g_cl);
  } else {
    const Cx a = cmul_ct(g, cl), b = cmul_ct(g, nc);
    g_nc = cadd(g_nc, a);
    g_cl = cadd(g_cl, b);
  }
}

// The incidence medium's admittance: s n cos_i, p n / max(cos_i, 1e-6).
RTT_TF_HD float eta0_of(float n_in, float cos_i, bool p) {
  return p ? n_in / fmaxf(cos_i, 1e-6f) : n_in * cos_i;
}

// ---- The real path (dielectric layers) ----

// A layer's real cosine from sin_i2 = max(1 - cos_i^2, 0).
RTT_TF_HD float real_cos(float n_in, float nl, float sin_i2) {
  const float ratio = n_in / nl;
  return sqrtf(fmaxf(1.0f - ratio * ratio * sin_i2, 1e-12f));
}

RTT_TF_HD float real_eta(float n, float c, bool p) { return p ? n / fmaxf(c, 1e-6f) : n * c; }

// (B, C) before each layer is applied into `saved` (2 per layer, in the
// order applied), when given; returns the final (B, C).
RTT_TF_HD void stack_real_bc(const StackIn& a, bool p, float sin_i2, Cx eta_sub, Cx& B, Cx& C,
                             Cx* saved) {
  B = {1.0f, 0.0f};
  C = eta_sub;
  for (int j = a.n - 1; j >= 0; --j) {
    const int s = layer_at(a, j);
    const float nl = a.coat[2 * s], dl = a.coat[2 * s + 1];
    const float cl = real_cos(a.n_in, nl, sin_i2);
    const float delta = kTwoPi * nl * dl * cl / a.lam;
    const float cd = cosf(delta), sd = sinf(delta);
    const float el = real_eta(nl, cl, p);
    const float q = sd / el, w = el * sd;
    if (saved != nullptr) {
      saved[2 * j] = B;
      saved[2 * j + 1] = C;
    }
    const Cx nB = {cd * B.re - q * C.im, cd * B.im + q * C.re};
    const Cx nC = {cd * C.re - w * B.im, cd * C.im + w * B.re};
    B = nB;
    C = nC;
  }
}

// ---- The complex path (absorbing layers) ----

RTT_TF_HD void stack_cx_bc(const StackIn& a, bool p, float kin2, Cx eta_sub, Cx& B, Cx& C,
                           Cx* saved) {
  B = {1.0f, 0.0f};
  C = eta_sub;
  for (int j = a.n - 1; j >= 0; --j) {
    const int s = layer_at(a, j);
    const Cx nc = {a.coat[2 * s], -a.k[s]};
    const Cx cl = c_cos(kin2, nc);
    const Cx el = c_eta(nc, cl, p);
    const float phase = kTwoPi * a.coat[2 * s + 1] / a.lam;
    const Cx dlt = cmul(nc, cl);
    Cx cd, sd;
    ctrig(Cx{phase * dlt.re, phase * dlt.im}, cd, sd);
    const Cx isd = {-sd.im, sd.re};
    if (saved != nullptr) {
      saved[2 * j] = B;
      saved[2 * j + 1] = C;
    }
    const Cx nB = cadd(cmul(cd, B), cmul(cdiv(isd, el), C));
    const Cx nC = cadd(cmul(cmul(isd, el), B), cmul(cd, C));
    B = nB;
    C = nC;
  }
}

// The substrate's admittance (complex; real for a dielectric on the real
// path) and, for T, its real part.
RTT_TF_HD Cx substrate_eta(const StackIn& a, bool p, float sin_i2, float kin2) {
  if (a.absorbing) {
    const Cx nc = {a.n_out, a.metal ? -a.k_out : -(0.0f * a.n_out)};
    return c_eta(nc, c_cos(kin2, nc), p);
  }
  if (a.metal) {
    // utils/coatings.py::_metal_eta: its own n_in^2 sin_i^2
    const Cx nc = {a.n_out, -a.k_out};
    const Cx r2 = cdiv(Cx{a.n_in * a.n_in * sin_i2, 0.0f}, cmul(nc, nc));
    const Cx ct = csqrt(Cx{1.0f - r2.re, -r2.im});
    return p ? cdiv(nc, ct) : cmul(nc, ct);
  }
  const float ct = real_cos(a.n_in, fmaxf(a.n_out, 1e-6f), sin_i2);
  return {real_eta(a.n_out, ct, p), 0.0f};
}

// R and T of one polarization (T = 4 eta0 Re(eta_sub) / |eta0 B + C|^2).
struct StackRT {
  float R, T;
};

RTT_TF_NOINLINE StackRT stack_rt(const StackIn& a, bool p) {
  const float sin_i2 = fmaxf(1.0f - a.cos_i * a.cos_i, 0.0f);
  const float kin2 = a.n_in * a.n_in * sin_i2;
  const float eta0 = eta0_of(a.n_in, a.cos_i, p);
  const Cx es = substrate_eta(a, p, sin_i2, kin2);
  Cx B, C;
  if (a.absorbing)
    stack_cx_bc(a, p, kin2, es, B, C, nullptr);
  else
    stack_real_bc(a, p, sin_i2, es, B, C, nullptr);
  const float nr = eta0 * B.re - C.re, ni = eta0 * B.im - C.im;
  const float dr = eta0 * B.re + C.re, di = eta0 * B.im + C.im;
  const float den2 = fmaxf(dr * dr + di * di, 1e-24f);
  return {(nr * nr + ni * ni) / den2, 4.0f * eta0 * es.re / den2};
}

// The unpolarized (Rs + Rp) / 2 and (Ts + Tp) / 2.
RTT_TF_HD StackRT stack_rt_unpolarized(const StackIn& a) {
  const StackRT s = stack_rt(a, false), p = stack_rt(a, true);
  return {0.5f * (s.R + p.R), 0.5f * (s.T + p.T)};
}

// The reverse of a stack's (B, C) accumulation for the adjoint of its R, T
// and amplitudes (stack_field_ct): from the forward's saved (B, C) before each
// layer, sin_i2 = max(raw0, 0), kin2 = n_in^2 sin_i2 and eta0, and the
// cotangents of eta0 (g_eta0), of the substrate's admittance beyond its
// start of C (g_es) and of the final (B, C) (gB, gC), the cotangents of the
// layers, the substrate and the incidence medium are added into g.  It is
// the second half of stack_rt_ct, line for line; stack_rt_ct keeps its own
// copy, because calling this from it moved the SASS of K6's coated
// kernels.
RTT_TF_HD void stack_bc_ct(const StackIn& a, bool p, const Cx* saved, float raw0, float sin_i2,
                           float kin2, float eta0, float g_eta0, Cx g_es, Cx gB, Cx gC,
                           StackCt& g) {
  float g_sin_i2 = 0.0f, g_kin2 = 0.0f;

  // ---- the layers, the last applied (the ray's first) first ----
  for (int j = 0; j < a.n; ++j) {
    const int s = layer_at(a, j);
    const Cx B0 = saved[2 * j], C0 = saved[2 * j + 1];
    const float nl = a.coat[2 * s], dl = a.coat[2 * s + 1];
    if (a.absorbing) {
      const Cx nc = {nl, -a.k[s]};
      const Cx cl = c_cos(kin2, nc);
      const Cx el = c_eta(nc, cl, p);
      const float phase = kTwoPi * dl / a.lam;
      const Cx dlt = cmul(nc, cl);
      const Cx delta = {phase * dlt.re, phase * dlt.im};
      Cx cd, sd;
      ctrig(delta, cd, sd);
      const Cx isd = {-sd.im, sd.re};
      const Cx q = cdiv(isd, el), w = cmul(isd, el);
      // nB = cd B + q C, nC = w B + cd C
      const Cx g_cd = cadd(cmul_ct(gB, B0), cmul_ct(gC, C0));
      const Cx g_q = cmul_ct(gB, C0), g_w = cmul_ct(gC, B0);
      const Cx nB0 = cadd(cmul_ct(gB, cd), cmul_ct(gC, w));
      const Cx nC0 = cadd(cmul_ct(gB, q), cmul_ct(gC, cd));
      Cx g_isd = cmul_ct(g_w, el), g_el = cmul_ct(g_w, isd);
      cdiv_ct(isd, el, g_q, g_isd, g_el);
      const Cx g_sd = {g_isd.im, -g_isd.re};
      const Cx g_delta = ctrig_ct(delta, g_cd, g_sd);
      const float g_phase = g_delta.re * dlt.re + g_delta.im * dlt.im;
      const Cx g_dlt = {phase * g_delta.re, phase * g_delta.im};
      Cx g_cl = cmul_ct(g_dlt, nc), g_nc = {0.0f, 0.0f};
      c_eta_ct(nc, cl, p, g_el, g_nc, g_cl);
      c_cos_ct(kin2, nc, g_cl, g_kin2, g_nc);  // the index is static: g_nc unused
      // phase = 2 pi d / lam
      g.d[s] += g_phase * kTwoPi / a.lam;
      g.lam -= g_phase * phase / a.lam;
      gB = nB0;
      gC = nC0;
    } else {
      const float ratio = a.n_in / nl;
      const float rawl = 1.0f - ratio * ratio * sin_i2;
      const float cl = sqrtf(fmaxf(rawl, 1e-12f));
      const float tn = kTwoPi * nl;
      const float num = tn * dl * cl;
      const float delta = num / a.lam;
      const float cd = cosf(delta), sd = sinf(delta);
      const float mc = fmaxf(cl, 1e-6f);
      const float el = p ? nl / mc : nl * cl;
      const float q = sd / el, w = el * sd;
      // nB = (cd B.re - q C.im, cd B.im + q C.re), nC = (cd C.re - w B.im,
      // cd C.im + w B.re)
      const float g_cd = gB.re * B0.re + gB.im * B0.im + gC.re * C0.re + gC.im * C0.im;
      const float g_q = -gB.re * C0.im + gB.im * C0.re;
      const float g_w = -gC.re * B0.im + gC.im * B0.re;
      const Cx nB0 = {gB.re * cd + gC.im * w, gB.im * cd - gC.re * w};
      const Cx nC0 = {gC.re * cd + gB.im * q, gC.im * cd - gB.re * q};
      const float g_sd = g_q / el + g_w * el;
      const float g_el = -(g_q * q / el) + g_w * sd;
      const float g_delta = -g_cd * sd + g_sd * cd;
      float g_cl = 0.0f;
      if (p) {
        const float g_mc = -(g_el * el / mc);
        g_cl += max_ct(cl, 1e-6f, g_mc);
      } else {
        g_cl += g_el * nl;
      }
      // delta = ((2 pi nl) dl cl) / lam
      const float g_num = g_delta / a.lam;
      g.lam -= g_delta * delta / a.lam;
      g.d[s] += g_num * tn * cl;
      g_cl += g_num * tn * dl;
      // cl = sqrt(max(1 - ratio^2 sin_i2, 1e-12)), ratio = n_in / nl
      const float g_raw = max_ct(rawl, 1e-12f, g_cl / (2.0f * cl));
      g_sin_i2 -= g_raw * ratio * ratio;
      g.n_in += -(g_raw * 2.0f * ratio * sin_i2) / nl;
      gB = nB0;
      gC = nC0;
    }
  }
  // ---- C starts as the substrate's admittance ----
  g_es = cadd(g_es, gC);
  if (a.absorbing) {
    const Cx nc = {a.n_out, a.metal ? -a.k_out : -(0.0f * a.n_out)};
    const Cx cs = c_cos(kin2, nc);
    Cx g_nc = {0.0f, 0.0f}, g_cs = {0.0f, 0.0f};
    c_eta_ct(nc, cs, p, g_es, g_nc, g_cs);
    c_cos_ct(kin2, nc, g_cs, g_kin2, g_nc);
    g.n_out += g_nc.re;
    if (a.metal) g.k_out -= g_nc.im;
  } else if (a.metal) {
    const Cx nc = {a.n_out, -a.k_out};
    const Cx nc2 = cmul(nc, nc);
    const float ar = a.n_in * a.n_in * sin_i2;
    const Cx r2 = cdiv(Cx{ar, 0.0f}, nc2);
    const Cx arg = {1.0f - r2.re, -r2.im};
    const Cx ct = csqrt(arg);
    Cx g_nc = {0.0f, 0.0f}, g_ct = {0.0f, 0.0f};
    c_eta_ct(nc, ct, p, g_es, g_nc, g_ct);
    const Cx g_arg = csqrt_ct(arg, g_ct);
    Cx g_a = {0.0f, 0.0f}, g_nc2 = {0.0f, 0.0f};
    cdiv_ct(Cx{ar, 0.0f}, nc2, Cx{-g_arg.re, -g_arg.im}, g_a, g_nc2);
    const Cx g1 = cmul_ct(g_nc2, nc);
    g_nc.re += 2.0f * g1.re;
    g_nc.im += 2.0f * g1.im;
    g.n_in += g_a.re * 2.0f * a.n_in * sin_i2;
    g_sin_i2 += g_a.re * a.n_in * a.n_in;
    g.n_out += g_nc.re;
    g.k_out -= g_nc.im;
  } else {
    // eta_sub = eta(n_out, ct), ct = real_cos(n_in, max(n_out, 1e-6))
    const float n_c = fmaxf(a.n_out, 1e-6f);
    const float ratio = a.n_in / n_c;
    const float rawt = 1.0f - ratio * ratio * sin_i2;
    const float ct = sqrtf(fmaxf(rawt, 1e-12f));
    float g_ct = 0.0f;
    if (p) {
      const float mc = fmaxf(ct, 1e-6f);
      g.n_out += g_es.re / mc;
      g_ct += max_ct(ct, 1e-6f, -(g_es.re * (a.n_out / mc) / mc));
    } else {
      g.n_out += g_es.re * ct;
      g_ct += g_es.re * a.n_out;
    }
    const float g_raw = max_ct(rawt, 1e-12f, g_ct / (2.0f * ct));
    g_sin_i2 -= g_raw * ratio * ratio;
    const float g_ratio = -(g_raw * 2.0f * ratio * sin_i2);
    g.n_in += g_ratio / n_c;
    g.n_out += max_ct(a.n_out, 1e-6f, -(g_ratio * ratio / n_c));
  }
  // ---- eta0, kin2 = n_in^2 sin_i2, sin_i2 = max(1 - cos_i^2, 0) ----
  if (p) {
    const float mci = fmaxf(a.cos_i, 1e-6f);
    g.n_in += g_eta0 / mci;
    g.cos_i += max_ct(a.cos_i, 1e-6f, -(g_eta0 * eta0 / mci));
  } else {
    g.n_in += g_eta0 * a.cos_i;
    g.cos_i += g_eta0 * a.n_in;
  }
  g.n_in += g_kin2 * 2.0f * a.n_in * sin_i2;
  g_sin_i2 += g_kin2 * a.n_in * a.n_in;
  g.cos_i += max_ct(raw0, 0.0f, g_sin_i2) * (-2.0f * a.cos_i);
}

// Adjoint of stack_rt for one polarization: g_R, g_T -> the inputs'
// cotangents, added into g.
RTT_TF_NOINLINE void stack_rt_ct(const StackIn& a, bool p, float g_R, float g_T, StackCt& g) {
  // ---- forward, saving (B, C) before each layer ----
  const float raw0 = 1.0f - a.cos_i * a.cos_i;
  const float sin_i2 = fmaxf(raw0, 0.0f);
  const float kin2 = a.n_in * a.n_in * sin_i2;
  const float eta0 = eta0_of(a.n_in, a.cos_i, p);
  const Cx es = substrate_eta(a, p, sin_i2, kin2);
  Cx saved[2 * kMaxCoatLayers];
  Cx B, C;
  if (a.absorbing)
    stack_cx_bc(a, p, kin2, es, B, C, saved);
  else
    stack_real_bc(a, p, sin_i2, es, B, C, saved);
  const float nr = eta0 * B.re - C.re, ni = eta0 * B.im - C.im;
  const float dr = eta0 * B.re + C.re, di = eta0 * B.im + C.im;
  const float raw2 = dr * dr + di * di;
  const float den2 = fmaxf(raw2, 1e-24f);
  const float R = (nr * nr + ni * ni) / den2;
  const float T = 4.0f * eta0 * es.re / den2;

  // ---- R = |num|^2 / den2, T = 4 eta0 Re(eta_sub) / den2 ----
  const float g_nn = g_R / den2;
  const float g_den2 = -(g_R * R + g_T * T) / den2;
  const float g_nr = 2.0f * nr * g_nn, g_ni = 2.0f * ni * g_nn;
  const float g_raw2 = max_ct(raw2, 1e-24f, g_den2);
  const float g_dr = 2.0f * dr * g_raw2, g_di = 2.0f * di * g_raw2;
  float g_eta0 = (g_nr + g_dr) * B.re + (g_ni + g_di) * B.im + g_T * 4.0f * es.re / den2;
  Cx g_es = {g_T * 4.0f * eta0 / den2, 0.0f};
  Cx gB = {(g_nr + g_dr) * eta0, (g_ni + g_di) * eta0};
  Cx gC = {g_dr - g_nr, g_di - g_ni};
  float g_sin_i2 = 0.0f, g_kin2 = 0.0f;

  // ---- the layers, the last applied (the ray's first) first ----
  for (int j = 0; j < a.n; ++j) {
    const int s = layer_at(a, j);
    const Cx B0 = saved[2 * j], C0 = saved[2 * j + 1];
    const float nl = a.coat[2 * s], dl = a.coat[2 * s + 1];
    if (a.absorbing) {
      const Cx nc = {nl, -a.k[s]};
      const Cx cl = c_cos(kin2, nc);
      const Cx el = c_eta(nc, cl, p);
      const float phase = kTwoPi * dl / a.lam;
      const Cx dlt = cmul(nc, cl);
      const Cx delta = {phase * dlt.re, phase * dlt.im};
      Cx cd, sd;
      ctrig(delta, cd, sd);
      const Cx isd = {-sd.im, sd.re};
      const Cx q = cdiv(isd, el), w = cmul(isd, el);
      // nB = cd B + q C, nC = w B + cd C
      const Cx g_cd = cadd(cmul_ct(gB, B0), cmul_ct(gC, C0));
      const Cx g_q = cmul_ct(gB, C0), g_w = cmul_ct(gC, B0);
      const Cx nB0 = cadd(cmul_ct(gB, cd), cmul_ct(gC, w));
      const Cx nC0 = cadd(cmul_ct(gB, q), cmul_ct(gC, cd));
      Cx g_isd = cmul_ct(g_w, el), g_el = cmul_ct(g_w, isd);
      cdiv_ct(isd, el, g_q, g_isd, g_el);
      const Cx g_sd = {g_isd.im, -g_isd.re};
      const Cx g_delta = ctrig_ct(delta, g_cd, g_sd);
      const float g_phase = g_delta.re * dlt.re + g_delta.im * dlt.im;
      const Cx g_dlt = {phase * g_delta.re, phase * g_delta.im};
      Cx g_cl = cmul_ct(g_dlt, nc), g_nc = {0.0f, 0.0f};
      c_eta_ct(nc, cl, p, g_el, g_nc, g_cl);
      c_cos_ct(kin2, nc, g_cl, g_kin2, g_nc);  // the index is static: g_nc unused
      // phase = 2 pi d / lam
      g.d[s] += g_phase * kTwoPi / a.lam;
      g.lam -= g_phase * phase / a.lam;
      gB = nB0;
      gC = nC0;
    } else {
      const float ratio = a.n_in / nl;
      const float rawl = 1.0f - ratio * ratio * sin_i2;
      const float cl = sqrtf(fmaxf(rawl, 1e-12f));
      const float tn = kTwoPi * nl;
      const float num = tn * dl * cl;
      const float delta = num / a.lam;
      const float cd = cosf(delta), sd = sinf(delta);
      const float mc = fmaxf(cl, 1e-6f);
      const float el = p ? nl / mc : nl * cl;
      const float q = sd / el, w = el * sd;
      // nB = (cd B.re - q C.im, cd B.im + q C.re), nC = (cd C.re - w B.im,
      // cd C.im + w B.re)
      const float g_cd = gB.re * B0.re + gB.im * B0.im + gC.re * C0.re + gC.im * C0.im;
      const float g_q = -gB.re * C0.im + gB.im * C0.re;
      const float g_w = -gC.re * B0.im + gC.im * B0.re;
      const Cx nB0 = {gB.re * cd + gC.im * w, gB.im * cd - gC.re * w};
      const Cx nC0 = {gC.re * cd + gB.im * q, gC.im * cd - gB.re * q};
      const float g_sd = g_q / el + g_w * el;
      const float g_el = -(g_q * q / el) + g_w * sd;
      const float g_delta = -g_cd * sd + g_sd * cd;
      float g_cl = 0.0f;
      if (p) {
        const float g_mc = -(g_el * el / mc);
        g_cl += max_ct(cl, 1e-6f, g_mc);
      } else {
        g_cl += g_el * nl;
      }
      // delta = ((2 pi nl) dl cl) / lam
      const float g_num = g_delta / a.lam;
      g.lam -= g_delta * delta / a.lam;
      g.d[s] += g_num * tn * cl;
      g_cl += g_num * tn * dl;
      // cl = sqrt(max(1 - ratio^2 sin_i2, 1e-12)), ratio = n_in / nl
      const float g_raw = max_ct(rawl, 1e-12f, g_cl / (2.0f * cl));
      g_sin_i2 -= g_raw * ratio * ratio;
      g.n_in += -(g_raw * 2.0f * ratio * sin_i2) / nl;
      gB = nB0;
      gC = nC0;
    }
  }
  // ---- C starts as the substrate's admittance ----
  g_es = cadd(g_es, gC);
  if (a.absorbing) {
    const Cx nc = {a.n_out, a.metal ? -a.k_out : -(0.0f * a.n_out)};
    const Cx cs = c_cos(kin2, nc);
    Cx g_nc = {0.0f, 0.0f}, g_cs = {0.0f, 0.0f};
    c_eta_ct(nc, cs, p, g_es, g_nc, g_cs);
    c_cos_ct(kin2, nc, g_cs, g_kin2, g_nc);
    g.n_out += g_nc.re;
    if (a.metal) g.k_out -= g_nc.im;
  } else if (a.metal) {
    const Cx nc = {a.n_out, -a.k_out};
    const Cx nc2 = cmul(nc, nc);
    const float ar = a.n_in * a.n_in * sin_i2;
    const Cx r2 = cdiv(Cx{ar, 0.0f}, nc2);
    const Cx arg = {1.0f - r2.re, -r2.im};
    const Cx ct = csqrt(arg);
    Cx g_nc = {0.0f, 0.0f}, g_ct = {0.0f, 0.0f};
    c_eta_ct(nc, ct, p, g_es, g_nc, g_ct);
    const Cx g_arg = csqrt_ct(arg, g_ct);
    Cx g_a = {0.0f, 0.0f}, g_nc2 = {0.0f, 0.0f};
    cdiv_ct(Cx{ar, 0.0f}, nc2, Cx{-g_arg.re, -g_arg.im}, g_a, g_nc2);
    const Cx g1 = cmul_ct(g_nc2, nc);
    g_nc.re += 2.0f * g1.re;
    g_nc.im += 2.0f * g1.im;
    g.n_in += g_a.re * 2.0f * a.n_in * sin_i2;
    g_sin_i2 += g_a.re * a.n_in * a.n_in;
    g.n_out += g_nc.re;
    g.k_out -= g_nc.im;
  } else {
    // eta_sub = eta(n_out, ct), ct = real_cos(n_in, max(n_out, 1e-6))
    const float n_c = fmaxf(a.n_out, 1e-6f);
    const float ratio = a.n_in / n_c;
    const float rawt = 1.0f - ratio * ratio * sin_i2;
    const float ct = sqrtf(fmaxf(rawt, 1e-12f));
    float g_ct = 0.0f;
    if (p) {
      const float mc = fmaxf(ct, 1e-6f);
      g.n_out += g_es.re / mc;
      g_ct += max_ct(ct, 1e-6f, -(g_es.re * (a.n_out / mc) / mc));
    } else {
      g.n_out += g_es.re * ct;
      g_ct += g_es.re * a.n_out;
    }
    const float g_raw = max_ct(rawt, 1e-12f, g_ct / (2.0f * ct));
    g_sin_i2 -= g_raw * ratio * ratio;
    const float g_ratio = -(g_raw * 2.0f * ratio * sin_i2);
    g.n_in += g_ratio / n_c;
    g.n_out += max_ct(a.n_out, 1e-6f, -(g_ratio * ratio / n_c));
  }
  // ---- eta0, kin2 = n_in^2 sin_i2, sin_i2 = max(1 - cos_i^2, 0) ----
  if (p) {
    const float mci = fmaxf(a.cos_i, 1e-6f);
    g.n_in += g_eta0 / mci;
    g.cos_i += max_ct(a.cos_i, 1e-6f, -(g_eta0 * eta0 / mci));
  } else {
    g.n_in += g_eta0 * a.cos_i;
    g.cos_i += g_eta0 * a.n_in;
  }
  g.n_in += g_kin2 * 2.0f * a.n_in * sin_i2;
  g_sin_i2 += g_kin2 * a.n_in * a.n_in;
  g.cos_i += max_ct(raw0, 0.0f, g_sin_i2) * (-2.0f * a.cos_i);
}

// Adjoint of stack_rt_unpolarized: g_R, g_T of the means.
RTT_TF_HD void stack_rt_unpolarized_ct(const StackIn& a, float g_R, float g_T, StackCt& g) {
  stack_rt_ct(a, false, 0.5f * g_R, 0.5f * g_T, g);
  stack_rt_ct(a, true, 0.5f * g_R, 0.5f * g_T, g);
}

// ---- One evaluation for the polarized field (field.cuh) ----

// A stack's R, T and complex amplitudes for one polarization from one (B, C)
// (utils/coatings.py::coating_rt and coating_amplitudes, or
// metal_reflectance and metal_reflection_amplitudes, which evaluate them
// apart): R and T as stack_rt has them; r = (eta0 B - C) / (eta0 B + C),
// flipped for p (the admittance form's r_p has the opposite sign to the
// Fresnel convention of field.cuh::fresnel_amps); the flux-normalized
// transmission t = 2 sqrt(max(eta0 Re(eta_sub), 0)) conj(eta0 B + C) /
// max(|eta0 B + C|^2, 1e-24), so that |t|^2 = T (a metal mirror's T and t
// are not read).
struct StackField {
  float R, T;
  Cx t, r;
};

RTT_TF_NOINLINE StackField stack_field(const StackIn& a, bool p) {
  const float sin_i2 = fmaxf(1.0f - a.cos_i * a.cos_i, 0.0f);
  const float kin2 = a.n_in * a.n_in * sin_i2;
  const float eta0 = eta0_of(a.n_in, a.cos_i, p);
  const Cx es = substrate_eta(a, p, sin_i2, kin2);
  Cx B, C;
  if (a.absorbing)
    stack_cx_bc(a, p, kin2, es, B, C, nullptr);
  else
    stack_real_bc(a, p, sin_i2, es, B, C, nullptr);
  const Cx num = {eta0 * B.re - C.re, eta0 * B.im - C.im};
  const Cx den = {eta0 * B.re + C.re, eta0 * B.im + C.im};
  const float den2 = fmaxf(den.re * den.re + den.im * den.im, 1e-24f);
  const Cx r = cdiv(num, den);
  const float amp = 2.0f * sqrtf(fmaxf(eta0 * es.re, 0.0f));
  StackField o;
  o.R = (num.re * num.re + num.im * num.im) / den2;
  o.T = 4.0f * eta0 * es.re / den2;
  o.r = p ? Cx{-r.re, -r.im} : r;
  o.t = {amp * den.re / den2, -(amp * den.im) / den2};
  return o;
}

// Adjoint of stack_field for one polarization: g_R, g_T, g_t, g_r (the
// cotangents of R, T, t and r) -> the inputs' cotangents, added into g,
// through one reverse layer sweep.
RTT_TF_NOINLINE void stack_field_ct(const StackIn& a, bool p, float g_R, float g_T, Cx g_t,
                                    Cx g_r, StackCt& g) {
  // ---- forward, saving (B, C) before each layer ----
  const float raw0 = 1.0f - a.cos_i * a.cos_i;
  const float sin_i2 = fmaxf(raw0, 0.0f);
  const float kin2 = a.n_in * a.n_in * sin_i2;
  const float eta0 = eta0_of(a.n_in, a.cos_i, p);
  const Cx es = substrate_eta(a, p, sin_i2, kin2);
  Cx saved[2 * kMaxCoatLayers];
  Cx B, C;
  if (a.absorbing)
    stack_cx_bc(a, p, kin2, es, B, C, saved);
  else
    stack_real_bc(a, p, sin_i2, es, B, C, saved);
  const Cx num = {eta0 * B.re - C.re, eta0 * B.im - C.im};
  const Cx den = {eta0 * B.re + C.re, eta0 * B.im + C.im};
  const float raw2 = den.re * den.re + den.im * den.im;
  const float den2 = fmaxf(raw2, 1e-24f);
  const float x = eta0 * es.re;
  const float amp = 2.0f * sqrtf(fmaxf(x, 0.0f));
  const float R = (num.re * num.re + num.im * num.im) / den2;
  const float T = 4.0f * eta0 * es.re / den2;
  const Cx t = {amp * den.re / den2, -(amp * den.im) / den2};

  // ---- R = |num|^2 / den2, T = 4 x / den2 ----
  const float g_nn = g_R / den2;
  Cx g_num = {2.0f * num.re * g_nn, 2.0f * num.im * g_nn}, g_den = {0.0f, 0.0f};
  float g_x = 4.0f * g_T / den2;
  // ---- r = cdiv(num, den), negated for p ----
  cdiv_ct(num, den, p ? Cx{-g_r.re, -g_r.im} : g_r, g_num, g_den);
  // ---- t = amp (den.re, -den.im) / den2, den2 = max(|den|^2, 1e-24) ----
  const float g_amp = (g_t.re * den.re - g_t.im * den.im) / den2;
  g_den.re += g_t.re * amp / den2;
  g_den.im -= g_t.im * amp / den2;
  const float g_raw2 =
      max_ct(raw2, 1e-24f, -(g_R * R + g_T * T + g_t.re * t.re + g_t.im * t.im) / den2);
  g_den.re += 2.0f * den.re * g_raw2;
  g_den.im += 2.0f * den.im * g_raw2;
  // ---- amp = 2 sqrt(max(x, 0)), x = eta0 Re(eta_sub) ----
  if (g_amp != 0.0f) g_x += max_ct(x, 0.0f, g_amp / sqrtf(fmaxf(x, 0.0f)));
  // ---- num = eta0 B - C, den = eta0 B + C ----
  const Cx g_sum = cadd(g_num, g_den);
  const float g_eta0 = g_x * es.re + g_sum.re * B.re + g_sum.im * B.im;
  const Cx g_es = {g_x * eta0, 0.0f};
  const Cx gB = {g_sum.re * eta0, g_sum.im * eta0};
  const Cx gC = {g_den.re - g_num.re, g_den.im - g_num.im};
  stack_bc_ct(a, p, saved, raw0, sin_i2, kin2, eta0, g_eta0, g_es, gB, gC, g);
}

// ---- A dispersive metal: utils/coatings.py::metal_nk_at ----

// (n, k) at wavelength lam (um) on the row's knots (side + kSideKnotN,
// kSideKnotK), lam clamped into [0.40, 1.00]; `slope_n`, `slope_k`, when
// given, receive d(n, k)/d lam (the clamp's derivative included: half at a
// bound, none outside).
RTT_TF_HD void metal_nk(const float* side, float lam, float& n, float& k, float* slope_n = nullptr,
                        float* slope_k = nullptr) {
  const float lo = static_cast<float>(metal_grid(0)), hi = static_cast<float>(metal_grid(5));
  const float lm = fmaxf(lam, lo);
  const float lc = fminf(lm, hi);
  const float* kn = side + kSideKnotN;
  const float* kk = side + kSideKnotK;
  n = kn[0];
  k = kk[0];
  float sn = 0.0f, sk = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float gi = static_cast<float>(metal_grid(i));
    const float w = static_cast<float>(metal_grid(i + 1) - metal_grid(i));
    if (lc >= gi) {
      const float t = (lc - gi) / w;
      n = kn[i] + t * (kn[i + 1] - kn[i]);
      k = kk[i] + t * (kk[i + 1] - kk[i]);
      sn = (kn[i + 1] - kn[i]) / w;
      sk = (kk[i + 1] - kk[i]) / w;
    }
  }
  if (slope_n != nullptr) {
    // lc = min(max(lam, lo), hi)
    const float d = max_ct(lam, lo, 1.0f);
    const float dc = lm < hi ? d : (lm == hi ? 0.5f * d : 0.0f);
    *slope_n = sn * dc;
    *slope_k = sk * dc;
  }
}

}  // namespace rtt
