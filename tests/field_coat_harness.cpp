// A host harness of csrc/thin_film.cuh and csrc/field.cuh (both
// __host__ __device__ and free of CUDA types): C entry points over one ray
// for a stack's R, T and complex amplitudes from one evaluation, the field's
// transport through a coated interface or a metal mirror (its stack
// evaluated at the ray's incidence and taken back through, as the kernels'
// field_stack and row_backward do), and the polarized reflectance and
// transmittance, each with its hand-written adjoint.
// tests/test_torch_field_coat_host.py builds it with g++ and holds the
// adjoints to torch autograd of the plain versions.

#include "../raytracetorch_tpu_torch/csrc/field.cuh"

using namespace rtt;

namespace {

// The stack of the arrays: coat[16] (index, thickness) per layer, k[8] the
// layers' extinction, ints = {layers, rev, absorbing, metal} and
// f = {n_in, n_out, k_out, cos_i, lam}.
StackIn stack_of(const float* coat, const float* k, const int* ints, const float* f) {
  StackIn a;
  a.coat = coat;
  a.k = k;
  a.n = ints[0];
  a.rev = ints[1] != 0;
  a.absorbing = ints[2] != 0;
  a.metal = ints[3] != 0;
  a.n_in = f[0];
  a.n_out = f[1];
  a.k_out = f[2];
  a.cos_i = f[3];
  a.lam = f[4];
  return a;
}

void put_ct(const StackCt& g, float* out) {
  const float v[5] = {g.n_in, g.n_out, g.k_out, g.cos_i, g.lam};
  for (int j = 0; j < 5; ++j) out[j] = v[j];
  for (int j = 0; j < kMaxCoatLayers; ++j) out[5 + j] = g.d[j];
}

F3 f3(const float* v) { return {v[0], v[1], v[2]}; }

void put3(F3 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
}

Fld fld(const float* e) { return {f3(e), f3(e + 3)}; }

// The row of the arrays: row = {d[3], nd[3], nw[3], n1, n2, imod}, ph the
// kind; a stack (kind `stack`) as in stack_of, at the cosine of incidence
// |d . nw|, whose amplitudes the row takes.
FieldRow row_of(int ph, const float* row, int stack, StackIn& a) {
  FieldRow fr = {};
  fr.ph = ph;
  fr.d = f3(row);
  fr.nd = f3(row + 3);
  fr.nw = f3(row + 6);
  fr.n1 = row[9];
  fr.n2 = row[10];
  fr.imod = row[11];
  fr.stack = stack;
  a.cos_i = fabsf(fdot(fr.d, fr.nw));
  if (stack != kStackNone) {
    const StackField s = stack_field(a, false), p = stack_field(a, true);
    fr.ts = s.t;
    fr.rs = s.r;
    fr.tp = p.t;
    fr.rp = p.r;
  }
  return fr;
}

}  // namespace

extern "C" {

// out = (R, T, t.re, t.im, r.re, r.im) of polarization p
void h_stack_field(const float* coat, const float* k, const int* ints, const float* f, int p,
                   float* out) {
  const StackField o = stack_field(stack_of(coat, k, ints, f), p != 0);
  const float v[6] = {o.R, o.T, o.t.re, o.t.im, o.r.re, o.r.im};
  for (int j = 0; j < 6; ++j) out[j] = v[j];
}

// g = (g_R, g_T, g_t.re, g_t.im, g_r.re, g_r.im); out = the 5 inputs' and 8
// thicknesses' cotangents
void h_stack_field_ct(const float* coat, const float* k, const int* ints, const float* f, int p,
                      const float* g, float* out) {
  StackCt sc = {};
  stack_field_ct(stack_of(coat, k, ints, f), p != 0, g[0], g[1], Cx{g[2], g[3]}, Cx{g[4], g[5]},
                 sc);
  put_ct(sc, out);
}

// out = the new field (6)
void h_transport(int ph, const float* row, int stack, const float* coat, const float* k,
                 const int* ints, const float* f, const float* e, float* out) {
  StackIn a = stack_of(coat, k, ints, f);
  const Fld o = field_transport(row_of(ph, row, stack, a), fld(e));
  put3(o.r, out);
  put3(o.i, out + 3);
}

// g = the new field's cotangent (6); out = the incoming field's (6), then d,
// nd, nw (3 each), n1, n2, imod, then the stack's 13 (put_ct): its
// amplitudes' cotangents through stack_field_ct, the cosine of incidence's
// into d and nw and a coated row's media into n1 and n2 (as row_backward's
// stack_ct_backward takes them)
void h_transport_ct(int ph, const float* row, int stack, const float* coat, const float* k,
                    const int* ints, const float* f, const float* e, const float* g,
                    float* out) {
  StackIn a = stack_of(coat, k, ints, f);
  const FieldRow fr = row_of(ph, row, stack, a);
  FieldRowCt c = {};
  const Fld g_e = field_transport_ct(fr, fld(e), fld(g), c);
  StackCt sc = {};
  if (stack != kStackNone) {
    stack_field_ct(a, false, 0.0f, 0.0f, c.ts, c.rs, sc);
    stack_field_ct(a, true, 0.0f, 0.0f, c.tp, c.rp, sc);
    const float dn = fdot(fr.d, fr.nw);
    const float g_dn = sc.cos_i * (dn < 0.0f ? -1.0f : (dn > 0.0f ? 1.0f : 0.0f));
    c.d = faxpy(c.d, g_dn, fr.nw);
    c.nw = faxpy(c.nw, g_dn, fr.d);
    sc.cos_i = 0.0f;
    if (stack == kStackCoated) {
      c.n1 += sc.n_in;
      c.n2 += sc.n_out;
      sc.n_in = sc.n_out = 0.0f;
    }
  }
  put3(g_e.r, out);
  put3(g_e.i, out + 3);
  put3(c.d, out + 6);
  put3(c.nd, out + 9);
  put3(c.nw, out + 12);
  out[15] = c.n1;
  out[16] = c.n2;
  out[17] = c.imod;
  put_ct(sc, out + 18);
}

// (R_pol, T_pol) of (Rs, Rp, Ts, Tp) = rt for the field e on the s/p basis
// of d and nw
void h_polarized_rt(const float* e, const float* d, const float* nw, const float* rt,
                    float* out) {
  const PolRT w = polarized_rt(fld(e), sp_basis(f3(d), f3(nw)), rt[0], rt[1], rt[2], rt[3]);
  out[0] = w.R;
  out[1] = w.T;
}

// g = (g_R, g_T); out = the field's (6), d's and nw's (3 each, through the
// basis) and (Rs, Rp, Ts, Tp)'s cotangents
void h_polarized_rt_ct(const float* e, const float* d, const float* nw, const float* rt,
                       const float* g, float* out) {
  const SpBasis b = sp_basis(f3(d), f3(nw));
  const PolRT w = polarized_rt(fld(e), b, rt[0], rt[1], rt[2], rt[3]);
  Fld g_e = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  F3 g_s = {0.0f, 0.0f, 0.0f}, g_p = {0.0f, 0.0f, 0.0f};
  F3 g_d = {0.0f, 0.0f, 0.0f}, g_nw = {0.0f, 0.0f, 0.0f};
  float g_rt[4];
  polarized_rt_ct(fld(e), b, w, g[0], g[1], g_e, g_s, g_p, g_rt[0], g_rt[1], g_rt[2], g_rt[3]);
  sp_basis_ct(b, f3(d), f3(nw), g_s, g_p, g_d, g_nw);
  put3(g_e.r, out);
  put3(g_e.i, out + 3);
  put3(g_d, out + 6);
  put3(g_nw, out + 9);
  for (int j = 0; j < 4; ++j) out[12 + j] = g_rt[j];
}

}  // extern "C"
