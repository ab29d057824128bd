// A host harness of csrc/grin.cuh (__host__ __device__ and free of CUDA
// types): C entry points over one ray for a GRIN rod's forward (grin_rod,
// with the field grin_rod_field) and its hand-written adjoint
// (grin_backward), on a flat table row.  tests/test_torch_grin.py and
// tests/test_torch_grin_field.py build it with g++ and hold the forward to
// the port's core/grin.py and the adjoint to torch autograd of it.

#include "../raytracetorch_tpu_torch/csrc/grin.cuh"

using namespace rtt;

extern "C" {

// The rod of flat row r with `steps` steps for world direction d[3] and
// entry hit (hx, hy): out = exit position[3], direction[3], in-medium path;
// *bits the saved decisions.
void grin_forward_h(const float* r, int steps, const float* d, float hx, float hy, float* out,
                    unsigned* bits) {
  const GrinExit e = grin_rod(r, steps, d[0], d[1], d[2], hx, hy);
  const float v[7] = {e.p.x, e.p.y, e.p.z, e.d.x, e.d.y, e.d.z, e.seg};
  for (int j = 0; j < 7; ++j) out[j] = v[j];
  *bits = e.bits;
}

// The adjoint of an active rod at input p[3], d[3] with its saved bits: g
// holds gp[3], gd[3], gi and becomes the cotangents before the rod; tg
// receives the Rw[9], tw[3] and ph[6] cotangents (added to zeros), and
// *g_nb the medium before's.
void grin_backward_h(const float* r, int steps, const float* p, const float* d, unsigned bits,
                     float n_cur, float g_opl, float g_nafter, float* g, float* tg, float* g_nb) {
  G3 gp = {g[0], g[1], g[2]}, gd = {g[3], g[4], g[5]};
  float gi = g[6];
  for (int j = 0; j < 18; ++j) tg[j] = 0.0f;
  grin_backward(r, steps, G3{p[0], p[1], p[2]}, G3{d[0], d[1], d[2]}, bits, n_cur, g_opl,
                g_nafter, gp, gd, gi, tg, tg + 9, tg + 12, *g_nb);
  const float v[7] = {gp.x, gp.y, gp.z, gd.x, gd.y, gd.z, gi};
  for (int j = 0; j < 7; ++j) g[j] = v[j];
}

// grin_forward_h with the field: e[6] (Er, Ei, world frame) holds the
// field before the rod and receives the field after it.
void grin_forward_field_h(const float* r, int steps, const float* d, float hx, float hy,
                          float* out, unsigned* bits, float* e) {
  GrinFld fe = {{e[0], e[1], e[2]}, {e[3], e[4], e[5]}};
  const GrinExit x = grin_rod_field(r, steps, d[0], d[1], d[2], hx, hy, fe);
  const float v[7] = {x.p.x, x.p.y, x.p.z, x.d.x, x.d.y, x.d.z, x.seg};
  for (int j = 0; j < 7; ++j) out[j] = v[j];
  *bits = x.bits;
  const float w[6] = {fe.r.x, fe.r.y, fe.r.z, fe.i.x, fe.i.y, fe.i.z};
  for (int j = 0; j < 6; ++j) e[j] = w[j];
}

// grin_backward_h with the field: e[6] the field before the rod, ge[6] the
// cotangent of the field after it, which becomes that of the field before.
void grin_backward_field_h(const float* r, int steps, const float* p, const float* d,
                           unsigned bits, float n_cur, float g_opl, float g_nafter, float* g,
                           float* tg, float* g_nb, const float* e, float* ge) {
  G3 gp = {g[0], g[1], g[2]}, gd = {g[3], g[4], g[5]};
  float gi = g[6];
  for (int j = 0; j < 18; ++j) tg[j] = 0.0f;
  const GrinFld fin = {{e[0], e[1], e[2]}, {e[3], e[4], e[5]}};
  GrinFld gfe = {{ge[0], ge[1], ge[2]}, {ge[3], ge[4], ge[5]}};
  grin_backward_field(r, steps, G3{p[0], p[1], p[2]}, G3{d[0], d[1], d[2]}, bits, n_cur, g_opl,
                      g_nafter, gp, gd, gi, tg, tg + 9, tg + 12, *g_nb, fin, gfe);
  const float v[7] = {gp.x, gp.y, gp.z, gd.x, gd.y, gd.z, gi};
  for (int j = 0; j < 7; ++j) g[j] = v[j];
  const float w[6] = {gfe.r.x, gfe.r.y, gfe.r.z, gfe.i.x, gfe.i.y, gfe.i.z};
  for (int j = 0; j < 6; ++j) ge[j] = w[j];
}

}  // extern "C"
