// A host harness of csrc/grin.cuh (__host__ __device__ and free of CUDA
// types): C entry points over one ray for a GRIN rod's forward (grin_rod)
// and its hand-written adjoint (grin_backward), on a flat table row.
// tests/test_torch_grin.py builds it with g++ and holds the forward to the
// port's core/grin.py and the adjoint to torch autograd of it.

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

}  // extern "C"
