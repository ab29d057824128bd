// GRIN rods for the fused kernels K1 (trace_seq_fwd.cu), K2
// (trace_seq_bwd.cu), K5 (trace_nonseq_fwd.cu) and K6 (trace_nonseq_bwd.cu),
// in their instantiation with GRIN rods (kGrin): the rod's whole
// interaction from its entry-plane hit (grin_rod) and its hand-written
// adjoint (grin_backward).
//
// Replaces the GRIN code of the TPU kernels raytracetorch_tpu/ops/
// pallas_trace.py::_kernel_v2 (_chain_pure's GRIN branch :1569-1604),
// _kernel_nonseq (_nonseq_bounce_core's GRIN winner :881-945, the stale
// path's clear :940, the path length :1022) and their backward kernels
// (_kernel_v2_bwd :1714, _kernel_nonseq_bwd :2049 and _bwd_scan :2160, which
// take jax.vjp of the unrolled RK4 body), all running
// raytracetorch_tpu/core/grin.py.  The plain PyTorch version is the port's
// core/grin.py, run by the eager chain and bounce loop.
//
// A rod is one table row: its entry plane (a plane row with a DISK bound,
// radius^2 in sb[0]) and ph = (n_ambient, c0, c2, c4, cz, L), the profile
// n^2 = c0 + c2 r^2 + c4 r^4 + cz z in the entry-plane frame, z in [0, L].
// Its RK4 step count rides the kinds row's last column.  From the entry
// hit (x0, y0) and the rod-frame direction ds: px = n_amb ds.x, py = n_amb
// ds.y; the ray dies where n^2(x0, y0, 0) - px^2 - py^2 <= 1e-10; then the
// fixed-count RK4 in z of (x, y, px, py, opl), h = L / steps, step i at
// height z = i h, stops at the first step whose four rates are not all
// clear of a turning point (pz^2 > 1e-10) or whose new point leaves the
// radius: the ray dies there with the state it had (the JAX package's
// frozen lanes); then the exit coupling pz^2 = n_amb^2 - px^2 - py^2 (dead
// at <= 1e-10, exit-face TIR).  The ray lands at (x, y, L) of the rod frame
// in world coordinates with direction (px, py, pz) / n_amb, intensity
// times 1 (alive) or 0 (dead), and the in-medium optical path (0 for a dead
// ray).  A ray meets the rod only travelling +z in its frame (grin_fwd).
//
// Design: one thread per ray, as the kernels.  The rod's forward is one
// out-of-line function (__noinline__), so that K5 and K6's replay run one
// compiled body and the replay reaches K5's state bit for bit (inlined,
// the two kernels contract the steps' multiply-adds apart, as PR 21 found
// for the field's transport); the winner test grin_fwd rounds explicitly
// for the same reason.  The adjoint re-runs the rod from the row's saved
// input state with the forward's decisions (the saved bits: the steps it
// applied, whether it lived and whether its exit coupled), keeping the
// state at the start of every kGrinSeg-th step (kGrinCkpts checkpoints of
// 16 bytes), then reverses the steps a segment at a time, recomputing the
// segment's kGrinSeg states from its checkpoint into a second array and
// the four rates of each step from its state: two forward passes and the
// reverse, in 512 bytes of local memory a thread.  RK4 is not reversible,
// so the states must be stored or recomputed; sqrt(n)-style checkpoints
// keep the memory small (a full tape of 256 steps would be 4 KB a thread,
// 1.1 GB of local memory reserved for a K2 launch on 132 SMs).
//
// What bounds it: arithmetic.  One step is four rate evaluations of ~16
// flops and an IEEE division and square root each, ~90 flops with the
// update: ~5,800 flops a ray through a 64-step rod, against a few hundred
// bytes the ray moves; the adjoint runs the steps twice more and their
// reverse (~3x a step), ~25,000 flops a ray.
//
// The polarized field (the instantiation with the field and GRIN rods):
// grin_rod_field carries a ray's complex E-vector through the rod as the
// plain version does (core/grin.py: the JAX package's :153-156, :236-239,
// :262-264), each rotation v3.rotate_between of two unit directions
// applied to the field's real and imaginary parts in the rod's frame: the
// entry coupling from the incoming direction to the rod's first _p_dir
// (grin_pdir), every applied RK4 step from _p_dir at its start to _p_dir
// at its end, and the exit coupling from the last _p_dir to the exit
// direction, rounded as the plain version rounds them (grot_between).  Its
// adjoint (grin_backward with kField) keeps the field beside each
// checkpoint of the state (six words), so local memory a thread grows from
// 512 to 1,280 bytes: 16 checkpoints and one segment of states (16 bytes
// each) and of fields (24 bytes each).
//
// The functions are __host__ __device__ and use no CUDA type, so the same
// source compiles as plain C++ for a host check against torch autograd.

#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define RTT_GR_HD __host__ __device__ __forceinline__
#define RTT_GR_NOINLINE __host__ __device__ __noinline__
#else
#define RTT_GR_HD inline
#define RTT_GR_NOINLINE
#endif

namespace rtt {

// The fused kernels' limit on a rod's RK4 steps (ops/fused_trace.py
// MAX_GRIN_STEPS), the steps a checkpoint of the adjoint covers and the
// checkpoints.
constexpr int kMaxGrinSteps = 256;
constexpr int kGrinSeg = 16;
constexpr int kGrinCkpts = kMaxGrinSteps / kGrinSeg;
// The flat-row columns a rod reads (core/table.py ROW_FIELDS; the kernels
// hold them to trace_seq_common.cuh's kRw, kTw, kSb, kPh).
constexpr int kGrRw = 6, kGrTw = 15, kGrSb = 30, kGrPh = 42;
// A rod's saved bits above the row's kActive (bit 0): it lived, its exit
// coupled, and the steps it applied (9 bits, from kGrinStepShift).
constexpr uint32_t kGrinAlive = 1u << 1;
constexpr uint32_t kGrinOkOut = 1u << 2;
constexpr int kGrinStepShift = 3;
constexpr uint32_t kGrinStepMask = 0x1ffu;

// The rod's forward arithmetic: each product, sum, quotient and square root
// rounded once, in the device pass by intrinsics that no contraction can
// merge, in the order the plain version (core/grin.py, one rounding an
// operation) takes them.  So every kernel computes the rod alike, bit for
// bit (K6's replay reaches K5's state), and from the same entry hit as the
// plain version does.
#ifdef __CUDA_ARCH__
RTT_GR_HD float gmul(float a, float b) { return __fmul_rn(a, b); }
RTT_GR_HD float gadd(float a, float b) { return __fadd_rn(a, b); }
RTT_GR_HD float gsub(float a, float b) { return __fsub_rn(a, b); }
RTT_GR_HD float gdiv(float a, float b) { return __fdiv_rn(a, b); }
RTT_GR_HD float gsqrt(float a) { return __fsqrt_rn(a); }
#else
RTT_GR_HD float gmul(float a, float b) { return a * b; }
RTT_GR_HD float gadd(float a, float b) { return a + b; }
RTT_GR_HD float gsub(float a, float b) { return a - b; }
RTT_GR_HD float gdiv(float a, float b) { return a / b; }
RTT_GR_HD float gsqrt(float a) { return std::sqrt(a); }
#endif

struct G3 {
  float x, y, z;
};

// v @ R and v @ R.T with R a row-major 3x3 (as trace_seq_common.cuh's rot
// and rot_t), for the adjoint
RTT_GR_HD G3 grot(G3 v, const float* R) {
  return {v.x * R[0] + v.y * R[3] + v.z * R[6], v.x * R[1] + v.y * R[4] + v.z * R[7],
          v.x * R[2] + v.y * R[5] + v.z * R[8]};
}

RTT_GR_HD G3 grot_t(G3 v, const float* R) {
  return {v.x * R[0] + v.y * R[1] + v.z * R[2], v.x * R[3] + v.y * R[4] + v.z * R[5],
          v.x * R[6] + v.y * R[7] + v.z * R[8]};
}

// a.x b.x + a.y b.y + a.z b.z, rounded as geom/vec3.py's rot and rot_t
RTT_GR_HD float gdot3(float ax, float bx, float ay, float by, float az, float bz) {
  return gadd(gadd(gmul(ax, bx), gmul(ay, by)), gmul(az, bz));
}

// The forward's v @ R and v @ R.T
RTT_GR_HD G3 grot_r(G3 v, const float* R) {
  return {gdot3(v.x, R[0], v.y, R[3], v.z, R[6]), gdot3(v.x, R[1], v.y, R[4], v.z, R[7]),
          gdot3(v.x, R[2], v.y, R[5], v.z, R[8])};
}

RTT_GR_HD G3 grot_t_r(G3 v, const float* R) {
  return {gdot3(v.x, R[0], v.y, R[1], v.z, R[2]), gdot3(v.x, R[3], v.y, R[4], v.z, R[5]),
          gdot3(v.x, R[6], v.y, R[7], v.z, R[8])};
}

// A rod's profile and step: n_amb, c0, c2, c4, cz, L, radius^2, h = L / steps.
struct GrinProf {
  float namb, c0, c2, c4, cz, L, r2max, h;
};

RTT_GR_HD GrinProf grin_prof(const float* r, int steps) {
  const float L = r[kGrPh + 5];
  return {r[kGrPh],     r[kGrPh + 1], r[kGrPh + 2], r[kGrPh + 3], r[kGrPh + 4],
          L,            r[kGrSb],     gdiv(L, static_cast<float>(steps))};
}

// The transverse state of the RK4 (the path length rides beside it).
struct GrinPt {
  float x, y, px, py;
};

// x^2 + y^2 and n^2 = c0 + (c2 + c4 r^2) r^2 + cz z (core/grin.py::_n2_at)
RTT_GR_HD float grin_r2(float x, float y) { return gadd(gmul(x, x), gmul(y, y)); }

RTT_GR_HD float grin_n2(const GrinProf& g, float r2, float z) {
  return gadd(gadd(g.c0, gmul(gadd(g.c2, gmul(g.c4, r2)), r2)), gmul(g.cz, z));
}

// n^2 - px^2 - py^2
RTT_GR_HD float grin_pz2(float n2, float px, float py) {
  return gsub(gsub(n2, gmul(px, px)), gmul(py, py));
}

// The five rates of core/grin.py::_derivs at (v, z) and whether pz^2 > 1e-10.
struct GrinRate {
  float x, y, px, py, opl;
  bool ok;
};

RTT_GR_HD GrinRate grin_derivs(const GrinProf& g, GrinPt v, float z) {
  const float r2 = grin_r2(v.x, v.y);
  const float n2 = grin_n2(g, r2, z);
  const float pz2 = grin_pz2(n2, v.px, v.py);
  const bool ok = pz2 > 1e-10f;
  const float inv = ok ? gdiv(1.0f, gsqrt(pz2)) : 0.0f;
  const float G = gadd(g.c2, gmul(gmul(2.0f, g.c4), r2));
  return {gmul(v.px, inv), gmul(v.py, inv), gmul(gmul(G, v.x), inv),
          gmul(gmul(G, v.y), inv), gmul(n2, inv), ok};
}

// s + a k
RTT_GR_HD GrinPt grin_axpy(GrinPt s, float a, const GrinRate& k) {
  return {gadd(s.x, gmul(a, k.x)), gadd(s.y, gmul(a, k.y)), gadd(s.px, gmul(a, k.px)),
          gadd(s.py, gmul(a, k.py))};
}

// s + w ((k1 + 2 k2 + 2 k3) + k4), one component
RTT_GR_HD float grin_rk(float s, float w, float k1, float k2, float k3, float k4) {
  return gadd(s, gmul(w, gadd(gadd(gadd(k1, gmul(2.0f, k2)), gmul(2.0f, k3)), k4)));
}

// One RK4 step at height z: s and its path length move to the step's end;
// ok receives whether all four rates were clear of a turning point.
RTT_GR_HD void grin_step(const GrinProf& g, GrinPt& s, float& opl, float z, bool& ok) {
  const float hh = gmul(0.5f, g.h);
  const GrinRate k1 = grin_derivs(g, s, z);
  const GrinRate k2 = grin_derivs(g, grin_axpy(s, hh, k1), gadd(z, hh));
  const GrinRate k3 = grin_derivs(g, grin_axpy(s, hh, k2), gadd(z, hh));
  const GrinRate k4 = grin_derivs(g, grin_axpy(s, g.h, k3), gadd(z, g.h));
  const float w = gdiv(g.h, 6.0f);
  ok = k1.ok && k2.ok && k3.ok && k4.ok;
  s = {grin_rk(s.x, w, k1.x, k2.x, k3.x, k4.x), grin_rk(s.y, w, k1.y, k2.y, k3.y, k4.y),
       grin_rk(s.px, w, k1.px, k2.px, k3.px, k4.px),
       grin_rk(s.py, w, k1.py, k2.py, k3.py, k4.py)};
  opl = grin_rk(opl, w, k1.opl, k2.opl, k3.opl, k4.opl);
}

// Whether a ray of world direction d travels +z in the rod's frame (d_s.z >
// 1e-6: core/grin.py's fwd), rounded as the plain version rounds it.
RTT_GR_HD bool grin_fwd(const float* r, float dx, float dy, float dz) {
  const float* R = r + kGrRw;
  return gdot3(dx, R[2], dy, R[5], dz, R[8]) > 1e-6f;
}

// The field of a ray (kField): the real and imaginary parts of E.
struct GrinFld {
  G3 r, i;
};

// The unit ray direction at state s and height z, pz re-solved from |p| =
// n and clamped (core/grin.py::_p_dir), rounded as the plain version.
RTT_GR_HD G3 grin_pdir(const GrinProf& g, GrinPt s, float z) {
  const float n2 = grin_n2(g, grin_r2(s.x, s.y), z);
  const float pz = gsqrt(fmaxf(grin_pz2(n2, s.px, s.py), 1e-12f));
  const float inv_n = gdiv(1.0f, gsqrt(fmaxf(n2, 1e-12f)));
  return {gmul(s.px, inv_n), gmul(s.py, inv_n), gmul(pz, inv_n)};
}

// The minimal rotation taking unit a to unit b applied to v
// (geom/vec3.py::rotate_between: c v + w x v + w (w . v) / max(1 + c,
// 1e-6), c = a . b, w = a x b), rounded as the plain version.
RTT_GR_HD G3 grot_between(G3 a, G3 b, G3 v) {
  const float c = gdot3(a.x, b.x, a.y, b.y, a.z, b.z);
  const G3 w = {gsub(gmul(a.y, b.z), gmul(a.z, b.y)), gsub(gmul(a.z, b.x), gmul(a.x, b.z)),
                gsub(gmul(a.x, b.y), gmul(a.y, b.x))};
  const float s = gdiv(gdot3(w.x, v.x, w.y, v.y, w.z, v.z), fmaxf(gadd(1.0f, c), 1e-6f));
  return {gadd(gadd(gmul(c, v.x), gsub(gmul(w.y, v.z), gmul(w.z, v.y))), gmul(w.x, s)),
          gadd(gadd(gmul(c, v.y), gsub(gmul(w.z, v.x), gmul(w.x, v.z))), gmul(w.y, s)),
          gadd(gadd(gmul(c, v.z), gsub(gmul(w.x, v.y), gmul(w.y, v.x))), gmul(w.z, s))};
}

RTT_GR_HD GrinFld grot_between(G3 a, G3 b, const GrinFld& e) {
  return {grot_between(a, b, e.r), grot_between(a, b, e.i)};
}

// A rod's exit: the world position and direction, the in-medium optical
// path (0 for a dead ray) and the saved bits (grin_bits).
struct GrinExit {
  G3 p, d;
  float seg;
  uint32_t bits;
};

// The rod of flat row r with `steps` RK4 steps for a ray of world
// direction d that meets its entry plane at the surface-frame hit (hx,
// hy): the entry coupling, the steps up to the first dead one, the exit
// coupling, and the exit in world coordinates (core/grin.py::
// grin_interaction).  With kField the field *fe (world frame) rides along
// the rod's rotations.  grin_rod and grin_rod_field run it out of line:
// K5 and K6's replay run one body.
template <bool kField>
RTT_GR_HD GrinExit grin_rod_body(const float* r, int steps, float dx, float dy, float dz,
                                 float hx, float hy, GrinFld* fe) {
  const GrinProf g = grin_prof(r, steps);
  const float* R = r + kGrRw;
  const G3 ds = grot_r(G3{dx, dy, dz}, R);
  GrinPt s = {hx, hy, gmul(g.namb, ds.x), gmul(g.namb, ds.y)};
  const float r2 = grin_r2(hx, hy);
  const bool alive_in = grin_pz2(grin_n2(g, r2, 0.0f), s.px, s.py) > 1e-10f;
  GrinFld e;  // kField: the field in the rod's frame
  if constexpr (kField)
    e = grot_between(ds, grin_pdir(g, s, 0.0f), GrinFld{grot_r(fe->r, R), grot_r(fe->i, R)});
  float opl = 0.0f;
  int m = 0;
  if (alive_in && r2 <= g.r2max) {
    for (; m < steps; ++m) {
      GrinPt t = s;
      float o = opl;
      bool ok;
      const float z = gmul(static_cast<float>(m), g.h);
      grin_step(g, t, o, z, ok);
      if (!(ok && grin_r2(t.x, t.y) <= g.r2max)) break;
      if constexpr (kField) e = grot_between(grin_pdir(g, s, z), grin_pdir(g, t, gadd(z, g.h)), e);
      s = t;
      opl = o;
    }
  }
  const float pz2_out = grin_pz2(gmul(g.namb, g.namb), s.px, s.py);
  const bool ok_out = pz2_out > 1e-10f;
  const float pz_out = gsqrt(ok_out ? pz2_out : 1.0f);
  const float inv_n = gdiv(1.0f, g.namb);
  const bool alive = alive_in && r2 <= g.r2max && m == steps && ok_out;
  const G3 ex = grot_t_r(G3{s.x, s.y, g.L}, R);
  GrinExit out;
  out.p = {gadd(ex.x, r[kGrTw]), gadd(ex.y, r[kGrTw + 1]), gadd(ex.z, r[kGrTw + 2])};
  out.d = grot_t_r(G3{gmul(s.px, inv_n), gmul(s.py, inv_n), gmul(pz_out, inv_n)}, R);
  out.seg = alive ? opl : 0.0f;
  out.bits = (alive ? kGrinAlive : 0u) | (ok_out ? kGrinOkOut : 0u) |
             (static_cast<uint32_t>(m) << kGrinStepShift);
  if constexpr (kField) {
    const G3 dout = {gmul(s.px, inv_n), gmul(s.py, inv_n), gmul(pz_out, inv_n)};
    e = grot_between(grin_pdir(g, s, g.L), dout, e);
    *fe = {grot_t_r(e.r, R), grot_t_r(e.i, R)};
  }
  return out;
}

RTT_GR_NOINLINE GrinExit grin_rod(const float* r, int steps, float dx, float dy, float dz,
                                  float hx, float hy) {
  return grin_rod_body<false>(r, steps, dx, dy, dz, hx, hy, nullptr);
}

RTT_GR_NOINLINE GrinExit grin_rod_field(const float* r, int steps, float dx, float dy, float dz,
                                        float hx, float hy, GrinFld& fe) {
  return grin_rod_body<true>(r, steps, dx, dy, dz, hx, hy, &fe);
}

// The cotangents of the profile and of the step h that the steps' adjoint
// accumulates.
struct GrinProfCt {
  float c0, c2, c4, cz, h;
};

// Adjoint of grin_derivs at (v, z), given the cotangents gk of its five
// rates: adds those of v (gv), z (gz) and the profile (gc).  A rate at a
// turning point is the JAX package's where(ok, ., 0): no cotangent.
RTT_GR_HD void grin_derivs_ct(const GrinProf& g, GrinPt v, float z, const float (&gk)[5],
                              GrinPt& gv, float& gz, GrinProfCt& gc) {
  const float r2 = v.x * v.x + v.y * v.y;
  const float n2 = g.c0 + (g.c2 + g.c4 * r2) * r2 + g.cz * z;
  const float pz2 = n2 - v.px * v.px - v.py * v.py;
  if (!(pz2 > 1e-10f)) return;
  const float inv = 1.0f / sqrtf(pz2);
  const float G = g.c2 + 2.0f * g.c4 * r2;
  const float gx = G * v.x, gy = G * v.y;
  // rates: (px, py, gx, gy, n2) * inv
  const float g_inv = gk[0] * v.px + gk[1] * v.py + gk[2] * gx + gk[3] * gy + gk[4] * n2;
  float g_px = gk[0] * inv, g_py = gk[1] * inv;
  const float g_gx = gk[2] * inv, g_gy = gk[3] * inv;
  float g_n2 = gk[4] * inv;
  // inv = 1 / sqrt(pz2)
  const float g_pz2 = -0.5f * g_inv * inv * inv * inv;
  g_n2 += g_pz2;
  g_px -= 2.0f * v.px * g_pz2;
  g_py -= 2.0f * v.py * g_pz2;
  // gx = G x, gy = G y, G = c2 + 2 c4 r2
  const float g_G = g_gx * v.x + g_gy * v.y;
  float g_x = g_gx * G, g_y = g_gy * G;
  gc.c2 += g_G + g_n2 * r2;
  gc.c4 += 2.0f * r2 * g_G + g_n2 * r2 * r2;
  // n2 = c0 + (c2 + c4 r2) r2 + cz z: d n2 / d r2 = c2 + 2 c4 r2 = G
  const float g_r2 = 2.0f * g.c4 * g_G + g_n2 * G;
  gc.c0 += g_n2;
  gc.cz += g_n2 * z;
  gz += g_n2 * g.cz;
  g_x += 2.0f * v.x * g_r2;
  g_y += 2.0f * v.y * g_r2;
  gv.x += g_x;
  gv.y += g_y;
  gv.px += g_px;
  gv.py += g_py;
}

// Adjoint of grin_pdir at (s, z): gd, the direction's cotangent, adds
// those of s into gs and of the profile into gc; returns that of z.  A
// clamp passes its cotangent where its input is at or above the bound
// (PyTorch's rule).
RTT_GR_HD float grin_pdir_ct(const GrinProf& g, GrinPt s, float z, G3 gd, GrinPt& gs,
                             GrinProfCt& gc) {
  const float r2 = s.x * s.x + s.y * s.y;
  const float n2 = g.c0 + (g.c2 + g.c4 * r2) * r2 + g.cz * z;
  const float pz2 = n2 - s.px * s.px - s.py * s.py;
  const float pz = sqrtf(fmaxf(pz2, 1e-12f)), sn = sqrtf(fmaxf(n2, 1e-12f));
  const float inv_n = 1.0f / sn;
  // d = (px, py, pz) * inv_n, inv_n = 1 / sqrt(n2), pz = sqrt(n2 - px^2 - py^2)
  const float g_inv = gd.x * s.px + gd.y * s.py + gd.z * pz;
  float g_n2 = n2 >= 1e-12f ? -(g_inv * inv_n * inv_n) / (2.0f * sn) : 0.0f;
  const float g_pz2 = pz2 >= 1e-12f ? gd.z * inv_n / (2.0f * pz) : 0.0f;
  g_n2 += g_pz2;
  // n2 = c0 + (c2 + c4 r2) r2 + cz z
  const float g_r2 = g_n2 * (g.c2 + 2.0f * g.c4 * r2);
  gc.c0 += g_n2;
  gc.c2 += g_n2 * r2;
  gc.c4 += g_n2 * r2 * r2;
  gc.cz += g_n2 * z;
  gs.x += 2.0f * s.x * g_r2;
  gs.y += 2.0f * s.y * g_r2;
  gs.px += gd.x * inv_n - 2.0f * s.px * g_pz2;
  gs.py += gd.y * inv_n - 2.0f * s.py * g_pz2;
  return g_n2 * g.cz;
}

// Adjoint of grot_between(a, b, v) given g, the result's cotangent:
// returns that of v and adds those of a and b into ga and gb (the clamp of
// 1 + c as grin_pdir_ct's).
RTT_GR_HD G3 grot_between_ct(G3 a, G3 b, G3 v, G3 g, G3& ga, G3& gb) {
  const float c = a.x * b.x + a.y * b.y + a.z * b.z;
  const G3 w = {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
  const float den = fmaxf(1.0f + c, 1e-6f);
  const float s = (w.x * v.x + w.y * v.y + w.z * v.z) / den;
  // out = c v + w x v + w s, s = (w . v) / den
  const float q = (g.x * w.x + g.y * w.y + g.z * w.z) / den;
  const float g_c = (g.x * v.x + g.y * v.y + g.z * v.z) + (1.0f + c >= 1e-6f ? -q * s : 0.0f);
  const G3 gw = {v.y * g.z - v.z * g.y + g.x * s + v.x * q,
                 v.z * g.x - v.x * g.z + g.y * s + v.y * q,
                 v.x * g.y - v.y * g.x + g.z * s + v.z * q};
  // c = a . b, w = a x b
  ga.x += g_c * b.x + (b.y * gw.z - b.z * gw.y);
  ga.y += g_c * b.y + (b.z * gw.x - b.x * gw.z);
  ga.z += g_c * b.z + (b.x * gw.y - b.y * gw.x);
  gb.x += g_c * a.x + (gw.y * a.z - gw.z * a.y);
  gb.y += g_c * a.y + (gw.z * a.x - gw.x * a.z);
  gb.z += g_c * a.z + (gw.x * a.y - gw.y * a.x);
  return {c * g.x + (g.y * w.z - g.z * w.y) + w.x * q, c * g.y + (g.z * w.x - g.x * w.z) + w.y * q,
          c * g.z + (g.x * w.y - g.y * w.x) + w.z * q};
}

RTT_GR_HD GrinFld grot_between_ct(G3 a, G3 b, const GrinFld& v, const GrinFld& g, G3& ga,
                                  G3& gb) {
  return {grot_between_ct(a, b, v.r, g.r, ga, gb), grot_between_ct(a, b, v.i, g.i, ga, gb)};
}

// v @ R of both parts of a field; and tg_rw[3 i + j] += u_i v_j, a
// rotation's cotangent (of w @ R at its input w and cotangent g: u = w, v
// = g; of w @ R.T: u = g, v = w)
RTT_GR_HD GrinFld grot(const GrinFld& e, const float* R) { return {grot(e.r, R), grot(e.i, R)}; }

RTT_GR_HD void grin_rw_ct(const G3& u, const G3& v, float* tg_rw) {
  const float uv[3] = {u.x, u.y, u.z}, gv[3] = {v.x, v.y, v.z};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tg_rw[3 * i + j] += uv[i] * gv[j];
}

// Adjoint of the RK4 step i from state s: gs (the cotangent of the step's
// end state) becomes that of its start; g_opl, the path length's
// cotangent, passes through (opl is a running sum); the profile's and h's
// cotangents add into gc.
RTT_GR_HD void grin_step_ct(const GrinProf& g, GrinPt s, int i, float g_opl, GrinPt& gs,
                            GrinProfCt& gc) {
  const float h = g.h, hh = 0.5f * h, w = h / 6.0f;
  const float z = static_cast<float>(i) * h;
  const GrinRate k1 = grin_derivs(g, s, z);
  const GrinPt in2 = grin_axpy(s, hh, k1);
  const GrinRate k2 = grin_derivs(g, in2, z + hh);
  const GrinPt in3 = grin_axpy(s, hh, k2);
  const GrinRate k3 = grin_derivs(g, in3, z + hh);
  const GrinPt in4 = grin_axpy(s, h, k3);
  const GrinRate k4 = grin_derivs(g, in4, z + h);
  // end = start + w S, S = ((k1 + 2 k2) + 2 k3) + k4, w = h / 6
  const float gsv[5] = {gs.x, gs.y, gs.px, gs.py, g_opl};
  const float S[5] = {((k1.x + 2.0f * k2.x) + 2.0f * k3.x) + k4.x,
                      ((k1.y + 2.0f * k2.y) + 2.0f * k3.y) + k4.y,
                      ((k1.px + 2.0f * k2.px) + 2.0f * k3.px) + k4.px,
                      ((k1.py + 2.0f * k2.py) + 2.0f * k3.py) + k4.py,
                      ((k1.opl + 2.0f * k2.opl) + 2.0f * k3.opl) + k4.opl};
  float g_w = 0.0f;
  float g1[5], g2[5], g3[5], g4[5];
  for (int c = 0; c < 5; ++c) {
    g_w += gsv[c] * S[c];
    g1[c] = w * gsv[c];
    g2[c] = 2.0f * w * gsv[c];
    g3[c] = 2.0f * w * gsv[c];
    g4[c] = w * gsv[c];
  }
  float g_h = g_w / 6.0f, g_z = 0.0f;
  // k4 = D(in4, z + h), in4 = s + h k3
  GrinPt gi = {0.0f, 0.0f, 0.0f, 0.0f};
  float gzk = 0.0f;
  grin_derivs_ct(g, in4, z + h, g4, gi, gzk, gc);
  gs = {gs.x + gi.x, gs.y + gi.y, gs.px + gi.px, gs.py + gi.py};
  g3[0] += h * gi.x;
  g3[1] += h * gi.y;
  g3[2] += h * gi.px;
  g3[3] += h * gi.py;
  g_h += gi.x * k3.x + gi.y * k3.y + gi.px * k3.px + gi.py * k3.py + gzk;
  g_z += gzk;
  // k3 = D(in3, z + h / 2), in3 = s + (h / 2) k2
  gi = {0.0f, 0.0f, 0.0f, 0.0f};
  gzk = 0.0f;
  grin_derivs_ct(g, in3, z + hh, g3, gi, gzk, gc);
  gs = {gs.x + gi.x, gs.y + gi.y, gs.px + gi.px, gs.py + gi.py};
  g2[0] += hh * gi.x;
  g2[1] += hh * gi.y;
  g2[2] += hh * gi.px;
  g2[3] += hh * gi.py;
  g_h += 0.5f * (gi.x * k2.x + gi.y * k2.y + gi.px * k2.px + gi.py * k2.py + gzk);
  g_z += gzk;
  // k2 = D(in2, z + h / 2), in2 = s + (h / 2) k1
  gi = {0.0f, 0.0f, 0.0f, 0.0f};
  gzk = 0.0f;
  grin_derivs_ct(g, in2, z + hh, g2, gi, gzk, gc);
  gs = {gs.x + gi.x, gs.y + gi.y, gs.px + gi.px, gs.py + gi.py};
  g1[0] += hh * gi.x;
  g1[1] += hh * gi.y;
  g1[2] += hh * gi.px;
  g1[3] += hh * gi.py;
  g_h += 0.5f * (gi.x * k1.x + gi.y * k1.y + gi.px * k1.px + gi.py * k1.py + gzk);
  g_z += gzk;
  // k1 = D(s, z)
  gi = {0.0f, 0.0f, 0.0f, 0.0f};
  gzk = 0.0f;
  grin_derivs_ct(g, s, z, g1, gi, gzk, gc);
  gs = {gs.x + gi.x, gs.y + gi.y, gs.px + gi.px, gs.py + gi.py};
  g_z += gzk;
  // z = i h
  gc.h += g_h + static_cast<float>(i) * g_z;
}

// Adjoint of an active rod (grin_rod after the row's plane intersection,
// t = 2 o.z / B) at the ray's input position p and direction d, with the
// forward's saved bits.  gp, gd and gi hold the cotangents of the ray after
// the rod and become those before it (the factor, 1 or 0, has no
// derivative); g_opl is the path length's (the rod adds n_cur t + seg),
// g_nafter that of the medium after the rod (n_ambient).  The table's
// cotangents add into tg_rw[9], tg_tw[3] and tg_ph[6]; g_nbefore receives
// that of the medium before the rod (g_opl t).  With kField (grin_rod_field)
// *fin is the field before the rod and *gfe the cotangent of the field
// after it, which becomes that of the field before it; the field's
// checkpoints ride beside the state's.
template <bool kField = false>
RTT_GR_HD void grin_backward(const float* r, int steps, G3 p, G3 d, uint32_t bits, float n_cur,
                             float g_opl, float g_nafter, G3& gp, G3& gd, float& gi,
                             float* tg_rw, float* tg_tw, float* tg_ph, float& g_nbefore,
                             const GrinFld* fin = nullptr, GrinFld* gfe = nullptr) {
  const GrinProf g = grin_prof(r, steps);
  const float* R = r + kGrRw;
  // ---- the forward's values, with its saved decisions ----
  const G3 a = {p.x - r[kGrTw], p.y - r[kGrTw + 1], p.z - r[kGrTw + 2]};
  const G3 o = grot(a, R);
  const G3 ds = grot(d, R);
  const float B = -2.0f * ds.z;
  const float t = (2.0f * o.z) / B;
  const int m = static_cast<int>((bits >> kGrinStepShift) & kGrinStepMask);
  const bool alive = bits & kGrinAlive, ok_out = bits & kGrinOkOut;
  const GrinPt s0 = {o.x + t * ds.x, o.y + t * ds.y, g.namb * ds.x, g.namb * ds.y};
  GrinPt ck[kGrinCkpts];
  GrinFld fck[kField ? kGrinCkpts : 1];  // kField: the field at each checkpoint
  GrinPt s = s0;
  GrinFld fe;  // kField: the field in the rod's frame
  if constexpr (kField) fe = grot_between(ds, grin_pdir(g, s0, 0.0f), grot(*fin, R));
  float opl = 0.0f;
  for (int i = 0; i < m; ++i) {
    if (i % kGrinSeg == 0) ck[i / kGrinSeg] = s;
    bool ok;
    if constexpr (kField) {
      if (i % kGrinSeg == 0) fck[i / kGrinSeg] = fe;
      const float z = static_cast<float>(i) * g.h;
      const GrinPt s1 = s;
      grin_step(g, s, opl, z, ok);
      fe = grot_between(grin_pdir(g, s1, z), grin_pdir(g, s, z + g.h), fe);
    } else {
      grin_step(g, s, opl, static_cast<float>(i) * g.h, ok);
    }
  }
  const float pz2_out = g.namb * g.namb - s.px * s.px - s.py * s.py;
  const float pz_out = sqrtf(ok_out ? pz2_out : 1.0f);
  const float inv_n = 1.0f / g.namb;
  const float e[3] = {s.x, s.y, g.L};
  const float dout[3] = {s.px * inv_n, s.py * inv_n, pz_out * inv_n};

  // ---- exit: p' = (x, y, L) @ R.T + tw, d' = dout @ R.T ----
  const G3 g_e = grot(gp, R);
  G3 g_dout = grot(gd, R);
  const float gpv[3] = {gp.x, gp.y, gp.z}, gdv[3] = {gd.x, gd.y, gd.z};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) tg_rw[3 * i + j] += gpv[i] * e[j] + gdv[i] * dout[j];
    tg_tw[i] += gpv[i];
  }
  GrinProfCt gc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  GrinFld gf;  // kField: the field's cotangent in the rod's frame
  G3 g_d1 = {0.0f, 0.0f, 0.0f};
  if constexpr (kField) {
    // E' = rotate_between(d1, dout, E) @ R.T, d1 = _p_dir at the exit face
    const G3 d1 = grin_pdir(g, s, g.L), dv = {dout[0], dout[1], dout[2]};
    const GrinFld ex = grot_between(d1, dv, fe);
    grin_rw_ct(gfe->r, ex.r, tg_rw);
    grin_rw_ct(gfe->i, ex.i, tg_rw);
    gf = grot_between_ct(d1, dv, fe, grot(*gfe, R), g_d1, g_dout);
  }
  GrinPt gs = {g_e.x, g_e.y, g_dout.x * inv_n, g_dout.y * inv_n};
  float g_L = g_e.z;
  if constexpr (kField) g_L += grin_pdir_ct(g, s, g.L, g_d1, gs, gc);
  // dout = (px, py, pz_out) * inv_n, inv_n = 1 / n_amb
  const float g_invn = g_dout.x * s.px + g_dout.y * s.py + g_dout.z * pz_out;
  float g_namb = -(g_invn * inv_n * inv_n);
  if (ok_out) {
    // pz_out = sqrt(n_amb^2 - px^2 - py^2)
    const float g_pz2 = g_dout.z * inv_n / (2.0f * pz_out);
    g_namb += 2.0f * g.namb * g_pz2;
    gs.px -= 2.0f * s.px * g_pz2;
    gs.py -= 2.0f * s.py * g_pz2;
  }
  // seg = alive ? opl : 0
  const float g_seg = alive ? g_opl : 0.0f;

  // ---- the steps, a segment at a time, the last first ----
  GrinPt buf[kGrinSeg];
  GrinFld fbuf[kField ? kGrinSeg : 1];  // kField: the segment's fields
  for (int seg = (m - 1) / kGrinSeg; m > 0 && seg >= 0; --seg) {
    const int i0 = seg * kGrinSeg, i1 = m < i0 + kGrinSeg ? m : i0 + kGrinSeg;
    GrinPt u = ck[seg];
    float o2 = 0.0f;
    if constexpr (kField) {
      GrinFld ue = fck[seg];
      for (int i = i0; i < i1; ++i) {
        buf[i - i0] = u;
        fbuf[i - i0] = ue;
        bool ok;
        const float z = static_cast<float>(i) * g.h;
        grin_step(g, u, o2, z, ok);
        ue = grot_between(grin_pdir(g, buf[i - i0], z), grin_pdir(g, u, z + g.h), ue);
      }
      // step i: the field's rotation from _p_dir at its start (z = i h) to
      // _p_dir at its end (z + h), then the step itself
      for (int i = i1 - 1; i >= i0; --i) {
        const float z = static_cast<float>(i) * g.h;
        const GrinPt sa = buf[i - i0], sb = i + 1 < i1 ? buf[i + 1 - i0] : u;
        const G3 a = grin_pdir(g, sa, z), b = grin_pdir(g, sb, z + g.h);
        G3 g_a = {0.0f, 0.0f, 0.0f}, g_b = {0.0f, 0.0f, 0.0f};
        gf = grot_between_ct(a, b, fbuf[i - i0], gf, g_a, g_b);
        gc.h += static_cast<float>(i + 1) * grin_pdir_ct(g, sb, z + g.h, g_b, gs, gc);
        grin_step_ct(g, sa, i, g_seg, gs, gc);
        gc.h += static_cast<float>(i) * grin_pdir_ct(g, sa, z, g_a, gs, gc);
      }
    } else {
      for (int i = i0; i < i1; ++i) {
        buf[i - i0] = u;
        bool ok;
        grin_step(g, u, o2, static_cast<float>(i) * g.h, ok);
      }
      for (int i = i1 - 1; i >= i0; --i) grin_step_ct(g, buf[i - i0], i, g_seg, gs, gc);
    }
  }
  // h = L / steps
  g_L += gc.h / static_cast<float>(steps);
  // kField: the entry coupling, E_s = rotate_between(ds, d0, E @ R), d0 =
  // _p_dir at the entry state (z = 0)
  G3 g_dsf = {0.0f, 0.0f, 0.0f};
  if constexpr (kField) {
    const G3 d0 = grin_pdir(g, s0, 0.0f);
    G3 g_d0 = {0.0f, 0.0f, 0.0f};
    gf = grot_between_ct(ds, d0, grot(*fin, R), gf, g_dsf, g_d0);
    grin_pdir_ct(g, s0, 0.0f, g_d0, gs, gc);
    grin_rw_ct(fin->r, gf.r, tg_rw);
    grin_rw_ct(fin->i, gf.i, tg_rw);
    *gfe = {grot_t(gf.r, R), grot_t(gf.i, R)};
  }

  // ---- entry: (x0, y0) = hs.xy, (px, py) = n_amb ds.xy ----
  g_namb += gs.px * ds.x + gs.py * ds.y;
  G3 g_ds = {gs.px * g.namb, gs.py * g.namb, 0.0f};
  if constexpr (kField) g_ds = {g_ds.x + g_dsf.x, g_ds.y + g_dsf.y, g_dsf.z};
  // hs = o + t ds; opl += n_cur t
  const float g_t = g_opl * n_cur + gs.x * ds.x + gs.y * ds.y;
  G3 g_o = {gs.x, gs.y, 0.0f};
  g_ds.x += t * gs.x;
  g_ds.y += t * gs.y;
  // t = 2 o.z / B, B = -2 ds.z
  g_o.z += 2.0f * g_t / B;
  const float g_B = -(g_t * t / B);
  g_ds.z += -2.0f * g_B;
  // o = (p - tw) @ R, ds = d @ R
  const G3 g_a = grot_t(g_o, R);
  const float av[3] = {a.x, a.y, a.z}, dv[3] = {d.x, d.y, d.z};
  const float gov[3] = {g_o.x, g_o.y, g_o.z}, gdsv[3] = {g_ds.x, g_ds.y, g_ds.z};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tg_rw[3 * i + j] += av[i] * gov[j] + dv[i] * gdsv[j];
  tg_tw[0] -= g_a.x;
  tg_tw[1] -= g_a.y;
  tg_tw[2] -= g_a.z;
  tg_ph[0] += g_namb + g_nafter;
  tg_ph[1] += gc.c0;
  tg_ph[2] += gc.c2;
  tg_ph[3] += gc.c4;
  tg_ph[4] += gc.cz;
  tg_ph[5] += g_L;
  g_nbefore = g_opl * t;
  gp = g_a;
  gd = grot_t(g_ds, R);
  if (!alive) gi = 0.0f;
}

// grin_backward with the field, out of line: the field's instantiations
// with GRIN rods call it, once a kernel (inlined into them, each took nvcc
// ~45 s more to build).
RTT_GR_NOINLINE void grin_backward_field(const float* r, int steps, G3 p, G3 d, uint32_t bits,
                                         float n_cur, float g_opl, float g_nafter, G3& gp,
                                         G3& gd, float& gi, float* tg_rw, float* tg_tw,
                                         float* tg_ph, float& g_nbefore, const GrinFld& fin,
                                         GrinFld& gfe) {
  grin_backward<true>(r, steps, p, d, bits, n_cur, g_opl, g_nafter, gp, gd, gi, tg_rw, tg_tw,
                      tg_ph, g_nbefore, &fin, &gfe);
}

}  // namespace rtt
