// Fused sequential backward trace for Hopper (sm_90a): kernel K2, the
// hand-written adjoint of K1 (trace_seq_fwd.cu).
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_v2_bwd (launched by trace_sequential_pallas_v2_bwd, joined to the
// forward by the custom_vjp fused_trace_grad) for the main-path kinds with
// every optional stream off.  Its plain PyTorch version is
// ops/fused_trace.py::trace_seq_bwd_plain (autograd of the eager chain), and
// the wrapper that launches it is ops/fused_trace.py::trace_seq_bwd_cuda.
//
// What it computes: the vector-Jacobian product of the fused forward.  Given
// the table, the input rays, the cotangents of the 7 output ray streams, of
// the [S, B, 7] moments and (when K1 binned a grid) of the [S, H, W] grid,
// it returns the cotangents of the 7 input ray streams and of the table.
// The TPU kernel re-runs the chain and transposes it with an in-kernel
// jax.vjp; a CUDA kernel has no autodiff, so the adjoint of every step is
// written out below.
//
// Design: one thread per ray, 256 threads per block; the flat table, the
// int32 kinds and the moment cotangent sit in shared memory, and every thread
// visits the same row at the same time, so the switch on a row's kinds is
// warp-uniform.
// - Forward sweep: the chain of K1, row by row, saving each row's input
//   state (p, d, intensity: 7 floats) and its branch decisions as bits
//   (active, chosen root, linear, degenerate normal, from_in, TIR, ...).
//   The reverse sweep takes the saved branches; it never re-decides them
//   from a re-rounded state.  The saved state is a per-thread array sized by
//   the template bucket kMaxRows: with 8 the loops unroll and it stays in
//   registers (the main path has 5 rows); with 64 it lives in local memory.
// - Reverse sweep, row K-1 down to 0: the adjoint of the masked update
//   where(active, new, old), of the sensor moment terms, of the physics
//   (REFLECT, SNELL with the from_in and TIR branches, APERTURE with its mask
//   constant, BLOCK), of the normal (zero for a degenerate one) and of the
//   intersection (plane formula or the quadric root taken), then of the
//   world->surface frame.  An inactive row passes every cotangent through.
// - Table cotangent: the world-scale epsilon, the bound columns (sb, vb, Rs,
//   ts) and n_sign enter the chain only through comparisons and selects, so
//   their cotangent is zero.  A row's cotangent is nonzero only in q[0:5],
//   Rw[0:9], tw[0:3] and ph[0:2]: 19 of 160 columns.  Those are reduced over
//   the block (warp shuffles, one slot per warp and row in shared memory, a
//   fixed-order sum over warps) into a [blocks, K, 19] buffer that the
//   wrapper sums and scatters into [K, 160].  No atomics: deterministic.
// - Grid cotangent: at each active sensor row the ray's incoming intensity
//   gets g_grid[slot, iy, ix] (the gather of the TPU kernel's
//   _grid_partial_g_bwd, exact in float32), with the bin recomputed in the
//   reverse sweep from the hit it re-derives from the saved state.  The grid
//   cotangent stays in device memory (256 KB for 256 x 256), read through L2.
// - Dead lanes past N trace a zero ray with d = (0, 0, 1) and zero
//   intensity: never active, so they add nothing and write nothing.
//
// What bounds it: per ray it reads 8 input streams and up to 7 cotangent
// streams (60 B) and writes 7 cotangents (28 B), about 88 B against K1's
// 60 B, and does roughly 2-3x K1's arithmetic (a forward sweep, then an
// adjoint about twice the size of the forward), plus 19 warp reductions per
// row.  At 1M rays that is 88 MB, ~26 us at the H100's 3.35 TB/s; K1 measured
// far above its bandwidth bound, so K2 should be bound by its arithmetic and
// the per-row reductions.  This is an estimate by count; PERF.md holds the
// measured time.
//
// Numerics: fp32 throughout, built without --use_fast_math (IEEE sqrt and
// division, denormals kept), as K1.  The derivative conventions follow
// PyTorch autograd of the eager chain: ties of the two roots split the
// cotangent in halves (torch.minimum), |x| has derivative 0 at 0, and the
// where-guarded sqrt and division branches get no cotangent.

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

using namespace rtt;

namespace {

// Table columns with a nonzero cotangent, in the order of the partials
// buffer (ops/fused_trace.py GRAD_COLS): q[0:5], Rw[0:9], tw[0:3], ph[0:2].
constexpr int kGradCols = 19;
constexpr int kGQ = 0, kGRw = 5, kGTw = 14, kGPh = 17;

// Branch decisions of one row, saved by the forward sweep.
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

// The grid's cotangent g[S, h, w] over [-e, e]^2 (g null: no grid, or a
// zero cotangent).
struct GridCt {
  const float* g;
  int h, w;
  float e;
};

__device__ __forceinline__ bool uses_normal(int ph) { return ph == REFLECT || ph == SNELL; }

// One row of K1's chain: updates (p, d, inten) and returns the row's bits.
__device__ __forceinline__ uint32_t row_forward(const float* r, const RowKinds& kd, V3& p, V3& d,
                                                float& inten) {
  uint32_t bits = 0;
  const float* q = r + kQ;
  const float* Rw = r + kRw;

  // ---- intersect (core/intersect.py) ----
  const V3 o = rot(V3{p.x - r[kTw], p.y - r[kTw + 1], p.z - r[kTw + 2]}, Rw);
  const V3 ds = rot(d, Rw);
  float t1, t2;
  bool v1, v2;
  if (kd.plane) {
    const float B = -2.0f * ds.z;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    t1 = (2.0f * o.z) / B_safe;
    v1 = fabsf(B) >= kSolverEps;
    t2 = t1;
    v2 = false;
  } else {
    const float A = q[0] * ds.x * ds.x + q[1] * ds.y * ds.y + q[2] * ds.z * ds.z;
    const float B =
        2.0f * (q[0] * o.x * ds.x + q[1] * o.y * ds.y + q[2] * o.z * ds.z) + q[3] * ds.z;
    const float C = q[0] * o.x * o.x + q[1] * o.y * o.y + q[2] * o.z * o.z + q[3] * o.z + q[4];
    const float disc = B * B - 4.0f * A * C;
    const bool hit = disc >= 0.0f;
    const float sq = sqrtf((hit ? disc : 1.0f) + 1e-24f);
    const bool linear = fabsf(A) < kSolverEps;
    const float A_safe = linear ? 1.0f : A;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    const float t_lin = -C / B_safe;
    t1 = linear ? t_lin : (-B - sq) / (2.0f * A_safe);
    t2 = linear ? t_lin : (-B + sq) / (2.0f * A_safe);
    v1 = (linear && fabsf(B) >= kSolverEps) || (!linear && hit);
    v2 = v1;
    if (linear) bits |= kLinear;
  }
  if (kd.sb != SB_NONE) {
    bool keep1 = sb_check(kd.sb, r + kSb, fma3(o, t1, ds));
    bool keep2 = sb_check(kd.sb, r + kSb, fma3(o, t2, ds));
    if (kd.invert) {
      keep1 = !keep1;
      keep2 = !keep2;
    }
    v1 = v1 && keep1;
    v2 = v2 && keep2;
  }
  const float scale = sqrtf(dot3(o, o) + dot3(p, p) + 1e-12f);
  const float eps = kIntersectEps + kRelEps * scale;
  const float tm1 = (v1 && t1 > eps) ? t1 : kBig;
  const float tm2 = (v2 && t2 > eps) ? t2 : kBig;
  const float t_best = fminf(tm1, tm2);
  bool valid = t_best < kBig * 0.5f;
  if (tm1 <= tm2) bits |= kRoot1;
  if (tm2 <= tm1) bits |= kRoot2;
  const float t = valid ? t_best : 0.0f;
  const V3 hs = fma3(o, t, ds);
  if (kd.vb != VB_NONE) {
    const V3 e = rot_t(hs, r + kRs);
    const V3 he = {e.x + r[kTs], e.y + r[kTs + 1], e.z + r[kTs + 2]};
    valid = valid && vb_check(kd.vb, r + kVb, he);
  }

  // ---- world normal (core/intersect.py::normal_world) ----
  V3 nw = {0.0f, 0.0f, 1.0f};
  if (uses_normal(kd.ph)) {
    if (kd.plane) {
      nw = {Rw[2], Rw[5], Rw[8]};
    } else {
      const float gx = 2.0f * q[0] * hs.x;
      const float gy = 2.0f * q[1] * hs.y;
      const float gz = 2.0f * q[2] * hs.z + q[3];
      const float g2 = gx * gx + gy * gy + gz * gz;
      const bool degen = g2 < kNormalEps * kNormalEps;
      const float inv =
          (r[kNSign] < 0.0f ? -1.0f : 1.0f) / (sqrtf(degen ? 1.0f : g2) + kNormalEps);
      const V3 nl = degen ? V3{0.0f, 0.0f, 1.0f} : V3{gx * inv, gy * inv, gz * inv};
      nw = rot_t(nl, Rw);
      if (degen) bits |= kDegen;
    }
  }

  // ---- physics (core/static_dispatch.py::apply_physics_one) ----
  V3 nd = d;
  float imod = 1.0f;
  if (kd.ph == BLOCK) {
    nd = {0.0f, 0.0f, 0.0f};
    imod = 0.0f;
  } else if (kd.ph == REFLECT) {
    nd = fma3(d, -2.0f * dot3(d, nw), nw);
  } else if (kd.ph == SNELL) {
    const float dn = dot3(d, nw);
    const bool from_in = dn < 0.0f;
    const float eff_sign = from_in ? 1.0f : -1.0f;
    const float cos_i = fabsf(dn);
    const float n1 = from_in ? r[kPh] : r[kPh + 1];
    const float n2 = from_in ? r[kPh + 1] : r[kPh];
    const bool n2_small = fabsf(n2) < 1e-12f;
    const float mu = n1 / (n2_small ? 1e-12f : n2);
    const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
    if (from_in) bits |= kFromIn;
    if (dn > 0.0f) bits |= kDnPos;
    if (n2_small) bits |= kN2Small;
    if (sin2_t > 1.0f) {
      nd = fma3(d, -2.0f * dn, nw);
      bits |= kTir;
    } else {
      const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
      const float coef = (mu * cos_i - cos_t) * eff_sign;
      nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
    }
  } else if (kd.ph == APERTURE) {
    const float mod = sb_check(kd.sb, r + kSb, hs) ? 1.0f : 0.0f;
    nd = {d.x * mod, d.y * mod, d.z * mod};
    imod = mod;
    if (mod != 0.0f) bits |= kMod;
  }

  if (valid && inten > 0.0f) {
    bits |= kActive;
    p = fma3(p, t, d);
    d = nd;
    inten = inten * imod;
  }
  return bits;
}

// Adjoint of one row.  (p, d, inten) is the row's saved input state and
// (gp, gd, gi) the cotangent of its output state, replaced by the cotangent
// of its input state; tg[19] receives the row's table cotangent.  gm is the
// [S, B, 7] moment cotangent and gg the grid's.
__device__ __forceinline__ void row_backward(const float* r, const RowKinds& kd, V3 p, V3 d,
                                             float inten, uint32_t bits, int rid,
                                             const float* gm, int n_bundles, const GridCt& gg,
                                             V3& gp, V3& gd, float& gi, float* tg) {
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
  const float imod = kd.ph == BLOCK ? 0.0f : (kd.ph == APERTURE && !(bits & kMod) ? 0.0f : 1.0f);
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
  if (kd.ph == TRANSMIT) {
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

// Block-reduce one row's table cotangent into this warp's slot (lane 0
// writes).  Columns that are structurally zero for the row's kinds skip
// their shuffles: q on the plane path, ph off the SNELL path.
__device__ __forceinline__ void reduce_row(const RowKinds& kd, const float* tg, float* slot,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) {
    if (c < kGRw && kd.plane) continue;
    if (c >= kGPh && kd.ph != SNELL) continue;
    const float s = warp_sum(tg[c]);
    if (lane == 0) slot[c] = s;
  }
}

template <int kMaxRows>
__global__ void __launch_bounds__(kThreads)
trace_seq_bwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
                     int n_rows, const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ pz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
                     const float* __restrict__ gpx, const float* __restrict__ gpy,
                     const float* __restrict__ gpz, const float* __restrict__ gdx,
                     const float* __restrict__ gdy, const float* __restrict__ gdz,
                     const float* __restrict__ gintensity, const float* __restrict__ gmom,
                     float* __restrict__ cpx, float* __restrict__ cpy, float* __restrict__ cpz,
                     float* __restrict__ cdx, float* __restrict__ cdy, float* __restrict__ cdz,
                     float* __restrict__ cintensity, float* __restrict__ partials,
                     int n_slots, int n_bundles, GridCt gg, long long n) {
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* gm = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* warp_tab = gm + n_mom;  // [kWarps, n_rows, kGradCols]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < n_mom; j += kThreads) gm[j] = gmom[j];
  for (int j = tid; j < kWarps * n_rows * kGradCols; j += kThreads) warp_tab[j] = 0.0f;
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  V3 p = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  float inten = 0.0f;
  int rid = -1;
  if (live) {
    p = {px[i], py[i], pz[i]};
    d = {dx[i], dy[i], dz[i]};
    inten = intensity[i];
    rid = ray_id[i];
  }

  // ---- forward sweep: save each row's input state and branch bits ----
  float saved[kMaxRows][7];
  uint32_t bits[kMaxRows];
#pragma unroll (kMaxRows <= 8 ? kMaxRows : 1)
  for (int k = 0; k < kMaxRows; ++k) {
    if (k < n_rows) {
      saved[k][0] = p.x;
      saved[k][1] = p.y;
      saved[k][2] = p.z;
      saved[k][3] = d.x;
      saved[k][4] = d.y;
      saved[k][5] = d.z;
      saved[k][6] = inten;
      bits[k] = row_forward(tab + k * kRowWidth, read_row_kinds(knd + k * kKindWidth), p, d, inten);
    }
  }

  // ---- reverse sweep ----
  V3 gp = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  float gi = 0.0f;
  if (live) {
    gp = {gpx ? gpx[i] : 0.0f, gpy ? gpy[i] : 0.0f, gpz ? gpz[i] : 0.0f};
    gd = {gdx ? gdx[i] : 0.0f, gdy ? gdy[i] : 0.0f, gdz ? gdz[i] : 0.0f};
    gi = gintensity ? gintensity[i] : 0.0f;
  }
#pragma unroll (kMaxRows <= 8 ? kMaxRows : 1)
  for (int kk = kMaxRows - 1; kk >= 0; --kk) {
    if (kk < n_rows) {
      const RowKinds kd = read_row_kinds(knd + kk * kKindWidth);
      float tg[kGradCols];
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) tg[c] = 0.0f;
      const V3 sp = {saved[kk][0], saved[kk][1], saved[kk][2]};
      const V3 sd = {saved[kk][3], saved[kk][4], saved[kk][5]};
      row_backward(tab + kk * kRowWidth, kd, sp, sd, saved[kk][6], bits[kk], rid, gm,
                   n_bundles, gg, gp, gd, gi, tg);
      if (partials != nullptr && __any_sync(0xffffffffu, bits[kk] & kActive))
        reduce_row(kd, tg, warp_tab + (warp * n_rows + kk) * kGradCols, lane);
    }
  }

  if (live && cpx != nullptr) {
    cpx[i] = gp.x;
    cpy[i] = gp.y;
    cpz[i] = gp.z;
    cdx[i] = gd.x;
    cdy[i] = gd.y;
    cdz[i] = gd.z;
    cintensity[i] = gi;
  }

  if (partials == nullptr) return;
  __syncthreads();
  const int n_tab = n_rows * kGradCols;
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_tab;
  for (int j = tid; j < n_tab; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_tab[w * n_tab + j];
    out[j] = s;
  }
}

template <int kMaxRows>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           const float* const* g_rays, const float* gmom, float* const* c_rays, float* partials,
           int n_slots, int n_bundles, GridCt gg, long long n) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(trace_seq_bwd_kernel<kMaxRows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_seq_bwd_kernel<kMaxRows><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
      ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6], gmom,
      c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6], partials,
      n_slots, n_bundles, gg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer.  Each of the 7 output-ray cotangents
// g* may be null (a zero cotangent); the 7 input-ray cotangents c* are all
// given or all null (not wanted), and so is the partials buffer of
// ceil(n / 256) * n_rows * 19 floats (the table cotangent).  gmom holds
// n_slots * n_bundles * 7 floats; ggrid, the grid's cotangent, holds
// n_slots * grid_h * grid_w floats over [-grid_e, grid_e]^2, or is null.
extern "C" int rtt_trace_seq_bwd(const float* table, const int32_t* kinds, int n_rows,
                                 const float* px, const float* py, const float* pz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* intensity, const int32_t* ray_id,
                                 const float* gpx, const float* gpy, const float* gpz,
                                 const float* gdx, const float* gdy, const float* gdz,
                                 const float* gintensity, const float* gmom, float* cpx,
                                 float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
                                 float* cintensity, float* partials, int n_slots, int n_bundles,
                                 const float* ggrid, int grid_h, int grid_w, float grid_e,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                       static_cast<size_t>(n_slots) * n_bundles * kMoments +
                       static_cast<size_t>(kWarps) * n_rows * kGradCols);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  const float* g_rays[7] = {gpx, gpy, gpz, gdx, gdy, gdz, gintensity};
  float* c_rays[7] = {cpx, cpy, cpz, cdx, cdy, cdz, cintensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  if (n_rows <= 8)
    return launch<8>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                     partials, n_slots, n_bundles, gg, n);
  return launch<64>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                    partials, n_slots, n_bundles, gg, n);
}
