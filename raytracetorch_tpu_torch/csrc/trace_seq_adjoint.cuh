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
//
// The Fresnel kinds (kFresnel): FRESNEL's drawn branch is a saved bit
// (kReflect), and its adjoint goes through the chosen direction alone (the
// choice has no derivative); FRESNEL_W's and REFLECT_W's intensity factor
// clip(1 - R, 0, 1) and clip(R, 0, 1) pass their cotangent through the
// unpolarized reflectance R of the interface (fresnel_weight_backward) into
// the direction, the normal (so the curvatures), the indices and, on a
// dispersive row, the wavelength; the clip passes it inside [0, 1] (its
// bounds included, as torch.clamp), TIR none.  A REFLECT_W row that a ray
// misses zeroes its intensity, so the intensity's cotangent stops there.
//
// Coatings and metal mirrors (kCoat): the reflectance (or, through an
// absorbing stack, the transmittance) that weighs a coated row's intensity
// is its stack's, and its cotangent goes back through the stack
// (thin_film.cuh::stack_rt_ct, which recomputes the stack and saves no
// state across rows) into the cosine of incidence (so the direction and the
// normal), the media's indices (or a metal's ambient, and a metal's own
// index: ph[0:2], or through a dispersive metal's knots the wavelength), the
// wavelength, and the layers' thicknesses, whose cotangents a row's
// adjoint adds into `tc` (the coat columns, reduced after the others).
//
// The diffractive and ideal elements (kDiff): a LINEAR, GRATING, MLA or DOE
// row's direction map is reversed by diffractive.cuh's adjoints into the
// direction, the surface-frame hit (so through the intersection into the
// position, the direction and the table), the row's Rw and ph[0:6], the
// ray's wavelength, a DOE row's media and its radial coefficients, which a
// row's adjoint adds into `tf` (the ff columns, reduced after the coat
// columns).  GRATING's and DOE's evanescence is the saved bit kPgOk (an
// evanescent order passes its local d_z through and zeroes the intensity),
// DOE's side the saved kFromIn; the lenslet cell and the sign of d_z are
// recomputed from the replayed state, which reaches the forward's bit for
// bit.  A DOE row's efficiency passes the intensity's cotangent through
// sinc^2 (none where the `safe` select took the constant 1).
//
// Freeform surfaces (kFreeform): a freeform row's root is the base conic's
// refined by 8 Newton steps and its normal the sag's; the adjoint reverses
// both (freeform.cuh::ff_refine_backward, ff_normal_backward), the steps'
// inputs recomputed from the saved state, as jax.vjp of the TPU kernel's
// chain differentiates the unrolled steps.  The cotangents of the base
// conic and the even-asphere terms go to q[0], q[2] and asph[0:4], those of
// the coefficients into `tf` (the 32 ff columns of the instantiation with
// freeform surfaces, reduced after the coat columns; a DOE row's 8 are its
// first 8).
//
// The polarized field (kField): the forward replay carries each ray's field
// (field.cuh) and saves it before each row, six words more a row; the
// reverse sweep carries its cotangent.  A row's adjoint reverses the
// transport (field.cuh::field_transport_ct) into the incoming field, the
// directions, the normal, the media, a JONES row's ph[0:5] and Rw columns
// 0 and 1 and the wavelength; the sensor weight w |E|^2 sends its share to
// the incoming field, and a FRESNEL_W or REFLECT_W row's polarized
// reflectance its share through field.cuh::polarized_r_ct
// (fresnel_weight_backward with kSP).  The new direction the transport
// reads is the next row's saved direction (the ray's final one after the
// last row), the value the forward moved the ray to.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

namespace rtt {

// Table columns with a nonzero cotangent, in the order of the partials
// buffer (ops/fused_trace.py GRAD_COLS): q[0:5], Rw[0:9], tw[0:3], ph[0:2];
// with phase plates (PLATE_GRAD_COLS) also ph[2:6]: the order, the design
// wavelength and the half extents of a PHASE_GRID row; with the extended
// kinds (EXT_GRAD_COLS) also asph[0:4], an even asphere's a4..a10; and on a
// table with a dispersive row (DISP_GRAD_COLS) after those the 12 disp
// columns, reduced on their own (disp_backward), only for dispersive rows.
constexpr int kGradCols = 19;
constexpr int kPlateGradCols = 23;
constexpr int kExtGradCols = 27;
constexpr int kDispGradCols = 12;
constexpr int kGQ = 0, kGRw = 5, kGTw = 14, kGPh = 17, kGAsph = 23;

template <bool kPlates, bool kExt = false>
__host__ __device__ constexpr int grad_cols() {
  return kExt ? kExtGradCols : kPlates ? kPlateGradCols : kGradCols;
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
constexpr uint32_t kPgOk = 1u << 10;    // PHASE_GRID, GRATING, DOE: not evanescent
constexpr uint32_t kUClip = 1u << 11;   // PHASE_GRID: u clipped
constexpr uint32_t kVClip = 1u << 12;   // PHASE_GRID: v clipped
constexpr uint32_t kReflect = 1u << 13; // FRESNEL: the draw chose reflection

// A ray's saved state at one row or bounce: the input p, d and intensity
// and one word of bits, kStateWords 32-bit words.  The backward kernels
// keep them in shared memory as [slot][word][thread], the thread index
// fastest: a warp's access to one word is 32 consecutive words, free of
// bank conflicts, and no register holds them across the sweeps.  kStride is
// the distance between two words of one thread's slot (kThreads there; 1
// for a per-thread array).
constexpr int kStateWords = 8;

// The instantiations with the optical path length (kOpl) save one word more
// per row or bounce, the index of the medium the ray travels in before it
// (opl itself needs none: its cotangent is the same at every row).
template <bool kOpl, bool kField = false>
__host__ __device__ constexpr int state_words() {
  return kStateWords + (kOpl ? 1 : 0) + (kField ? 6 : 0);
}

// The instantiation with the field (kField, which has kOpl) saves the
// incoming field after the medium: six words, Er x, y, z, then Ei x, y, z.
template <int kStride>
__device__ __forceinline__ void put_field(float* s, const Fld& e) {
  float* f = s + (kStateWords + 1) * kStride;
  f[0] = e.r.x;
  f[kStride] = e.r.y;
  f[2 * kStride] = e.r.z;
  f[3 * kStride] = e.i.x;
  f[4 * kStride] = e.i.y;
  f[5 * kStride] = e.i.z;
}

template <int kStride>
__device__ __forceinline__ Fld get_field(const float* s) {
  const float* f = s + (kStateWords + 1) * kStride;
  return {{f[0], f[kStride], f[2 * kStride]}, {f[3 * kStride], f[4 * kStride], f[5 * kStride]}};
}

// A row's field in the reverse sweep (kField): its incoming field e (saved),
// g, the cotangent of the field after the row (which row_backward replaces
// by the one before it), and nd, the direction the row moved the ray to.
struct FieldCt {
  Fld e;
  Fld g;
  V3 nd;
};

template <int kStride>
__device__ __forceinline__ void put_medium(float* s, float n_cur) {
  s[kStateWords * kStride] = n_cur;
}

template <int kStride>
__device__ __forceinline__ float get_medium(const float* s) {
  return s[kStateWords * kStride];
}

// The optical path length's adjoint state of one ray (kOpl): the path
// length's cotangent g_opl (constant along the chain: opl is a sum), the
// index n_cur of the medium before the row (saved), and g_n, the cotangent
// of the medium after the row, which row_backward replaces by the one
// before it.
struct OplCt {
  float g_opl, n_cur, g_n;
};

template <int kStride>
__device__ __forceinline__ void put_state(float* s, V3 p, V3 d, float inten, uint32_t word) {
  s[0] = p.x;
  s[kStride] = p.y;
  s[2 * kStride] = p.z;
  s[3 * kStride] = d.x;
  s[4 * kStride] = d.y;
  s[5 * kStride] = d.z;
  s[6 * kStride] = inten;
  s[7 * kStride] = __uint_as_float(word);
}

template <int kStride>
__device__ __forceinline__ void get_state(const float* s, V3& p, V3& d, float& inten,
                                          uint32_t& word) {
  p = {s[0], s[kStride], s[2 * kStride]};
  d = {s[3 * kStride], s[4 * kStride], s[5 * kStride]};
  inten = s[6 * kStride];
  word = __float_as_uint(s[7 * kStride]);
}

// What a row's adjoint gives towards the wavelength's cotangent
// (kDispersion): a dispersive row's cotangents of its two media indices,
// which disp_backward carries on to the disp columns and the wavelength, and
// the cotangent of the wavelength where a row reads it itself (a PHASE_GRID
// row's kick), summed over the rows.
struct WaveCt {
  float n_in, n_out;
  float wl;
};

// Resident blocks of kThreads per SM that K2's and K6's register budget is
// capped for (__launch_bounds__): 2 leaves a thread 128 registers, which
// the instantiations without plate code fit with no spill; K6's with plate
// code spills a few words there and still runs faster than with one block
// (PERF.md).
constexpr int kBwdMinBlocks = 2;

// The grid's cotangent g[S, h, w] over [-e, e]^2 (g null: no grid, or a
// zero cotangent).
struct GridCt {
  const float* g;
  int h, w;
  float e;
};

// The physics reads the normal's value: REFLECT and SNELL, and with
// kFresnel the Fresnel kinds (and, for the side d.n < 0 alone, PHASE_GRID,
// whose adjoint takes that side from its bits and gives the normal no
// cotangent).
template <bool kFresnel = false>
__device__ __forceinline__ bool uses_normal(int ph) {
  return ph == REFLECT || ph == SNELL ||
         (kFresnel && (ph == FRESNEL || ph == FRESNEL_W || ph == REFLECT_W));
}

// The bits of a row's branches, from the hit, the normal's degeneracy and the
// physics branches (without kActive).
template <bool kFresnel = false>
__device__ __forceinline__ uint32_t branch_bits(const RowHit& h, bool degen,
                                                const PhysBranch& br) {
  return (h.root1 ? kRoot1 : 0u) | (h.root2 ? kRoot2 : 0u) | (h.linear ? kLinear : 0u) |
         (degen ? kDegen : 0u) | (br.from_in ? kFromIn : 0u) | (br.dn_pos ? kDnPos : 0u) |
         (br.tir ? kTir : 0u) | (br.n2_small ? kN2Small : 0u) | (br.pass ? kMod : 0u) |
         (br.pg_ok ? kPgOk : 0u) | (br.u_clip ? kUClip : 0u) | (br.v_clip ? kVClip : 0u) |
         (kFresnel && br.reflect ? kReflect : 0u);
}

// One row of K1's chain: updates (p, d, inten) where the row is active and
// returns the row's bits.  With kFresnel a FRESNEL row draws with the ray's
// uniform u, and a REFLECT_W row zeroes the intensity of a ray it does not
// hold.  With kDiff the diffractive kinds and the ELLIPSE bound.  With
// kFuzzy (which has kDiff) a row with a fuzzy program `prog` (fuzzy.cuh;
// null: none) multiplies its factor by the program's value at the hit.
// With kFreeform (which has kFuzzy) a row with exponent pairs `ffp` (null:
// not freeform) is a freeform surface.  With kField (which has kFreeform)
// the row's physics sees the ray's field `fe` (field_physics) and an active
// row transports it.
template <bool kPlates, bool kExt = false, bool kDispersion = kExt, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false, bool kFuzzy = false, bool kFreeform = false,
          bool kField = false>
__device__ __forceinline__ uint32_t row_forward(const float* r, const RowKinds& kd,
                                                const Plates& pl, V3& p, V3& d, float& inten,
                                                float u = 0.0f, const float* side = nullptr,
                                                const int32_t* prog = nullptr,
                                                const int32_t* ffp = nullptr,
                                                Fld* fe = nullptr) {
  const RowHit h = intersect_row<kPlates, kExt, kDiff, kFreeform>(r, kd, p, d, ffp);
  bool degen = false;
  const V3 nw = uses_normal<kFresnel>(kd.ph) || (kPlates && kd.ph == PHASE_GRID) ||
                        (kDiff && kd.ph == DOE)
                    ? world_normal<kExt, kFreeform>(r, kd.plane, h.hs, &degen, kd.asph, ffp)
                    : V3{0.0f, 0.0f, 1.0f};
  PhysBranch br = {};
  V3 nd;
  float imod;
  FieldStack fst;
  if constexpr (kField)
    field_physics<kDispersion, kDiff>(r, kd, d, nw, h.hs, pl, u, *fe, side, nd, imod, &br, fst);
  else
    apply_physics<kPlates, kExt, kDispersion, kFresnel, kCoat, kDiff>(
        r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, &br, kd.dispm, u, kd.coat, side);
  if constexpr (kFuzzy) {
    if (prog != nullptr) imod = imod * fuzzy_eval<false>(prog, h.hs.x, h.hs.y, h.hs.z).w;
  }
  uint32_t bits = branch_bits<kFresnel>(h, degen, br);
  if (h.valid && inten > 0.0f) {
    bits |= kActive;
    if constexpr (kField)
      *fe = field_transport(field_row<kDispersion>(r, kd, d, nd, nw, imod, pl.wl, fst), *fe);
    p = fma3(p, h.t, d);
    d = nd;
    inten = inten * imod;
  } else if (kFresnel && kd.ph == REFLECT_W) {
    inten = 0.0f;
  }
  return bits;
}

// The cotangents g_n1, g_n2 of the indices of the media of incidence and
// transmission: into ph[0:2] (tg) by the side the ray arrived from.  On a
// dispersive row (kDispersion) a side's index is its d-line index ph[side]
// plus a term of the wavelength (Cauchy), ph[side] (constant) or the
// Sellmeier formula, which reads no ph: tg takes the cotangents of the first
// two kinds, and wc keeps both for disp_backward, which carries them on to
// the disp columns and the wavelength after tg is reduced.  A row's first
// call sets wc's indices' cotangents; with kAdd a further call of the same
// row (the Fresnel weights' reflectance) adds to them.
template <bool kDispersion, bool kAdd = false>
__device__ __forceinline__ void media_backward(int dispm, bool from_in, float g_n1, float g_n2,
                                               float* tg, WaveCt* wc) {
  if constexpr (kDispersion) {
    if (dispm != 0) {
      if constexpr (kAdd) {
        const float g_in = from_in ? g_n1 : g_n2, g_out = from_in ? g_n2 : g_n1;
        wc->n_in += g_in;
        wc->n_out += g_out;
        if (disp_model(dispm, 0) != DISP_SELLMEIER) tg[kGPh] += g_in;
        if (disp_model(dispm, 1) != DISP_SELLMEIER) tg[kGPh + 1] += g_out;
        return;
      }
      wc->n_in = from_in ? g_n1 : g_n2;
      wc->n_out = from_in ? g_n2 : g_n1;
      if (disp_model(dispm, 0) != DISP_SELLMEIER) tg[kGPh] += wc->n_in;
      if (disp_model(dispm, 1) != DISP_SELLMEIER) tg[kGPh + 1] += wc->n_out;
      return;
    }
  }
  tg[kGPh] += from_in ? g_n1 : g_n2;
  tg[kGPh + 1] += from_in ? g_n2 : g_n1;
}

// The forward values of the refraction at a Fresnel row (kFresnel), from the
// saved sides (kFromIn, kN2Small): core/physics.py::refract_components away
// from TIR.
struct FresnelFwd {
  float dn, cos_i, n1, n2, n2_safe, mu, one_m_c2, cos_t;
};

template <bool kDispersion>
__device__ __forceinline__ FresnelFwd fresnel_forward(const float* r, const RowKinds& kd,
                                                      const Plates& pl, V3 d, V3 nw,
                                                      uint32_t bits) {
  FresnelFwd f;
  f.dn = dot3(d, nw);
  f.cos_i = fabsf(f.dn);
  media_iors<kDispersion>(r, bits & kFromIn, kd.dispm, pl.wl, f.n1, f.n2);
  f.n2_safe = (bits & kN2Small) ? 1e-12f : f.n2;
  f.mu = f.n1 / f.n2_safe;
  f.one_m_c2 = 1.0f - f.cos_i * f.cos_i;
  f.cos_t = sqrtf(fmaxf(1.0f - f.mu * f.mu * f.one_m_c2, 0.0f));
  return f;
}

// Adjoint of R = fresnel_R(cos_i, cos_t, n1, n2) away from TIR: g_R, R's
// cotangent, adds the cotangents of the direction (g_d), of the normal
// (g_nw) and of the media's indices (media_backward: ph[0:2], or on a
// dispersive row wc).  Each line reverses a line of fresnel_R or of
// refract_components.  With kSP (kField: the polarized reflectance's,
// field.cuh::polarized_r) g_R and g_rp are the cotangents of a bare
// interface's Rs = xs^2 and Rp = xp^2 in place of R's.
template <bool kDispersion, bool kSP = false>
__device__ __forceinline__ void fresnel_weight_backward(const RowKinds& kd, const FresnelFwd& f,
                                                        V3 d, V3 nw, uint32_t bits, float g_R,
                                                        V3& g_d, V3& g_nw, float* tg,
                                                        WaveCt* wc, float g_rp = 0.0f) {
  const float ci = f.cos_i, ct = f.cos_t, n1 = f.n1, n2 = f.n2;
  // ---- R = (xs^2 + xp^2) / 2, xs = as / bs, xp = ap / bp ----
  const float as = n1 * ci - n2 * ct, bs = n1 * ci + n2 * ct + 1e-8f;
  const float ap = n1 * ct - n2 * ci, bp = n1 * ct + n2 * ci + 1e-8f;
  const float xs = as / bs, xp = ap / bp;
  const float g_xs = kSP ? 2.0f * g_R * xs : g_R * xs;  // 0.5 g_R 2 x
  const float g_xp = kSP ? 2.0f * g_rp * xp : g_R * xp;
  const float g_as = g_xs / bs, g_bs = -(g_xs * xs / bs);
  const float g_ap = g_xp / bp, g_bp = -(g_xp * xp / bp);
  float g_n1 = (g_as + g_bs) * ci + (g_ap + g_bp) * ct;
  float g_n2 = (g_bs - g_as) * ct + (g_bp - g_ap) * ci;
  float g_ci = (g_as + g_bs) * n1 + (g_bp - g_ap) * n2;
  const float g_ct = (g_bs - g_as) * n2 + (g_ap + g_bp) * n1;
  // ---- cos_t = sqrt(max(1 - sin2_t, 0)), sin2_t = mu^2 (1 - cos_i^2);
  // at the critical angle itself (cos_t = 0) no derivative, as the plain
  // version's guarded square root (core/physics.py::refract_components) ----
  const float g_sin2 = ct > 0.0f ? -(g_ct / (2.0f * ct)) : 0.0f;
  const float g_mu = g_sin2 * 2.0f * f.mu * f.one_m_c2;
  g_ci += g_sin2 * f.mu * f.mu * (-2.0f * ci);
  // ---- mu = n1 / n2_safe ----
  g_n1 += g_mu / f.n2_safe;
  if (!(bits & kN2Small)) g_n2 -= g_mu * f.mu / f.n2_safe;
  // ---- cos_i = |d . n| ----
  const bool from_in = bits & kFromIn;
  const float sgn = from_in ? -1.0f : ((bits & kDnPos) ? 1.0f : 0.0f);
  const float g_dn = g_ci * sgn;
  g_d = fma3(g_d, g_dn, nw);
  g_nw = fma3(g_nw, g_dn, d);
  // after the direction's adjoint, which set the media's cotangents
  media_backward<kDispersion, true>(kd.dispm, from_in, g_n1, g_n2, tg, wc);
}

// A coated or metal row's weight (kCoat), from the row's saved branches:
// a metal REFLECT row's (Rs + Rp) / 2; away from TIR a coated FRESNEL_W
// row's clip(1 - R, 0, 1) (an absorbing stack's clip(T, 0, 1)), a coated
// REFLECT_W row's clip(R, 0, 1), an absorbing FRESNEL row's transmitted
// branch's clip(T / max(1 - R, 1e-12), 0, 1).  Returns whether the row has
// one; then `a` receives its stack, `imod` the weight, and g_r, g_t the
// cotangents of the stack's mean R and T from g_w, the weight's (the clips
// pass it inside [0, 1], bounds included, as torch.clamp).  With kPol (the
// field, kField) R and T are the polarized ones of the incoming field *e
// (field.cuh::polarized_rt, a metal's R its polarized one) from the row's
// evaluated stack *fs (field_stack; `a` is not written): *b receives the
// s/p basis and *w the weighing, and g_r, g_t are R_pol's and T_pol's.
template <bool kPol = false>
__device__ __forceinline__ bool stack_weight(const float* r, const RowKinds& kd, const Plates& pl,
                                             V3 d, V3 nw, uint32_t bits, const float* side,
                                             float g_w, StackIn& a, float& imod, float& g_r,
                                             float& g_t, const Fld* e = nullptr,
                                             const FieldStack* fs = nullptr, SpBasis* b = nullptr,
                                             PolRT* w = nullptr) {
  const float cos_i = fabsf(dot3(d, nw));
  if (kd.ph == REFLECT) {
    if (!(kd.coat & kCoatMetal)) return false;
    if constexpr (kPol) {
      *b = sp_basis(F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z});
      *w = polarized_rt(*e, *b, fs->s.R, fs->p.R, 0.0f, 0.0f);
      imod = w->R;
    } else {
      a = metal_stack(r, kd.coat, side, cos_i, pl.wl);
      imod = stack_rt_unpolarized(a).R;
    }
    g_r = g_w;
    return true;
  }
  const bool absorbing = kd.coat & kCoatAbsorbing;
  if ((kd.coat & kCoatCountMask) == 0 || (bits & kTir) ||
      !(kd.ph == FRESNEL_W || kd.ph == REFLECT_W ||
        (kd.ph == FRESNEL && absorbing && !(bits & kReflect))))
    return false;
  StackRT rt;
  if constexpr (kPol) {
    *b = sp_basis(F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z});
    *w = polarized_rt(*e, *b, fs->s.R, fs->p.R, fs->s.T, fs->p.T);
    rt = {w->R, w->T};
  } else {
    float n1, n2;
    media_iors<true>(r, bits & kFromIn, kd.dispm, pl.wl, n1, n2);
    a = coated_stack(r, kd.coat, side, n1, n2, cos_i, pl.wl);
    rt = stack_rt_unpolarized(a);
  }
  float x;
  if (kd.ph == FRESNEL) {
    const float m = fmaxf(1.0f - rt.R, 1e-12f);
    x = rt.T / m;
    const float g_x = x >= 0.0f && x <= 1.0f ? g_w : 0.0f;
    g_t = g_x / m;
    g_r = -max_ct(1.0f - rt.R, 1e-12f, -(g_x * x / m));
  } else {
    x = kd.ph == REFLECT_W ? rt.R : absorbing ? rt.T : 1.0f - rt.R;
    const float g_x = x >= 0.0f && x <= 1.0f ? g_w : 0.0f;
    if (kd.ph == REFLECT_W)
      g_r = g_x;
    else if (absorbing)
      g_t = g_x;
    else
      g_r = -g_x;
  }
  imod = fminf(fmaxf(x, 0.0f), 1.0f);
  return true;
}

// The cotangents sc of a row's stack's inputs (kCoat), added on: cos_i =
// |d . nw| into the direction (g_d) and the normal (g_nw); a coated row's
// media (media_backward, its n1 and n2: ph[0:2], or a dispersive row's wc);
// a metal's ambient ph[2] and its (n, k), ph[0:2], or through a dispersive
// metal's knots the wavelength; the wavelength (wc->wl, where the ray has
// one: an unset wavelength is the constant d line); and the layers'
// thicknesses (tc, in the coat columns' order).
template <bool kDispersion>
__device__ __forceinline__ void stack_ct_backward(const RowKinds& kd, const StackIn& a, V3 d,
                                                  V3 nw, uint32_t bits, float wl,
                                                  const float* side, const StackCt& sc, V3& g_d,
                                                  V3& g_nw, float* tg, WaveCt* wc, float* tc) {
  const float dn = dot3(d, nw);
  const float g_dn = sc.cos_i * (dn < 0.0f ? -1.0f : (dn > 0.0f ? 1.0f : 0.0f));
  g_d = fma3(g_d, g_dn, nw);
  g_nw = fma3(g_nw, g_dn, d);
  float g_lam = sc.lam;
  if (a.metal) {
    tg[kGPh + 2] += sc.n_in;
    if (kd.coat & kCoatMetalNk) {
      float n, k, sn, sk;
      metal_nk(side, a.lam, n, k, &sn, &sk);
      g_lam += sc.n_out * sn + sc.k_out * sk;
    } else {
      tg[kGPh] += sc.n_out;
      tg[kGPh + 1] += sc.k_out;
    }
  } else {
    media_backward<kDispersion, true>(kd.dispm, bits & kFromIn, sc.n_in, sc.n_out, tg, wc);
  }
  if (wl > 0.0f) wc->wl += g_lam;
  for (int j = 0; j < a.n; ++j) tc[j] += sc.d[j];
}

// Adjoint of a stack's weight (kCoat): g_r, g_t, the cotangents of the
// stack's mean R and T (stack_weight), through the stack into its inputs
// (stack_ct_backward).
template <bool kDispersion>
__device__ __forceinline__ void stack_weight_backward(const RowKinds& kd, const StackIn& a, V3 d,
                                                      V3 nw, uint32_t bits, float wl,
                                                      const float* side, float g_r, float g_t,
                                                      V3& g_d, V3& g_nw, float* tg, WaveCt* wc,
                                                      float* tc) {
  StackCt sc = {};
  stack_rt_unpolarized_ct(a, g_r, g_t, sc);
  stack_ct_backward<kDispersion>(kd, a, d, nw, bits, wl, side, sc, g_d, g_nw, tg, wc, tc);
}

// Adjoint of dispersive_iors on a dispersive row at the ray's wavelength
// wl, past its ph columns (media_backward): wc's cotangents of the two media
// indices add into the row's 12 disp columns (td, zeroed by the caller);
// returns the wavelength's cotangent.  Like autograd of the plain version:
// the clamp of lambda^2 and of a Sellmeier n^2 pass the cotangent at and
// above their bound, a Sellmeier denominator held off zero passes none.
__device__ __forceinline__ float disp_backward(const float* r, int dispm, float wl,
                                               const WaveCt& wc, float* td) {
  const bool set = wl > 0.0f;
  const float l2 = disp_l2(wl);
  float g_l2 = 0.0f;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int model = disp_model(dispm, side);
    const float g_n = side == 0 ? wc.n_in : wc.n_out;
    const float* c = r + kDisp + 6 * side;
    float* gc = td + 6 * side;
    if (model == DISP_SELLMEIER) {
      // n = sqrt(max(n2, 1e-6)), n2 = 1 + sum_i B_i l2 / den_i
      float n2 = 1.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) n2 = n2 + c[i] * l2 / sellmeier_den(l2, c[3 + i]);
      const float n = sqrtf(fmaxf(n2, 1e-6f));
      const float g_n2 = n2 >= 1e-6f ? g_n / (2.0f * n) : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float raw = l2 - c[3 + i];
        const float den = sellmeier_den(l2, c[3 + i]);
        const float num = c[i] * l2;
        gc[i] += g_n2 * l2 / den;
        g_l2 += g_n2 * c[i] / den;
        if (!(fabsf(raw) < 1e-9f)) {
          const float g_den = -(g_n2 * (num / den) / den);
          g_l2 += g_den;
          gc[3 + i] -= g_den;
        }
      }
    } else if (model == DISP_CAUCHY) {
      // n = nd + B (1 / l2 - 1 / l2_d)
        const float inv = 1.0f / l2;
        gc[0] += g_n * (inv - kInvDLine2);
        g_l2 -= g_n * c[0] * inv * inv;
    }
  }
  // l2 = max(wl^2, 1e-6) where wl > 0, else the d line's
  return set && wl * wl >= 1e-6f ? 2.0f * wl * g_l2 : 0.0f;
}

// Adjoint of a PHASE_GRID row's physics (core/physics.py::phase_grid_dir)
// at surface-frame hit hs: g_nd, the cotangent of the new direction, adds
// the cotangents of the incoming direction d (g_d), of the hit's x and y
// (g_hs), and of the row's Rw and ph[0:6] (tg); the four corner cotangents
// are added into gmaps (the maps' cotangent, laid out as pl.maps; null: not
// wanted).  The sides (from_in), the evanescence and the clips come from the
// row's bits; the cell is recomputed from the re-derived hit.  With
// kDispersion the wavelength's cotangent (its kick, and a dispersive row's
// media) goes to wc.
template <bool kDispersion = false, bool kOpl = false>
__device__ __forceinline__ void phase_grid_backward(const float* r, const RowKinds& kd,
                                                    const Plates& pl, float* gmaps, V3 d, V3 hs,
                                                    uint32_t bits, V3 g_nd, V3& g_d, V3& g_hs,
                                                    float* tg, WaveCt* wc = nullptr,
                                                    float g_n2_medium = 0.0f) {
  const float* Rw = r + kRw;
  // ---- the forward's values ----
  const bool from_in = bits & kFromIn, ok = bits & kPgOk;
  float n1, n2;
  media_iors<kDispersion>(r, from_in, kd.dispm, pl.wl, n1, n2);
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
  float g_n2 = -(g_inv * inv * inv) + 2.0f * n2 * g_n2sq;
  // kOpl: n2 is also the medium after the row
  if constexpr (kOpl) g_n2 += g_n2_medium;
  // ---- tx = n1 dl.x + kick gx, ty = n1 dl.y + kick gy ----
  const float g_n1 = g_tx * dl.x + g_ty * dl.y;
  g_dl.x += g_tx * n1;
  g_dl.y += g_ty * n1;
  const float g_kick = g_tx * gx + g_ty * gy;
  const float g_gx = g_tx * kick, g_gy = g_ty * kick;
  // ---- kick = order lam_mm, lam_mm = (wl > 0 ? wl : lam0) 1e-3 ----
  tg[kGPh + 2] += g_kick * lam_mm;
  if (use_lam0) tg[kGPh + 3] += g_kick * order * 1e-3f;
  if constexpr (kDispersion) {
    if (!use_lam0) wc->wl += g_kick * order * 1e-3f;
  }
  // ---- gx = P su, gy = Q sv, the bilinear patch ----
  const float g_P = g_gx * su, g_Q = g_gy * sv;
  const float g_su = g_gx * P, g_sv = g_gy * Q;
  const float g_fv = g_P * ((c.g11 - c.g10) - (c.g01 - c.g00));
  const float g_fu = g_Q * ((c.g11 - c.g01) - (c.g10 - c.g00));
  if (gmaps != nullptr) {
    const Corners gc = {-g_P * (1.0f - pt.fv) - g_Q * (1.0f - pt.fu),
                        g_P * (1.0f - pt.fv) - g_Q * pt.fu,
                        -g_P * pt.fv + g_Q * (1.0f - pt.fu), g_P * pt.fv + g_Q * pt.fu};
    scatter_corners(gmaps + (pt.map - pl.maps), pt.h * pt.w, pt.cells, gc);
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
  media_backward<kDispersion>(kd.dispm, from_in, g_n1, g_n2, tg, wc);
  // ---- dl = d @ Rw ----
  g_d = fma3(g_d, 1.0f, rot_t(g_dl, Rw));
  const float dv[3] = {d.x, d.y, d.z}, gdl[3] = {g_dl.x, g_dl.y, g_dl.z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += dv[i] * gdl[j];
}

// Adjoint of diffractive_physics (kDiff) at surface-frame hit hs: g_nd, the
// cotangent of the new direction, adds those of the incoming direction d
// (g_d), of the hit's x and y (g_hs), of the row's Rw and ph[0:6] (tg), of a
// DOE row's media (media_backward) and coefficients (tf[0:8]), and of the
// ray's wavelength (wc->wl).  g_eta is the cotangent of a DOE row's
// efficiency (0 where it has none or the order is evanescent), g_n2_medium
// that of the medium after a DOE row (the path length's).  The side and the
// evanescence come from the row's bits.
template <bool kDispersion>
__device__ __forceinline__ void diffractive_backward(const float* r, const RowKinds& kd,
                                                     const Plates& pl, V3 d, V3 hs,
                                                     uint32_t bits, V3 g_nd, float g_n2_medium,
                                                     float g_eta, V3& g_d, V3& g_hs, float* tg,
                                                     WaveCt* wc, float* tf) {
  const float* Rw = r + kRw;
  const V3 dv = rot(d, Rw);
  const Loc dl = {dv.x, dv.y, dv.z};
  const V3 gv = rot(g_nd, Rw);  // the cotangent of the surface-frame direction
  const Loc g_ol = {gv.x, gv.y, gv.z};
  Loc ol, g_dl = {0.0f, 0.0f, 0.0f};
  bool ok;
  if (kd.ph == LINEAR) {
    ol = linear_local(dl, hs.x, hs.y, r + kPh + 2);
    linear_local_ct(dl, hs.x, hs.y, r + kPh + 2, g_ol, g_dl, g_hs.x, g_hs.y, tg + kGPh + 2);
  } else if (kd.ph == MLA) {
    ol = mla_local(dl, hs.x, hs.y, r[kPh], r[kPh + 1]);
    mla_local_ct(dl, hs.x, hs.y, r[kPh], r[kPh + 1], g_ol, g_dl, g_hs.x, g_hs.y, tg[kGPh],
                 tg[kGPh + 1]);
  } else if (kd.ph == GRATING) {
    ol = grating_local(dl, r[kPh + 2], r[kPh + 3], r[kPh + 4], pl.wl, ok);
    grating_local_ct(dl, r[kPh + 2], r[kPh + 3], r[kPh + 4], pl.wl, g_ol, g_dl, tg[kGPh + 2],
                     tg[kGPh + 3], wc->wl);
  } else {
    const bool from_in = bits & kFromIn;
    float n1, n2;
    media_iors<kDispersion>(r, from_in, kd.dispm, pl.wl, n1, n2);
    const int n_terms = doe_of(kd.coat) & kDoeTermsMask;
    ol = doe_local(dl, hs.x, hs.y, r + kFf, n_terms, r[kPh + 2], r[kPh + 3], pl.wl, n1, n2, ok);
    DoeCt dc = {};
    doe_local_ct(dl, hs.x, hs.y, r + kFf, n_terms, r[kPh + 2], r[kPh + 3], pl.wl, n1, n2, g_ol,
                 g_n2_medium, g_dl, g_hs.x, g_hs.y, dc);
    if (doe_of(kd.coat) & kDoeEfficiency)
      kinoform_eff_ct(r[kPh + 2], r[kPh + 3], pl.wl, g_eta, dc);
    tg[kGPh + 2] += dc.order;
    tg[kGPh + 3] += dc.lam0;
    wc->wl += dc.wl;
    media_backward<kDispersion>(kd.dispm, from_in, dc.n1, dc.n2, tg, wc);
    for (int k = 0; k < n_terms; ++k) tf[k] += dc.c[k];
  }
  // ---- nd = ol @ Rw.T, dl = d @ Rw ----
  const float gnd[3] = {g_nd.x, g_nd.y, g_nd.z}, olv[3] = {ol.x, ol.y, ol.z};
  const float dvv[3] = {d.x, d.y, d.z}, gdl[3] = {g_dl.x, g_dl.y, g_dl.z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tg[kGRw + 3 * i + j] += gnd[i] * olv[j] + dvv[i] * gdl[j];
  g_d = fma3(g_d, 1.0f, rot_t(V3{g_dl.x, g_dl.y, g_dl.z}, Rw));
}

// ---- Adjoints of an even asphere (kExt) ----
//
// Like autograd of the plain version (and jax.vjp of the TPU kernel's
// chain), they differentiate the 4 unrolled Halley steps, the clamps
// included, not the implicit function of the converged root: each step's
// input is recomputed from the root it started at, then the steps are
// reversed.  The cotangents of the asphere's c, (1 + k) c^2 and a4..a10 add
// into AsphCt.

struct AsphCt {
  float c, kc2, a[4];
};

// Adjoint of one asph_step at ray parameter t: `lam`, the cotangent of the
// step's result, adds the cotangents of o, d and of the asphere's terms
// into g_o, g_d and ac; returns the cotangent of t.  Each line reverses the
// line of asph_g or asph_step that it names.
__device__ __forceinline__ float asph_step_backward(const Asph& s, V3 o, V3 d, float t,
                                                    float lam, V3& g_o, V3& g_d, AsphCt& ac) {
  // ---- the step's forward values ----
  const float x = o.x + t * d.x, y = o.y + t * d.y;
  const float r2 = x * x + y * y;
  const float raw = 1.0f - s.kc2 * r2;
  const float sq = sqrtf(fmaxf(raw, 0.0f) + 1e-24f);
  const float den1 = 1.0f + sq;
  const float r4 = r2 * r2, r6 = r4 * r2, r8 = r6 * r2;
  const float W = 2.0f * sq * (den1 * den1);
  const float inv = 1.0f / W;
  const float dsq = -s.kc2 * (0.5f / sq);
  const float P = 1.0f / sq + 2.0f / den1;
  const float dinv = -P * inv * dsq;
  const AsphG G = asph_g(s, o, d, t);
  const float dsag = s.c / den1 + s.c * r2 * s.kc2 * inv + 2.0f * s.a[0] * r2 +
                     3.0f * s.a[1] * r4 + 4.0f * s.a[2] * r6 + 5.0f * s.a[3] * r8;
  const float d2sag = 2.0f * s.c * s.kc2 * inv + s.c * r2 * s.kc2 * dinv + 2.0f * s.a[0] +
                      6.0f * s.a[1] * r2 + 12.0f * s.a[2] * r4 + 20.0f * s.a[3] * r6;
  const float dr2 = 2.0f * (x * d.x + y * d.y);
  const float d2r2 = 2.0f * (d.x * d.x + d.y * d.y);
  const float denom = 2.0f * G.dg * G.dg - G.g * G.d2g;
  const bool clamped = fabsf(denom) < 1e-12f;
  const float den_c = clamped ? 1e-12f : denom;
  const float num = 2.0f * G.g * G.dg;
  // ---- t' = t - num / den_c, den_c = clamp(2 G'^2 - G G'') ----
  const float g_num = -lam / den_c;
  const float g_den = clamped ? 0.0f : lam * (num / den_c) / den_c;
  float g_g = 2.0f * G.dg * g_num - G.d2g * g_den;
  const float g_dg = 2.0f * G.g * g_num + 4.0f * G.dg * g_den;
  const float g_u = G.g * g_den;  // the cotangent of -G''
  // ---- G'' = -(S'' dr2^2 + S' d2r2), G' = d.z - S' dr2 ----
  const float g_d2sag = g_u * dr2 * dr2;
  const float g_dr2 = g_u * 2.0f * d2sag * dr2 - g_dg * dsag;
  const float g_dsag = g_u * d2r2 - g_dg * dr2;
  const float g_d2r2 = g_u * dsag;
  g_d.z += g_dg;
  // ---- d2r2 = 2 (dx^2 + dy^2), dr2 = 2 (x dx + y dy) ----
  g_d.x += 4.0f * d.x * g_d2r2 + 2.0f * x * g_dr2;
  g_d.y += 4.0f * d.y * g_d2r2 + 2.0f * y * g_dr2;
  float g_x = 2.0f * d.x * g_dr2, g_y = 2.0f * d.y * g_dr2;
  // ---- S'' = 2 c kc2 inv + c r2 kc2 dinv + 2 a4 + 6 a6 r2 + ... ----
  float g_inv = g_d2sag * 2.0f * s.c * s.kc2;
  const float g_dinv = g_d2sag * s.c * r2 * s.kc2;
  ac.c += g_d2sag * (2.0f * s.kc2 * inv + r2 * s.kc2 * dinv);
  ac.kc2 += g_d2sag * (2.0f * s.c * inv + s.c * r2 * dinv);
  float g_r2 = g_d2sag * (s.c * s.kc2 * dinv + 6.0f * s.a[1] + 24.0f * s.a[2] * r2 +
                          60.0f * s.a[3] * r4);
  ac.a[0] += 2.0f * g_d2sag;
  ac.a[1] += 6.0f * r2 * g_d2sag;
  ac.a[2] += 12.0f * r4 * g_d2sag;
  ac.a[3] += 20.0f * r6 * g_d2sag;
  // ---- dinv = -P inv dsq, P = 1 / sq + 2 / den1 ----
  const float g_P = -g_dinv * inv * dsq;
  g_inv -= g_dinv * P * dsq;
  const float g_dsq = -g_dinv * P * inv;
  float g_sq = -g_P / (sq * sq) - 2.0f * g_P / (den1 * den1);
  // ---- dsq = -kc2 (0.5 / sq) ----
  ac.kc2 -= g_dsq * 0.5f / sq;
  g_sq += g_dsq * s.kc2 * 0.5f / (sq * sq);
  // ---- S' = c / den1 + c r2 kc2 inv + 2 a4 r2 + 3 a6 r4 + ... ----
  ac.c += g_dsag * (1.0f / den1 + r2 * s.kc2 * inv);
  g_sq -= g_dsag * s.c / (den1 * den1);
  g_r2 += g_dsag * (s.c * s.kc2 * inv + 2.0f * s.a[0] + 6.0f * s.a[1] * r2 +
                    12.0f * s.a[2] * r4 + 20.0f * s.a[3] * r6);
  ac.kc2 += g_dsag * s.c * r2 * inv;
  g_inv += g_dsag * s.c * r2 * s.kc2;
  ac.a[0] += 2.0f * r2 * g_dsag;
  ac.a[1] += 3.0f * r4 * g_dsag;
  ac.a[2] += 4.0f * r6 * g_dsag;
  ac.a[3] += 5.0f * r8 * g_dsag;
  // ---- inv = 1 / W, W = 2 sq den1^2 ----
  const float g_W = -g_inv * inv * inv;
  g_sq += g_W * (2.0f * den1 * den1 + 4.0f * sq * den1);
  // ---- G = z - S, S = c r2 / den1 + a4 r4 + a6 r6 + a8 r8 + a10 r10 ----
  const float g_sag = -g_g;
  ac.c += g_sag * r2 / den1;
  g_r2 += g_sag * (s.c / den1 + 2.0f * s.a[0] * r2 + 3.0f * s.a[1] * r4 + 4.0f * s.a[2] * r6 +
                   5.0f * s.a[3] * r8);
  g_sq -= g_sag * s.c * r2 / (den1 * den1);
  ac.a[0] += g_sag * r4;
  ac.a[1] += g_sag * r6;
  ac.a[2] += g_sag * r8;
  ac.a[3] += g_sag * r8 * r2;
  // ---- sq = sqrt(max(1 - kc2 r2, 0) + 1e-24) (torch.clamp: the bound
  // itself passes) ----
  const float g_raw = raw >= 0.0f ? g_sq / (2.0f * sq) : 0.0f;
  ac.kc2 -= g_raw * r2;
  g_r2 -= g_raw * s.kc2;
  // ---- r2 = x^2 + y^2; x, y, z = o + t d ----
  g_x += 2.0f * x * g_r2;
  g_y += 2.0f * y * g_r2;
  g_o.x += g_x;
  g_o.y += g_y;
  g_o.z += g_g;
  g_d.x += g_x * t;
  g_d.y += g_y * t;
  g_d.z += g_g * t;
  return lam + g_x * d.x + g_y * d.y + g_g * d.z;
}

// Adjoint of asph_refine from the base-conic root t0: `lam`, the cotangent
// of the refined root, -> the cotangent of t0, adding those of o, d and the
// asphere's terms.  Step i's input is recomputed from t0 by i steps, as the
// forward computed it (6 steps more than keeping the 4 inputs, in exchange
// for one copy of the step's adjoint in the code and no array of them).
__device__ __forceinline__ float asph_refine_backward(const Asph& s, V3 o, V3 d, float t0,
                                                      float lam, V3& g_o, V3& g_d, AsphCt& ac) {
#pragma unroll 1
  for (int i = kAsphSteps - 1; i >= 0; --i) {
    float t = t0;
#pragma unroll 1
    for (int j = 0; j < i; ++j) t = asph_step(s, o, d, t);
    lam = asph_step_backward(s, o, d, t, lam, g_o, g_d, ac);
  }
  return lam;
}

// Adjoint of asph_normal at surface-frame hit h: g_n, the normal's
// cotangent, adds the cotangents of h.x, h.y (g_h) and of the asphere's
// terms (ac).
__device__ __forceinline__ void asph_normal_backward(const Asph& s, V3 h, V3 g_n, V3& g_h,
                                                     AsphCt& ac) {
  const float x = h.x, y = h.y;
  const float r2 = x * x + y * y;
  const float raw = 1.0f - s.kc2 * r2;
  const float sq = sqrtf(fmaxf(raw, 0.0f) + 1e-24f);
  const float den1 = 1.0f + sq;
  const float r4 = r2 * r2, r6 = r4 * r2, r8 = r6 * r2;
  const float W = 2.0f * sq * (den1 * den1);
  const float N = s.c * r2 * s.kc2;
  const float dsag = asph_slope(s, r2);
  const float gx = -2.0f * dsag * x, gy = -2.0f * dsag * y;
  const float rS = sqrtf(gx * gx + gy * gy + 1.0f + 1e-24f);
  const float inv = 1.0f / rS;
  // ---- n = (gx, gy, 1) inv, inv = 1 / sqrt(gx^2 + gy^2 + 1 + 1e-24) ----
  const float g_inv = g_n.x * gx + g_n.y * gy + g_n.z;
  const float g_S = -g_inv * inv * inv / (2.0f * rS);
  const float g_gx = g_n.x * inv + 2.0f * gx * g_S;
  const float g_gy = g_n.y * inv + 2.0f * gy * g_S;
  // ---- gx = -2 S' x, gy = -2 S' y ----
  const float g_dsag = -2.0f * x * g_gx - 2.0f * y * g_gy;
  float g_x = -2.0f * dsag * g_gx, g_y = -2.0f * dsag * g_gy;
  // ---- S' = c / den1 + N / W + 2 a4 r2 + 3 a6 r4 + ..., N = c r2 kc2,
  // W = 2 sq den1^2 ----
  ac.c += g_dsag * (1.0f / den1 + r2 * s.kc2 / W);
  float g_r2 = g_dsag * (s.c * s.kc2 / W + 2.0f * s.a[0] + 6.0f * s.a[1] * r2 +
                         12.0f * s.a[2] * r4 + 20.0f * s.a[3] * r6);
  ac.kc2 += g_dsag * s.c * r2 / W;
  const float g_W = -g_dsag * (N / W) / W;
  const float g_sq = g_W * (2.0f * den1 * den1 + 4.0f * sq * den1) - g_dsag * s.c / (den1 * den1);
  ac.a[0] += 2.0f * r2 * g_dsag;
  ac.a[1] += 3.0f * r4 * g_dsag;
  ac.a[2] += 4.0f * r6 * g_dsag;
  ac.a[3] += 5.0f * r8 * g_dsag;
  // ---- sq = sqrt(max(1 - kc2 r2, 0) + 1e-24) ----
  const float g_raw = raw >= 0.0f ? g_sq / (2.0f * sq) : 0.0f;
  ac.kc2 -= g_raw * r2;
  g_r2 -= g_raw * s.kc2;
  g_x += 2.0f * x * g_r2;
  g_y += 2.0f * y * g_r2;
  g_h.x += g_x;
  g_h.y += g_y;
}

// Adjoint of one row.  (p, d, inten) is the row's saved input state and
// (gp, gd, gi) the cotangent of its output state, replaced by the cotangent
// of its input state; tg[grad_cols<kPlates, kExt>()] receives the row's
// table cotangent.  gm is the [S, B, 7] moment cotangent and gg the grid's;
// a PHASE_GRID row (kPlates only) reads its map from pl and adds its corner
// cotangents into gmaps (null: not wanted).  An asphere row (kExt only)
// refines its root and takes its normal as the forward did, and reverses
// both (asph_refine_backward, asph_normal_backward).  A dispersive row
// (kDispersion only) refracts at the indices of the ray's wavelength, whose
// cotangents go to wc (disp_backward carries them on), as does the
// wavelength's own where a PHASE_GRID row reads it.  With kOpl (which has
// kDispersion) `oc` carries the optical path length's adjoint: the adjoint
// of opl += n_cur t joins g_opl n_cur to t's cotangent (through the
// intersection into p, d and the table) and g_opl t to n_cur's, and a
// refracting row hands the cotangent of the medium after it to the index
// medium_after took (n2, or n1 under TIR: ph[0:2] by side, or the disp
// columns and the wavelength through wc).
// With kFresnel (which has kOpl) the Fresnel kinds: FRESNEL through its
// saved branch (kReflect) as REFLECT or SNELL, FRESNEL_W as SNELL and
// REFLECT_W as REFLECT, the weights' cotangents through R
// (fresnel_weight_backward), and an inactive REFLECT_W row stops the
// intensity's cotangent (the forward zeroed the intensity there).
// With kCoat (which has kFresnel) a coated row's weight goes through its
// stack (`side`, its side-buffer row) and a metal REFLECT row's through its
// metal's (stack_weight_backward); the thicknesses' cotangents add into
// tc[kMaxCoatLayers].  With kDiff (which has kCoat) the diffractive kinds
// (diffractive_backward); a DOE row's coefficients' cotangents add into
// tf[kMaxDoeTerms].  With kFuzzy (which has kDiff) a row with a fuzzy
// program `prog` (null: none) weighs I' = I (imod w) with w the program's
// value at hs: w's cotangent g I imod goes through the program's
// forward-mode partials into the hit's cotangent, and imod's and I's take
// w as a factor.  With kFreeform (which has kFuzzy) a freeform row (`ffp`,
// its exponent pairs; null: none) refines its root and takes its normal as
// the forward did and reverses both (ff_refine_backward,
// ff_normal_backward); its coefficients' cotangents add into
// tf[kMaxFfTerms] (a DOE row's into its first kMaxDoeTerms).  With kField
// (which has kCoat: K2's is built on kFreeform, K6's on kCoat alone) `fc`
// carries the row's field (FieldCt): the
// transport's adjoint, the sensor weight w |E|^2 and a weighted Fresnel
// row's polarized reflectance, and fc->g becomes the cotangent of the
// incoming field; a JONES row passes the direction's cotangent through.
template <bool kPlates, bool kExt = false, bool kDispersion = false, bool kOpl = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false, bool kField = false>
__device__ __forceinline__ void row_backward(const float* r, const RowKinds& kd, V3 p, V3 d,
                                             float inten, uint32_t bits, int rid,
                                             const float* gm, int n_bundles, const GridCt& gg,
                                             const Plates& pl, float* gmaps, V3& gp, V3& gd,
                                             float& gi, float* tg, WaveCt* wc = nullptr,
                                             OplCt* oc = nullptr, const float* side = nullptr,
                                             float* tc = nullptr, float* tf = nullptr,
                                             const int32_t* prog = nullptr,
                                             const int32_t* ffp = nullptr,
                                             FieldCt* fc = nullptr) {
  static_assert(kDispersion || !kOpl, "the path length runs with dispersion");
  static_assert(kOpl || !kFresnel, "the Fresnel kinds run with the path length");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(kCoat || !kField, "the field runs with the coatings");
  if (!(bits & kActive)) {  // where(active, new, old) passes through
    if (kFresnel && kd.ph == REFLECT_W) gi = 0.0f;
    return;
  }
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
  const bool asph = kExt && kd.asph;
  const Asph as = asph_of(q, r + kAsph);
  AsphCt ac = {};
  // kFreeform: a freeform row, its surface and its terms' cotangents
  const bool ffrow = kFreeform && ffp != nullptr;
  const Freeform fs = kFreeform ? freeform_of(q, r + kAsph, r + kFf, ffp) : Freeform{};
  FfCt fct = {};
  // an asphere's or a freeform's chosen root, refined as the forward refined
  // it (both roots refine to the same t on a tie)
  const float t = ffrow  ? ff_steps(fs, o.x, o.y, o.z, ds.x, ds.y, ds.z, r1 ? t1 : t2)
                  : asph ? asph_steps(as, o, ds, r1 ? t1 : t2)
                         : (r1 ? t1 : t2);
  const V3 hs = fma3(o, t, ds);

  // kField: the field's s/p bases read the normal of a DOE or PHASE_GRID row
  const bool need_normal = uses_normal<kFresnel>(kd.ph) ||
                           (kField && (kd.ph == DOE || (kPlates && kd.ph == PHASE_GRID)));
  const bool degen = bits & kDegen;
  V3 nw = {0.0f, 0.0f, 1.0f}, nl = {0.0f, 0.0f, 1.0f}, gv = {0.0f, 0.0f, 0.0f};
  float root_g2 = 1.0f, den = 1.0f, inv = 0.0f;
  if (need_normal) {
    if (kd.plane) {
      nw = {Rw[2], Rw[5], Rw[8]};
    } else if (asph) {
      nl = asph_normal(as, hs);
      nw = rot_t(nl, Rw);
    } else if (ffrow) {
      ff_normal(fs, hs.x, hs.y, nl.x, nl.y, nl.z);
      nw = rot_t(nl, Rw);
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

  // kFuzzy: the program's value w and partials at hs; the cotangent of the
  // row's own factor imod is then g I w (g I without a program)
  FuzzyDual fw = {1.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kFuzzy) {
    if (prog != nullptr) fw = fuzzy_eval<true>(prog, hs.x, hs.y, hs.z);
  }

  // ---- masked update: p' = p + t d, d' = nd, I' = I * imod ----
  float imod = kd.ph == BLOCK || (kd.ph == APERTURE && !(bits & kMod)) ||
                       (kPlates && kd.ph == PHASE_GRID && !(bits & kPgOk))
                   ? 0.0f
                   : 1.0f;
  // kDiff: an evanescent GRATING or DOE order's 0, a DOE row's efficiency
  // and its cotangent g_eta
  float g_eta = 0.0f;
  if constexpr (kDiff) {
    if ((kd.ph == GRATING || kd.ph == DOE) && !(bits & kPgOk)) imod = 0.0f;
    if (kd.ph == DOE && (doe_of(kd.coat) & kDoeEfficiency) && (bits & kPgOk)) {
      imod = kinoform_eff(r[kPh + 2], r[kPh + 3], pl.wl);
      g_eta = kFuzzy ? gi * inten * fw.w : gi * inten;
    }
  }
  // kFresnel: FRESNEL_W's clip(1 - R, 0, 1) and REFLECT_W's clip(R, 0, 1)
  // away from TIR, and R's cotangent g_R
  const bool weighted = kFresnel && (kd.ph == FRESNEL_W || kd.ph == REFLECT_W) &&
                        !(bits & kTir) && !(kCoat && (kd.coat & kCoatCountMask) != 0);
  FresnelFwd ff = {};
  float g_R = 0.0f;
  // kField: the cotangent of the incoming field from the weights (the
  // sensor's |E|^2, a weighted row's polarized R), the polarized R's
  // forward values and basis
  Fld g_ein = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  PolR pr = {};
  SpBasis pb = {};
  // kCoat: a stack's weight, its inputs and the cotangents of its R and T
  // (kField: the polarized ones, with their basis and weighing, from the
  // row's stack evaluated once, fst, which the transport reads too)
  bool stacked = false;
  StackIn sa = {};
  float g_sr = 0.0f, g_st = 0.0f;
  SpBasis sb = {};
  PolRT sw = {};
  FieldStack fst;
  if constexpr (kField) {
    fst = field_stack<kDispersion>(r, kd, d, nw, pl.wl, side);
    stacked = stack_weight<true>(r, kd, pl, d, nw, bits, side,
                                 kFuzzy ? gi * inten * fw.w : gi * inten, sa, imod, g_sr, g_st,
                                 &fc->e, &fst, &sb, &sw);
  } else if constexpr (kCoat) {
    stacked = stack_weight(r, kd, pl, d, nw, bits, side,
                           kFuzzy ? gi * inten * fw.w : gi * inten, sa, imod, g_sr, g_st);
  }
  if constexpr (kFresnel) {
    if (weighted) {
      ff = fresnel_forward<kDispersion>(r, kd, pl, d, nw, bits);
      float R;
      if constexpr (kField) {
        pb = sp_basis(F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z});
        pr = polarized_r(fc->e, pb, ff.cos_i, ff.cos_t, ff.n1, ff.n2);
        R = pr.R;
      } else {
        R = fresnel_R(ff.cos_i, ff.cos_t, ff.n1, ff.n2);
      }
      const float x = kd.ph == FRESNEL_W ? 1.0f - R : R;
      imod = fminf(fmaxf(x, 0.0f), 1.0f);
      const float g_x =
          x >= 0.0f && x <= 1.0f ? (kFuzzy ? gi * inten * fw.w : gi * inten) : 0.0f;
      g_R = kd.ph == FRESNEL_W ? -g_x : g_x;
    }
  }
  // kField: the transport's adjoint (field.cuh::field_transport_ct) of the
  // field after the row, with the row's total factor imod w
  FieldRowCt fld_ct = {};
  Fld g_etr = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if constexpr (kField) {
    g_etr = field_transport_ct(
        field_row<kDispersion>(r, kd, d, fc->nd, nw, kFuzzy ? imod * fw.w : imod, pl.wl, fst),
        fc->e, fc->g, fld_ct);
    // the factor's cotangent: a DOE row's efficiency's share (its own imod)
    if constexpr (kDiff) {
      if (kd.ph == DOE && (doe_of(kd.coat) & kDoeEfficiency) && (bits & kPgOk))
        g_eta += kFuzzy ? fld_ct.imod * fw.w : fld_ct.imod;
    }
    // a coated or metal row's stack, here, where its values die: the
    // polarized weight's cotangent into the field, the basis (so d and nw,
    // through fld_ct) and the stack's Rs, Rp, Ts, Tp; then, with the
    // transport's amplitudes', one reverse sweep a polarization into the
    // stack's inputs
    if (fst.kind != kStackNone) {
      float g_rs = 0.0f, g_rp = 0.0f, g_ts = 0.0f, g_tp = 0.0f;
      if (stacked) {
        F3 g_s = {0.0f, 0.0f, 0.0f}, g_p = {0.0f, 0.0f, 0.0f};
        polarized_rt_ct(fc->e, sb, sw, g_sr, g_st, g_ein, g_s, g_p, g_rs, g_rp, g_ts, g_tp);
        sp_basis_ct(sb, F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z}, g_s, g_p, fld_ct.d, fld_ct.nw);
      }
      StackCt sc = {};
      stack_field_ct(fst.a, false, g_rs, g_ts, fld_ct.ts, fld_ct.rs, sc);
      stack_field_ct(fst.a, true, g_rp, g_tp, fld_ct.tp, fld_ct.rp, sc);
      V3 gd3 = {0.0f, 0.0f, 0.0f}, gn3 = {0.0f, 0.0f, 0.0f};
      stack_ct_backward<kDispersion>(kd, fst.a, d, nw, bits, pl.wl, side, sc, gd3, gn3, tg, wc,
                                     tc);
      fld_ct.d = fadd(fld_ct.d, F3{gd3.x, gd3.y, gd3.z});
      fld_ct.nw = fadd(fld_ct.nw, F3{gn3.x, gn3.y, gn3.z});
    }
  }
  float g_t = dot3(gp, d);
  V3 g_d = {t * gp.x, t * gp.y, t * gp.z};
  V3 g_nd = gd;
  if constexpr (kField) {
    g_d = {g_d.x + fld_ct.d.x, g_d.y + fld_ct.d.y, g_d.z + fld_ct.d.z};
    g_nd = {g_nd.x + fld_ct.nd.x, g_nd.y + fld_ct.nd.y, g_nd.z + fld_ct.nd.z};
  }
  // ---- opl += n_cur t; n_cur' = medium_after (a refracting row), else n_cur ----
  float g_medium = 0.0f;  // the cotangent of the medium after a refracting row
  if constexpr (kOpl) {
    const bool refracts = kd.ph == SNELL || (kPlates && kd.ph == PHASE_GRID) ||
                          (kFresnel && (kd.ph == FRESNEL || kd.ph == FRESNEL_W)) ||
                          (kDiff && kd.ph == DOE);
    g_medium = refracts ? oc->g_n : 0.0f;
    g_t += oc->g_opl * oc->n_cur;
    oc->g_n = (refracts ? 0.0f : oc->g_n) + oc->g_opl * t;
  }
  float g_i = gi * (kFuzzy ? imod * fw.w : imod);
  V3 g_hs = {0.0f, 0.0f, 0.0f};
  if constexpr (kFuzzy) {
    // I' = I (imod w): w's cotangent g I imod, through w's partials into hs
    // (kField: and the field's share of the factor)
    const float g_w = kField ? gi * inten * imod + fld_ct.imod * imod : gi * inten * imod;
    g_hs = {g_w * fw.gx, g_w * fw.gy, g_w * fw.gz};
  }

  if constexpr (kField) {
    // ---- sensor moments and grid of w = I |E|^2: w's cotangent goes to I
    // (times |E|^2) and to the incoming field (times I) ----
    if (kd.sensor) {
      const float pw = fpower(fc->e);
      float g_w = 0.0f;
      if (rid >= 0 && rid < n_bundles) {
        const float* g = gm + (kd.slot * n_bundles + rid) * kMoments;
        const float w = inten * pw, x = hs.x, y = hs.y;
        g_w += g[0] + g[1] * x + g[2] * y + g[3] * x * x + g[4] * y * y + g[5] * x * y;
        g_hs.x += g[1] * w + 2.0f * g[3] * w * x + g[5] * w * y;
        g_hs.y += g[2] * w + 2.0f * g[4] * w * y + g[5] * w * x;
      }
      if (gg.g != nullptr)
        g_w += gg.g[static_cast<size_t>(kd.slot) * gg.h * gg.w +
                    grid_cell(hs.x, hs.y, gg.h, gg.w, gg.e)];
      g_i += g_w * pw;
      const float g_p = 2.0f * g_w * inten;
      g_ein.r = faxpy(g_ein.r, g_p, fc->e.r);
      g_ein.i = faxpy(g_ein.i, g_p, fc->e.i);
    }
  } else {
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
  }

  // ---- physics ----
  V3 g_nw = {0.0f, 0.0f, 0.0f};
  if constexpr (kField) g_nw = {fld_ct.nw.x, fld_ct.nw.y, fld_ct.nw.z};
  if (kPlates && kd.ph == PHASE_GRID) {
    phase_grid_backward<kDispersion, kOpl>(r, kd, pl, gmaps, d, hs, bits, g_nd, g_d, g_hs, tg,
                                           wc, g_medium);
  } else if (kd.ph == TRANSMIT || (kField && kd.ph == JONES)) {
    g_d = fma3(g_d, 1.0f, g_nd);
  } else if (kd.ph == APERTURE) {
    if (bits & kMod) g_d = fma3(g_d, 1.0f, g_nd);
  } else if (kd.ph == REFLECT || (kd.ph == SNELL && (bits & kTir)) ||
             (kFresnel && (kd.ph == REFLECT_W || (kd.ph == FRESNEL_W && (bits & kTir)) ||
                           (kd.ph == FRESNEL && (bits & kReflect))))) {
    // nd = d - 2 (d.n) n
    const float s = dot3(d, nw);
    const float g_s = -2.0f * dot3(g_nd, nw);
    g_d = fma3(g_d, 1.0f, g_nd);
    g_d = fma3(g_d, g_s, nw);
    g_nw = fma3(g_nw, -2.0f * s, g_nd);
    g_nw = fma3(g_nw, g_s, d);
    // under TIR (or a FRESNEL reflection) the ray stays in the medium of
    // incidence: n1
    if constexpr (kOpl) {
      if (kd.ph == SNELL || (kFresnel && (kd.ph == FRESNEL_W || kd.ph == FRESNEL)))
        media_backward<kDispersion>(kd.dispm, bits & kFromIn, g_medium, 0.0f, tg, wc);
    }
  } else if (kd.ph == SNELL || (kFresnel && (kd.ph == FRESNEL_W || kd.ph == FRESNEL))) {
    // nd = mu d + coef n, coef = (mu cos_i - cos_t) eff_sign
    const bool from_in = bits & kFromIn;
    const float dn = dot3(d, nw);
    const float eff_sign = from_in ? 1.0f : -1.0f;
    const float cos_i = fabsf(dn);
    float n1, n2;
    media_iors<kDispersion>(r, from_in, kd.dispm, pl.wl, n1, n2);
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
    float g_n2 = n2_small ? 0.0f : -(g_mu * mu / n2_safe);
    // kOpl: n2 itself (not n2_safe) is the medium after the row
    if constexpr (kOpl) g_n2 += g_medium;
    media_backward<kDispersion>(kd.dispm, from_in, g_n1, g_n2, tg, wc);
    g_d = fma3(g_d, g_dn, nw);
    g_nw = fma3(g_nw, g_dn, d);
  } else if (kDiff && (kd.ph == LINEAR || kd.ph == GRATING || kd.ph == MLA || kd.ph == DOE)) {
    diffractive_backward<kDispersion>(r, kd, pl, d, hs, bits, g_nd, g_medium, g_eta, g_d, g_hs,
                                      tg, wc, tf);
  }
  if constexpr (kField) {
    // the weighted row's polarized reflectance: into the field, the basis
    // (so d and nw) and (Rs, Rp)
    if (weighted) {
      F3 g_s = {0.0f, 0.0f, 0.0f}, g_p = {0.0f, 0.0f, 0.0f};
      float g_rs = 0.0f, g_rp = 0.0f;
      polarized_r_ct(fc->e, pb, pr, g_R, g_ein, g_s, g_p, g_rs, g_rp);
      F3 gd3 = {0.0f, 0.0f, 0.0f}, gn3 = {0.0f, 0.0f, 0.0f};
      sp_basis_ct(pb, F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z}, g_s, g_p, gd3, gn3);
      g_d = {g_d.x + gd3.x, g_d.y + gd3.y, g_d.z + gd3.z};
      g_nw = {g_nw.x + gn3.x, g_nw.y + gn3.y, g_nw.z + gn3.z};
      fresnel_weight_backward<kDispersion, true>(kd, ff, d, nw, bits, g_rs, g_d, g_nw, tg, wc,
                                                  g_rp);
    }
    // the transport's media, a JONES row's parameters, Rw columns and the
    // wavelength's share of its retardance
    if (field_fresnel_kind(kd.ph))
      media_backward<kDispersion, true>(kd.dispm, dot3(d, nw) < 0.0f, fld_ct.n1, fld_ct.n2, tg, wc);
    if (kd.ph == JONES) {
      tg[kGPh] += fld_ct.theta;
      tg[kGPh + 1] += fld_ct.a1;
      tg[kGPh + 2] += fld_ct.a2;
      float g_wl = 0.0f;
      jones_delta(kd.coat, r[kPh + 3], r[kPh + 4], pl.wl, fld_ct.delta, &tg[kGPh + 3],
                  &tg[kGPh + 4], &g_wl);
      wc->wl += g_wl;
      tg[kGRw] += fld_ct.xw.x;
      tg[kGRw + 3] += fld_ct.xw.y;
      tg[kGRw + 6] += fld_ct.xw.z;
      tg[kGRw + 1] += fld_ct.yw.x;
      tg[kGRw + 4] += fld_ct.yw.y;
      tg[kGRw + 7] += fld_ct.yw.z;
    }
    fc->g = {fadd(g_etr.r, g_ein.r), fadd(g_etr.i, g_ein.i)};
  } else if constexpr (kFresnel) {
    if (weighted) fresnel_weight_backward<kDispersion>(kd, ff, d, nw, bits, g_R, g_d, g_nw, tg, wc);
  }
  if constexpr (kCoat && !kField) {
    if (stacked)
      stack_weight_backward<kDispersion>(kd, sa, d, nw, bits, pl.wl, side, g_sr, g_st, g_d, g_nw,
                                         tg, wc, tc);
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
      if (asph) {
        asph_normal_backward(as, hs, g_nl, g_hs, ac);
      } else if (ffrow) {
        ff_normal_backward(fs, hs.x, hs.y, g_nl.x, g_nl.y, g_nl.z, g_hs.x, g_hs.y, fct, tf);
      } else if (!degen) {
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
    float g_t1 = r1 ? (r2 ? 0.5f * g_t : g_t) : 0.0f;
    float g_t2 = r2 ? (r1 ? 0.5f * g_t : g_t) : 0.0f;
    if (asph) {
      // through the Halley steps back to the base conic's roots t1, t2
      if (r1) g_t1 = asph_refine_backward(as, o, ds, t1, g_t1, g_o, g_ds, ac);
      if (r2) g_t2 = asph_refine_backward(as, o, ds, t2, g_t2, g_o, g_ds, ac);
    } else if (ffrow) {
      // through the Newton steps back to the base conic's roots; on the
      // linear path both roots are the same t, so one reverse of the steps
      // carries both halves (the adjoint is linear in its cotangent)
      if (linear && r1 && r2) {
        g_t1 = ff_refine_backward(fs, o.x, o.y, o.z, ds.x, ds.y, ds.z, t1, g_t1 + g_t2, g_o.x,
                                  g_o.y, g_o.z, g_ds.x, g_ds.y, g_ds.z, fct, tf);
        g_t2 = 0.0f;
      } else {
        if (r1)
          g_t1 = ff_refine_backward(fs, o.x, o.y, o.z, ds.x, ds.y, ds.z, t1, g_t1, g_o.x, g_o.y,
                                    g_o.z, g_ds.x, g_ds.y, g_ds.z, fct, tf);
        if (r2)
          g_t2 = ff_refine_backward(fs, o.x, o.y, o.z, ds.x, ds.y, ds.z, t2, g_t2, g_o.x, g_o.y,
                                    g_o.z, g_ds.x, g_ds.y, g_ds.z, fct, tf);
      }
    }
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
  if (asph) {
    // c = q[0] and kc2 = q[2] q[0]; a4..a10 = asph[0:4]
    tg[kGQ + 0] += ac.c + ac.kc2 * q[2];
    tg[kGQ + 2] += ac.kc2 * q[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) tg[kGAsph + j] += ac.a[j];
  }
  if (ffrow) {
    // the same columns for a freeform row's base and even-asphere terms
    tg[kGQ + 0] += fct.c + fct.kc2 * q[2];
    tg[kGQ + 2] += fct.kc2 * q[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) tg[kGAsph + j] += fct.a[j];
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

// The adjoint of a GRIN row of K2's chain or a GRIN winner of K6's bounce
// (kGrin) at its saved input state p, d and bits (grin.cuh::grin_backward;
// an inactive row passes every cotangent through): gp, gd and gi become the
// cotangents before it, oc's medium cotangent that of the medium before
// it, and the table's cotangents add into tg's Rw, tw and ph[0:6] columns.
__device__ __forceinline__ void grin_row_backward(const float* r, const RowKinds& kd, V3 p, V3 d,
                                                  uint32_t bits, OplCt& oc, V3& gp, V3& gd,
                                                  float& gi, float* tg) {
  if (!(bits & kActive)) return;
  G3 g_p = {gp.x, gp.y, gp.z}, g_d = {gd.x, gd.y, gd.z};
  float g_n = 0.0f;
  grin_backward(r, kd.map, G3{p.x, p.y, p.z}, G3{d.x, d.y, d.z}, bits, oc.n_cur, oc.g_opl,
                oc.g_n, g_p, g_d, gi, tg + kGRw, tg + kGTw, tg + kGPh, g_n);
  oc.g_n = g_n;
  gp = {g_p.x, g_p.y, g_p.z};
  gd = {g_d.x, g_d.y, g_d.z};
}

// One step of reduce_row's transpose reduce-scatter on the kH columns of
// a[0:2 kH]: a lane keeps the half that its bit kH selects, sends the other
// half to lane ^ kH and adds what that lane sends back, into a[0:kH].  kH is
// a template argument so that the loop unrolls and a stays in registers.
template <int kH>
__device__ __forceinline__ void transpose_step(float* a, int lane) {
  const bool upper = lane & kH;
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const float send = upper ? a[j] : a[j + kH];
    const float keep = upper ? a[j + kH] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, kH);
  }
}

// Reduce kCols columns of one row's cotangent over the lanes of a warp and
// add them into this warp's slot for the row; every lane of the warp calls
// it, each with its own tg (zeros for a lane that did not apply the row).  A
// transpose reduce-scatter: the columns, padded to 32, are halved five times
// (transpose_step), 16 + 8 + 4 + 2 + 1 = 31 shuffles, where a warp sum per
// column takes 5 (95 for 19 columns).  The selects are on constant
// indices, so tg stays in registers.  Lane c ends with column c, and each
// sum follows the tree of a warp sum (lane ^ 16 first, then ^ 8, ...), so
// every column's sum is the one a per-column warp sum gives, bit for bit.
// Lane c then adds it into slot[c]: one store per lane, adjacent words.
// reduce_row reduces a row's grad_cols<kPlates, kExt>() columns; the 12
// disp columns of a dispersive row follow them, reduced on their own.
template <int kCols>
__device__ __forceinline__ void reduce_cols(const float* tg, float* slot, int lane) {
  static_assert(kCols <= 32, "a warp holds at most 32 columns");
  float a[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = c < kCols ? tg[c] : 0.0f;
  transpose_step<16>(a, lane);
  transpose_step<8>(a, lane);
  transpose_step<4>(a, lane);
  transpose_step<2>(a, lane);
  transpose_step<1>(a, lane);
  if (lane < kCols) slot[lane] += a[0];
}

template <bool kPlates, bool kExt = false>
__device__ __forceinline__ void reduce_row(const float* tg, float* slot, int lane) {
  reduce_cols<grad_cols<kPlates, kExt>()>(tg, slot, lane);
}

}  // namespace rtt
