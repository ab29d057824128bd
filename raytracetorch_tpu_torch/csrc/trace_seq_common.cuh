// Shared by the fused kernels K1 (trace_seq_fwd.cu), K2 (trace_seq_bwd.cu),
// K5 (trace_nonseq_fwd.cu) and K6 (trace_nonseq_bwd.cu): the flat-row layout,
// the constants of the trace engine, small vector helpers, the bound checks,
// the warp sum, the packed scan record that K5 and K6's replay intersect
// from, and one row's intersection, normal and physics as K1 and K5
// evaluate them.  The adjoints (trace_seq_adjoint.cuh) take their branch
// decisions from these same functions, through their optional outputs, so a
// backward never re-decides a branch in another copy of the arithmetic.
//
// Pixelated phase plates (PHASE_GRID rows) read their [H, W] maps through
// kernel K4's device functions (grid_corners.cuh).  The functions that can
// meet such a row, or a RECT bound, take a compile-time kPlates: a kernel
// instantiated with kPlates = false (a scene with neither) has no plate code
// at all, so it runs the instructions it ran before plates existed.
//
// The kinds of the mixed-surface and asphere scenes, the "extended kinds"
// (the rectangular volume bound VB_RECT, a cylindrical lens's edge bound
// VB_CYL_EDGE, and even aspheres, whose base-conic roots are refined onto
// the sag by Halley steps and whose normal is the sag's), a convex solid's
// face bound VB_HALFSPACES (its other faces' planes, which ride the row's
// hp columns) and a single cone's nappe SB_CONE_NAPPE, and dispersive
// media (a SNELL or PHASE_GRID row whose indices depend on the ray's
// wavelength: Cauchy or Sellmeier glasses), take a second compile-time
// flag, kExt, set only in an instantiation that also has plate code (and so
// the rays' wavelengths).  The instantiations with kExt = false hold none of
// that code: a scene without those kinds runs the instructions it ran
// before.  Dispersion has a third flag, kDispersion, which defaults to kExt:
// K1 and K5 refract dispersive rows in their one extended instantiation, and
// K2 and K6 have a fourth instantiation with dispersion (kDispersion), so
// that their extended one without it keeps its registers
// (trace_seq_adjoint.cuh).
//
// The deterministic streams (the optical path length and the medium index,
// the positions after each row or bounce, the hit records) run in one more
// instantiation of each of K1, K2, K5 and K6, built on the one with
// dispersion (kStreams or kOpl: its kernels are overloads with one more
// argument, StreamOut or OplIn), so that every other instantiation keeps
// its code: medium_after below gives the medium a ray travels in after a
// row, from the refraction's own from_in and TIR decisions.
//
// The Fresnel kinds of uncoated interfaces (FRESNEL, the Monte-Carlo branch
// draw; FRESNEL_W, refraction with intensity times 1 - R; REFLECT_W, the
// ghost reflection with intensity times R) take a last compile-time flag,
// kFresnel, set only in one more instantiation of each kernel, built on the
// one with the streams (K1, K5) or the path length (K2, K6): every other
// instantiation holds none of their code.  FRESNEL reads one uniform per ray
// and row: K1 and K2 from the [F][n] streams the wrapper pre-draws, K5 and
// K6 from philox_uniform below, a pure function of (key, ray, bounce, row),
// so K6 replays K5's draws by their counters.
//
// Thin-film coatings and metal mirrors (a coated FRESNEL, FRESNEL_W or
// REFLECT_W row, a metal REFLECT row) take one more compile-time flag,
// kCoat, set only in one more instantiation of each kernel, built on the one
// with the Fresnel kinds.  A row's static coating data rides its kinds row
// (the layer count and flags above the dispersion bits, thin_film.cuh) and a
// [K][20] side buffer (the layers' extinction, a dispersive metal's knots)
// that the kernels keep in shared memory; the stack itself is
// thin_film.cuh's.  One stack evaluation per ray and row serves both the
// branch and medium_after (which reads the branch's bit), in the order the
// ray meets the layers.
//
// The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA rows,
// and the ELLIPSE surface bound) take one more compile-time flag, kDiff, set
// only in one more instantiation of each kernel, built on the one with the
// coatings (so that every combination the JAX kernels run runs here: a DOE
// beside dispersive glass, a grating beside a coated lens, a DOE under the
// path length): every other instantiation holds none of their code.  Their
// maps are diffractive.cuh's.  A DOE row's term count and efficiency flag
// ride its kinds row above the coating's bits (so in RowKinds::coat above
// its masks: doe_of), its coefficients its flat row's ff columns (in shared
// memory with the rest of the row).  The
// ELLIPSE bound reads its rotation's cosine and sine, which each block
// writes once per row over the rotation and the unused fourth bound word of
// its shared copy of the table (ellipse_rows).
//
// Freeform surfaces (an XY polynomial on a conic and even-asphere base: the
// FreeformLens and ZernikeLens faces) take one more compile-time flag,
// kFreeform, set only in one more instantiation of each kernel, built on the
// one with the fuzzy programs: every other instantiation holds none of their
// code.  A freeform row's kinds row has surface kSurfFreeform; its exponent
// pairs ride a side buffer of kFfSide int32 words a row (freeform.cuh), in
// shared memory, and its coefficients its flat row's ff columns.  The
// intersection refines both base-conic roots by 8 Newton steps, the normal
// is the sag's (freeform.cuh).  A row is freeform or DOE, never both (the
// elements build no such row): both read the ff columns.
//
// The polarized field (track_field: a complex E-vector per ray, field.cuh)
// takes one more compile-time flag, kField, set only in the field's
// instantiations of each kernel: one that takes every family but GRIN rods
// (nonseq_bounce, field_winner) and one for tables with a GRIN rod, which
// takes every family (field_link): every other instantiation holds none of
// its code.  A rod carries the field through its steps (grin.cuh::
// grin_rod_field).  Under it the Fresnel
// kinds of bare interfaces draw and weigh with the polarized reflectance of
// the ray's field (fresnel_physics with kField), a JONES row (a polarizer
// or a waveplate) passes the ray through, and field_row gathers what a row's
// transport reads; a JONES row's static bits (chromatic, crystal) ride its
// kinds row where a coated row's coating bits ride theirs.
//
// The families.  The flags kFresnel, kCoat, kDiff, kFuzzy, kFreeform and
// kGrin are each a family of kinds; the kernels compile them together, in
// one instantiation of each (the family instantiation, with the streams),
// and the field's instantiations compile all but kGrin and, for a table
// with a rod, all, so that a table that mixes families (a GRIN rod beside a
// coated lens, a DOE under the field, a rod under the field) runs as the
// JAX kernels run it.  Which families a table has rides
// a launch's runtime word FamSide::fam (kFam* bits; ops/fused_trace.py::
// families): an absent family's per-block setup (the shared copies of its
// side buffer, programs or exponent pairs, the ELLIPSE rows) is skipped and
// its buffer pointer is null.  A row's physics still dispatches on its own
// kind, as in every instantiation.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "diffractive.cuh"
#include "field.cuh"
#include "freeform.cuh"
#include "fuzzy.cuh"
#include "grid_corners.cuh"
#include "grin.cuh"
#include "thin_film.cuh"

namespace rtt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWidth = 160;
constexpr int kKindWidth = 8;
constexpr int kMoments = 7;

// Offsets of the float columns in a flat row (core/table.py ROW_FIELDS).
constexpr int kQ = 0, kNSign = 5, kRw = 6, kTw = 15, kRs = 18, kTs = 27;
constexpr int kSb = 30, kVb = 34, kPh = 42, kAsph = 48, kDisp = 52;
// A solid's half-spaces (VB_HALFSPACES): kMaxHalfspaces outward normals, their
// offsets and their mask (float 0/1: a row's own face and the padding 0).
constexpr int kHpN = 64, kHpD = 88, kHpMask = 96;
constexpr int kMaxHalfspaces = 8;
constexpr int kCoatCol = 104;  // the thin-film stack: (index, thickness) x 8
constexpr int kFf = 120;       // a DOE row's radial phase coefficients
static_assert(kGrRw == kRw && kGrTw == kTw && kGrSb == kSb && kGrPh == kPh,
              "grin.cuh reads the flat row's columns");

// Columns of a kinds row (ops/fused_trace.py::kind_rows).
constexpr int kPhCol = 0, kSbCol = 1, kVbCol = 2, kPlaneCol = 3;
constexpr int kSensorCol = 4, kSlotCol = 5, kInvertCol = 6;
constexpr int kMapCol = 7;  // a PHASE_GRID row's map (plate) index
// The surface column (kPlaneCol): the quadric solver, the plane fast path,
// or (kExt only) the quadric's roots refined onto an even asphere.
constexpr int kSurfPlane = 1, kSurfAsph = 2, kSurfFreeform = 3;
// A dispersive row's two DispModels ride the physics column from bit
// kDispShift on, two bits a side, in then out (ops/fused_trace.py
// DISP_SHIFT); only read_row_kinds<true> decodes them.
constexpr int kDispShift = 8;

// constants.py and geom/surfaces.py
constexpr float kBig = 1e30f;
constexpr float kIntersectEps = 1e-6f;
constexpr float kSolverEps = 1e-6f;
constexpr float kNormalEps = 1e-8f;
constexpr float kRelEps = 1e-5f;
constexpr float kCylRectEps = 1e-5f;
constexpr float kCylEdgeEps = 1e-4f;
constexpr float kCvxEps = 1e-4f;

enum PhysKind {
  TRANSMIT = 0,
  BLOCK = 1,
  REFLECT = 2,
  SNELL = 3,
  FRESNEL = 4,
  LINEAR = 5,
  APERTURE = 6,
  GRATING = 7,
  FRESNEL_W = 8,
  REFLECT_W = 9,
  JONES = 11,
  GRIN = 12,
  DOE = 13,
  MLA = 14,
  PHASE_GRID = 15
};
enum SBKind {
  SB_NONE = 0,
  SB_DISK = 1,
  SB_RECT = 2,
  SB_ELLIPSE = 3,
  SB_HEMI = 4,
  SB_HEMI_APER = 5,
  SB_CONE_NAPPE = 6
};
enum VBKind {
  VB_NONE = 0,
  VB_APER_R2 = 1,
  VB_Z_BETWEEN = 2,
  VB_RECT = 3,
  VB_CYL_EDGE = 4,
  VB_HALFSPACES = 5
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// u + s * v
__device__ __forceinline__ V3 fma3(V3 u, float s, V3 v) {
  return {u.x + s * v.x, u.y + s * v.y, u.z + s * v.z};
}

// v @ R with R a row-major 3x3 (a pointer to it, or Vals<9>)
template <class M>
__device__ __forceinline__ V3 rot(V3 v, const M& R) {
  return {v.x * R[0] + v.y * R[3] + v.z * R[6],
          v.x * R[1] + v.y * R[4] + v.z * R[7],
          v.x * R[2] + v.y * R[5] + v.z * R[8]};
}

// v @ R.T
template <class M>
__device__ __forceinline__ V3 rot_t(V3 v, const M& R) {
  return {v.x * R[0] + v.y * R[1] + v.z * R[2],
          v.x * R[3] + v.y * R[4] + v.z * R[5],
          v.x * R[6] + v.y * R[7] + v.z * R[8]};
}

// A surface bound of both roots' surface-frame hits a and b, under one
// dispatch on the kind.  The RECT bound (a phase plate's or a rectangular
// stop's) is plate code: only the kPlates instantiation tests it.  `sb` is
// the row's bound parameters: a pointer into a flat row, or Vals<3>.  With
// kDiff (which scans flat rows) the ELLIPSE bound reads its axes and its
// rotation's cosine and sine (sb[2], sb[3]: ellipse_rows).  A single cone's
// nappe (CONE_NAPPE, [slope]) is an extended kind: only the instantiations
// with kExt test it.
template <bool kPlates, bool kDiff = false, bool kExt = false, class S>
__device__ __forceinline__ void sb_check2(int kind, const S& sb, V3 a, V3 b, bool& ka,
                                          bool& kb) {
  if (kind == SB_DISK) {
    const float a0 = a.x - sb[1], a1 = a.y - sb[2];
    const float b0 = b.x - sb[1], b1 = b.y - sb[2];
    ka = a0 * a0 + a1 * a1 <= sb[0];
    kb = b0 * b0 + b1 * b1 <= sb[0];
  } else if (kPlates && kind == SB_RECT) {
    ka = fabsf(a.x) <= sb[0] && fabsf(a.y) <= sb[1];
    kb = fabsf(b.x) <= sb[0] && fabsf(b.y) <= sb[1];
  } else if (kind == SB_HEMI) {
    ka = fabsf(a.z * sb[0]) < 1.0f + kIntersectEps;
    kb = fabsf(b.z * sb[0]) < 1.0f + kIntersectEps;
  } else if (kind == SB_HEMI_APER) {
    ka = fabsf(a.z * sb[0]) < 1.0f + kIntersectEps && a.x * a.x + a.y * a.y <= sb[1];
    kb = fabsf(b.z * sb[0]) < 1.0f + kIntersectEps && b.x * b.x + b.y * b.y <= sb[1];
  } else if (kDiff && kind == SB_ELLIPSE) {
    ka = ellipse_in(a.x, a.y, sb[0], sb[1], sb[2], sb[3]);
    kb = ellipse_in(b.x, b.y, sb[0], sb[1], sb[2], sb[3]);
  } else if (kExt && kind == SB_CONE_NAPPE) {
    ka = a.z * sb[0] >= -kIntersectEps;
    kb = b.z * sb[0] >= -kIntersectEps;
  } else {
    ka = true;
    kb = true;
  }
}

// The surface bound of one hit h.
template <bool kPlates, bool kDiff = false, bool kExt = false, class S>
__device__ __forceinline__ bool sb_check(int kind, const S& sb, V3 h) {
  bool k, unused;
  sb_check2<kPlates, kDiff, kExt>(kind, sb, h, h, k, unused);
  return k;
}

// The row setup of the instantiation with the diffractive kinds: each
// ELLIPSE row of the block's shared table `tab` (kinds `knd`) gets its
// rotation's cosine and sine in place of the rotation and of the bound's
// unused fourth word, once per row and block (the bound has no cotangent,
// so nothing reads the rotation itself again).  Every thread of the block
// calls it between a __syncthreads() that ends the table's copy and one
// before the rows are read.
__device__ __forceinline__ void ellipse_rows(float* tab, const int32_t* knd, int n_rows, int tid,
                                             int n_threads) {
  for (int k = tid; k < n_rows; k += n_threads) {
    if (knd[k * kKindWidth + kSbCol] == SB_ELLIPSE) {
      float* sb = tab + k * kRowWidth + kSb;
      const float rotation = sb[2];
      sb[2] = cosf(rotation);
      sb[3] = sinf(rotation);
    }
  }
}

// Sag of a curvature-c surface at radius r (geom/surfaces.py::sag_z).
__device__ __forceinline__ float sag_z(float c, float r) {
  const float r2 = r * r;
  const float term = fmaxf(1.0f - c * c * r2, 0.0f);
  return (c * r2) / (1.0f + sqrtf(term + 1e-24f));
}

// Inside the rectangle [v[0], v[1]] x [v[2], v[3]] with kCylRectEps slack.
template <class S>
__device__ __forceinline__ bool in_rect(const S& v, int i, float x, float y) {
  return x <= v[i + 1] + kCylRectEps && x >= v[i] - kCylRectEps && y <= v[i + 3] + kCylRectEps &&
         y >= v[i + 2] - kCylRectEps;
}

// Inside every active half-space of a solid's face: n . h - d < kCvxEps for
// each plane whose mask is set (core/static_dispatch.py::vb_check_one,
// HALFSPACES).  `r` is the row's flat row.  The AND of the planes does not
// depend on their order, so the loop visits the active planes alone and
// leaves at the first that rejects the hit.
__device__ __forceinline__ bool in_halfspaces(const float* r, V3 h) {
#pragma unroll 1
  for (int j = 0; j < kMaxHalfspaces; ++j) {
    if (r[kHpMask + j] > 0.5f) {
      const float* n = r + kHpN + 3 * j;
      if (!(n[0] * h.x + n[1] * h.y + n[2] * h.z - r[kHpD + j] < kCvxEps)) return false;
    }
  }
  return true;
}

// The volume bound of an element-frame hit h (core/static_dispatch.py::
// vb_check_one).  VB_RECT, VB_CYL_EDGE and VB_HALFSPACES are the extended
// kinds' (kExt), whose rows are flat rows: `r`, the row, gives the
// half-spaces.
template <bool kExt, class S>
__device__ __forceinline__ bool vb_check(int kind, const S& vb, V3 h,
                                         const float* r = nullptr) {
  if (kind == VB_APER_R2) return h.x * h.x + h.y * h.y <= vb[0];
  if (kind == VB_Z_BETWEEN) return h.z >= vb[0] && h.z <= vb[1];
  if constexpr (kExt) {
    if (kind == VB_RECT) return in_rect(vb, 0, h.x, h.y);
    if (kind == VB_CYL_EDGE)
      // [c1, z1, c2, z2, xmin, xmax, ymin, ymax]: between the y-dependent
      // sags of a cylindrical lens's faces
      return in_rect(vb, 4, h.x, h.y) && h.z >= sag_z(vb[0], h.y) + vb[1] + kCylEdgeEps &&
             h.z <= sag_z(vb[2], h.y) + vb[3] - kCylEdgeEps;
    if (kind == VB_HALFSPACES) return in_halfspaces(r, h);
  }
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The kinds of one table row, read from its int32 kinds row.  dispm holds a
// dispersive row's two DispModels (disp_model; 0: not dispersive), coat a
// coated or metal row's layer count and flags (thin_film.cuh; 0: none) and,
// above them, a DOE row's term count and efficiency flag (doe_of).
struct RowKinds {
  int ph, sb, vb, slot, map;
  bool plane, sensor, invert, asph;
  int dispm;
  int coat;
};

// A DOE row's term count and efficiency flag (diffractive.cuh), from the
// coat bits of its kinds (the column's bits from kDoeShift on).
__device__ __forceinline__ int doe_of(int coat) { return coat >> (kDoeShift - kCoatShift); }

// The row's kinds; without kExt the surface column is 0 or 1 and asph is
// false; without kDispersion the physics column holds the kind alone and
// dispm is 0; without kCoat coat is 0 (and the dispersion bits are the
// column's top bits), with it the bits above the dispersion's.
template <bool kExt = false, bool kDispersion = kExt, bool kCoat = false>
__device__ __forceinline__ RowKinds read_row_kinds(const int32_t* kd) {
  return {kDispersion ? kd[kPhCol] & ((1 << kDispShift) - 1) : kd[kPhCol],
          kd[kSbCol],
          kd[kVbCol],
          kd[kSlotCol],
          kd[kMapCol],
          kExt ? kd[kPlaneCol] == kSurfPlane : kd[kPlaneCol] != 0,
          kd[kSensorCol] != 0,
          kd[kInvertCol] != 0,
          kExt && kd[kPlaneCol] == kSurfAsph,
          kDispersion ? (kCoat ? (kd[kPhCol] >> kDispShift) & ((1 << (kCoatShift - kDispShift)) - 1)
                               : kd[kPhCol] >> kDispShift)
                      : 0,
          kCoat ? kd[kPhCol] >> kCoatShift : 0};
}

// ---- Counter-based draws (kFresnel, K5 and K6): Philox4x32-10 (Salmon et
// al., SC'11), written out with __umulhi; rays/draws.py is its plain
// version, and both are held to the generator's known-answer vectors. ----

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

struct PhiloxKey {
  uint32_t k0, k1;
};

// The 10 rounds of Philox4x32 on counter c under key k; c receives the four
// output words.
__device__ __forceinline__ void philox4x32(uint32_t (&c)[4], PhiloxKey k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c[0]), lo0 = kPhiloxM0 * c[0];
    const uint32_t hi1 = __umulhi(kPhiloxM1, c[2]), lo1 = kPhiloxM1 * c[2];
    c[0] = hi1 ^ c[1] ^ k.k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k.k1;
    c[3] = lo0;
    k.k0 += kPhiloxW0;
    k.k1 += kPhiloxW1;
  }
}

// The non-sequential draw of ray n at bounce b for row k: (word0 >> 8) *
// 2^-24 of the counter (n, b, k, 0), in [0, 1) and exact in float (word1 is
// kept for a second draw of the same row).
__device__ __forceinline__ float philox_uniform(PhiloxKey key, uint32_t n, uint32_t b,
                                                uint32_t k) {
  uint32_t c[4] = {n, b, k, 0u};
  philox4x32(c, key);
  return static_cast<float>(c[0] >> 8) * 5.9604644775390625e-08f;
}

// Where a non-sequential FRESNEL draw comes from: the key and the ray's and
// bounce's counter words.
struct RayDraw {
  PhiloxKey key;
  uint32_t ray, bounce;
};

// The families of kinds a launch of the family or field instantiation runs
// (ops/fused_trace.py::FAM_*): bits of FamSide::fam.
constexpr uint32_t kFamFresnel = 1u, kFamCoat = 2u, kFamDiff = 4u, kFamFuzzy = 8u,
                   kFamFreeform = 16u, kFamGrin = 32u;
// The compile-time family sets of the instantiations: the family
// instantiation's (every family); the chain's links, which a table of one
// family runs, as before the collapse (the A/B of PERF.md: on such tables
// the family instantiation, carrying every family's code, runs K2 and K6
// 1.3-2.2x slower): the Fresnel kinds alone, the coatings (with the Fresnel
// kinds of their faces), the diffractive kinds (built on those), the fuzzy
// programs (built on those), GRIN rods alone; the field's (every family but
// GRIN), the field's on the Fresnel kinds and coatings alone (K5's and
// K6's for tables without the diffractive, fuzzy or freeform kinds: the
// earlier field instantiation) and the field's with every family (tables
// with a GRIN rod: field_link).
constexpr uint32_t kFamAll = 63u, kFamField = kFamAll & ~kFamGrin;
constexpr uint32_t kFamCoatLink = kFamFresnel | kFamCoat;
constexpr uint32_t kFamDiffLink = kFamCoatLink | kFamDiff;
constexpr uint32_t kFamFuzzyLink = kFamDiffLink | kFamFuzzy;
constexpr uint32_t kFamFieldCoat = kFamCoatLink;

// Whether the family set kFams (a template argument) holds family `bit`.
__host__ __device__ constexpr bool fam_has(uint32_t fams, uint32_t bit) {
  return (fams & bit) != 0u;
}

// The family set of the instantiation that a launch of the families `fam`
// (not 0) runs: the chain's first link that takes them all, or for a
// freeform table, a GRIN rod beside another family or any other mix the
// chain did not take, the family instantiation.  K5 and K6 (kGrinLink
// false) run GRIN rods alone in the family instantiation too: with the
// field's two instantiations (below) a seventh link would take them past
// the parent's seven instantiations above the streams' (PERF.md).
template <bool kGrinLink = true>
__host__ __device__ constexpr uint32_t fam_link(uint32_t fam) {
  return kGrinLink && fam == kFamGrin       ? kFamGrin
         : fam == kFamFresnel               ? kFamFresnel
         : (fam & ~kFamCoatLink) == 0u      ? kFamCoatLink
         : (fam & ~kFamDiffLink) == 0u      ? kFamDiffLink
         : (fam & ~kFamFuzzyLink) == 0u     ? kFamFuzzyLink
                                            : kFamAll;
}

// Calls f(std::integral_constant<uint32_t, kFams>{}) with the family set of
// the instantiation fam_link<kGrinLink>(fam) selects: a launcher's one call
// site for the six instantiations (five without kGrinLink).
template <bool kGrinLink = true, class F>
auto with_fam_link(uint32_t fam, F&& f) {
  if constexpr (kGrinLink) {  // (without it no kernel of that link is built)
    if (fam == kFamGrin) return f(std::integral_constant<uint32_t, kFamGrin>{});
  }
  switch (fam_link<kGrinLink>(fam)) {
    case kFamFresnel:
      return f(std::integral_constant<uint32_t, kFamFresnel>{});
    case kFamCoatLink:
      return f(std::integral_constant<uint32_t, kFamCoatLink>{});
    case kFamDiffLink:
      return f(std::integral_constant<uint32_t, kFamDiffLink>{});
    case kFamFuzzyLink:
      return f(std::integral_constant<uint32_t, kFamFuzzyLink>{});
    default:
      return f(std::integral_constant<uint32_t, kFamAll>{});
  }
}

// The family set of the field's instantiation that a launch of the
// families `fam` runs: a table with a GRIN rod the one with every family
// (kFamAll), so that the others keep their code; else K5's and K6's
// (kCoatLink) kFamFieldCoat without the diffractive, fuzzy or freeform
// kinds, and kFamField.
template <bool kCoatLink>
__host__ __device__ constexpr uint32_t field_link(uint32_t fam) {
  return (fam & kFamGrin) != 0u                       ? kFamAll
         : kCoatLink && (fam & ~kFamFieldCoat) == 0u ? kFamFieldCoat
                                                      : kFamField;
}

// Calls f(std::integral_constant<uint32_t, kFams>{}) with the family set
// field_link<kCoatLink>(fam) selects: a launcher's one call site for the
// field's instantiations.
template <bool kCoatLink, class F>
auto with_field_link(uint32_t fam, F&& f) {
  switch (field_link<kCoatLink>(fam)) {
    case kFamAll:
      return f(std::integral_constant<uint32_t, kFamAll>{});
    case kFamFieldCoat:
      if constexpr (kCoatLink) return f(std::integral_constant<uint32_t, kFamFieldCoat>{});
      [[fallthrough]];
    default:
      return f(std::integral_constant<uint32_t, kFamField>{});
  }
}

// The side data of the family and field instantiations, each pointer null
// where the table lacks its family: K1's and K2's FRESNEL uniforms (n_draws
// streams of n floats, one per FRESNEL row in row order) or K5's and K6's
// Philox key, the coated rows' side buffer ([K][kCoatSide] floats,
// ops/fused_trace.py::coat_side), the fuzzy programs (n_words int32 words,
// fuzzy.cuh), the freeform rows' exponent pairs ([K][kFfSide] int32 words,
// freeform.cuh), and the families (kFam* bits).  GRIN rods read nothing
// more: a rod rides its flat row, its step count its kinds row, and K2's and
// K6's adjoint keeps its checkpoints in local memory (grin.cuh).
struct FamSide {
  const float* u;
  int n_draws;
  PhiloxKey key;
  const float* coat;
  const int32_t* fuzzy;
  int fuzzy_words;
  const int32_t* ff;
  uint32_t fam;
};

// The words of a launch's fuzzy programs and freeform pairs in shared
// memory (0 where the table lacks the family), and of its side buffer.
__host__ __device__ __forceinline__ int fam_coat_words(const FamSide& fs, int n_rows) {
  return (fs.fam & kFamCoat) ? n_rows * kCoatSide : 0;
}
__host__ __device__ __forceinline__ int fam_fuzzy_words(const FamSide& fs) {
  return (fs.fam & kFamFuzzy) ? fs.fuzzy_words : 0;
}
__host__ __device__ __forceinline__ int fam_ff_words(const FamSide& fs, int n_rows) {
  return (fs.fam & kFamFreeform) ? n_rows * kFfSide : 0;
}

// ---- The packed scan record (K5's scan, and K6's replay of it) ----
//
// The non-sequential scan intersects every row at every bounce.  Read from
// the flat row, whose fields lie at offsets that are not 16-byte aligned,
// one intersection takes 24-37 scalar shared loads.  So each block copies
// the fields the intersection reads into a 40-word record per row, 16-byte
// aligned, and the scan reads it with 128-bit loads: 4 for a plane row
// without bounds, 10 at most.  The words, in order: the four kinds the
// intersection branches on, as ints (plane, surface bound, volume bound,
// invert), tw, Rw, q, the surface bound's first 3 parameters, the volume
// bound's first 2, ts, Rs, two words of padding
// (tests/test_torch_kernel_layout.py holds them to core/table.py's
// ROW_FIELDS and ops/fused_trace.py::kind_rows).
constexpr int kRecScan = 0;  // plane, surface bound, volume bound, invert
constexpr int kRecTw = 4;
constexpr int kRecRw = 7;
constexpr int kRecQ = 16;
constexpr int kRecSb = 21;
constexpr int kRecVb = 24;
constexpr int kRecTs = 26;
constexpr int kRecRs = 29;
constexpr int kRecPad = 38;
constexpr int kRecWords = 40;
constexpr int kRec4 = kRecWords / 4;  // float4s per record
static_assert(kRecScan == 0 && kRecTw == 4 && kRecWords % 4 == 0 && kRecPad < kRecWords,
              "the kinds fill the first float4, the record whole float4s");

// The flat-row column that record word w copies (-1: the kinds, the
// padding).
__host__ __device__ constexpr int rec_col(int w) {
  return w < kRecTw    ? -1
         : w < kRecRw  ? kTw + (w - kRecTw)
         : w < kRecQ   ? kRw + (w - kRecRw)
         : w < kRecSb  ? kQ + (w - kRecQ)
         : w < kRecVb  ? kSb + (w - kRecSb)
         : w < kRecTs  ? kVb + (w - kRecVb)
         : w < kRecRs  ? kTs + (w - kRecTs)
         : w < kRecPad ? kRs + (w - kRecRs)
                       : -1;
}

// Write the n_rows records of the flat table and kinds (device memory) into
// `rec` (shared memory, 16-byte aligned); every thread of the block calls
// it, and a __syncthreads() must follow before the records are read.
__device__ __forceinline__ void build_scan_records(float* rec, const float* table,
                                                   const int32_t* kinds, int n_rows, int tid,
                                                   int n_threads) {
  for (int j = tid; j < n_rows * kRecWords; j += n_threads) {
    const int k = j / kRecWords, w = j - k * kRecWords;
    const int col = rec_col(w);
    const int32_t* kd = kinds + k * kKindWidth;
    rec[j] = w == kRecScan       ? __int_as_float(kd[kPlaneCol] != 0)
             : w == kRecScan + 1 ? __int_as_float(kd[kSbCol])
             : w == kRecScan + 2 ? __int_as_float(kd[kVbCol])
             : w == kRecScan + 3 ? __int_as_float(kd[kInvertCol] != 0)
             : col >= 0          ? table[k * kRowWidth + col]
                                 : 0.0f;
  }
}

// kN floats held by value (in registers once inlined), indexed like the
// pointer into a flat row they replace.
template <int kN>
struct Vals {
  float a[kN];
  __device__ __forceinline__ float operator[](int j) const { return a[j]; }
};

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Record words [kOff, kOff + kN), read as the whole float4s that hold them.
template <int kOff, int kN>
__device__ __forceinline__ Vals<kN> rec_vals(const float4* v) {
  constexpr int kFirst = kOff / 4, kLast = (kOff + kN - 1) / 4;
  float4 g[kLast - kFirst + 1];
#pragma unroll
  for (int j = 0; j <= kLast - kFirst; ++j) g[j] = v[kFirst + j];
  Vals<kN> out;
#pragma unroll
  for (int j = 0; j < kN; ++j) out.a[j] = lane_of(g[(kOff + j) / 4 - kFirst], (kOff + j) % 4);
  return out;
}

// What intersect_row reads of a row, from a packed record or a flat row.
struct RecRow {
  const float4* v;  // the row's kRec4 float4s
  // the kinds the intersection reads (the others left 0)
  __device__ __forceinline__ RowKinds scan_kinds() const {
    const float4 k = v[kRecScan / 4];
    return {0,     __float_as_int(k.y), __float_as_int(k.z),      0, 0, __float_as_int(k.x) != 0,
            false, __float_as_int(k.w) != 0, false};
  }
  __device__ __forceinline__ V3 tw() const {
    const Vals<3> t = rec_vals<kRecTw, 3>(v);
    return {t[0], t[1], t[2]};
  }
  __device__ __forceinline__ Vals<9> rw() const { return rec_vals<kRecRw, 9>(v); }
  __device__ __forceinline__ Vals<5> q() const { return rec_vals<kRecQ, 5>(v); }
  __device__ __forceinline__ Vals<3> sb() const { return rec_vals<kRecSb, 3>(v); }
  __device__ __forceinline__ Vals<2> vb() const { return rec_vals<kRecVb, 2>(v); }
  __device__ __forceinline__ V3 ts() const {
    const Vals<3> t = rec_vals<kRecTs, 3>(v);
    return {t[0], t[1], t[2]};
  }
  __device__ __forceinline__ Vals<9> rs() const { return rec_vals<kRecRs, 9>(v); }
};

struct FlatRowRef {
  const float* r;  // a flat row of kRowWidth floats
  __device__ __forceinline__ V3 tw() const { return {r[kTw], r[kTw + 1], r[kTw + 2]}; }
  __device__ __forceinline__ const float* rw() const { return r + kRw; }
  __device__ __forceinline__ const float* q() const { return r + kQ; }
  __device__ __forceinline__ const float* sb() const { return r + kSb; }
  __device__ __forceinline__ const float* vb() const { return r + kVb; }
  __device__ __forceinline__ V3 ts() const { return {r[kTs], r[kTs + 1], r[kTs + 2]}; }
  __device__ __forceinline__ const float* rs() const { return r + kRs; }
  __device__ __forceinline__ const float* asph() const { return r + kAsph; }
  __device__ __forceinline__ const float* ff() const { return r + kFf; }
  __device__ __forceinline__ const float* row() const { return r; }
};

// A row's exponent pairs in the freeform side buffer `ffs` ([K][kFfSide]),
// or null for a row that is not freeform (term count 0).
__device__ __forceinline__ const int32_t* ff_row_of(const int32_t* ffs, int k) {
  return ffs[k * kFfSide] > 0 ? ffs + k * kFfSide : nullptr;
}

// ---- Even aspheres (kExt): geom/surfaces.py::asph_sag, asph_refine,
// asph_normal.  An asphere row's q holds its base conic (c, c, (1 + k) c,
// -2, 0) and asph[0:4] the a4..a10 terms. ----

struct Asph {
  float c, kc2, a[4];  // kc2 = (1 + k) c^2 = q[2] q[0]
};

__device__ __forceinline__ Asph asph_of(const float* q, const float* a) {
  return {q[0], q[2] * q[0], {a[0], a[1], a[2], a[3]}};
}

// G(t) = z - sag(r^2) along the ray o + t d and its first two derivatives
// in t: the closed forms of geom/surfaces.py::_asph_g, in its order.
struct AsphG {
  float g, dg, d2g;
};

__device__ __forceinline__ AsphG asph_g(const Asph& s, V3 o, V3 d, float t) {
  const float x = o.x + t * d.x, y = o.y + t * d.y, z = o.z + t * d.z;
  const float r2 = x * x + y * y;
  const float term = fmaxf(1.0f - s.kc2 * r2, 0.0f);
  const float sq = sqrtf(term + 1e-24f);
  const float den1 = 1.0f + sq;
  float sag = s.c * r2 / den1, rp = r2 * r2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sag = sag + s.a[j] * rp;
    rp = rp * r2;
  }
  const float inv = 1.0f / (2.0f * sq * (den1 * den1));
  float dsag = s.c / den1 + s.c * r2 * s.kc2 * inv;
  rp = r2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dsag = dsag + static_cast<float>(j + 2) * s.a[j] * rp;
    rp = rp * r2;
  }
  const float dsq = -s.kc2 * (0.5f / sq);
  const float dinv = -(1.0f / sq + 2.0f / den1) * inv * dsq;
  float d2sag = 2.0f * s.c * s.kc2 * inv + s.c * r2 * s.kc2 * dinv;
  rp = 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d2sag = d2sag + static_cast<float>((j + 2) * (j + 1)) * s.a[j] * rp;
    rp = rp * r2;
  }
  const float dr2 = 2.0f * (x * d.x + y * d.y);
  const float d2r2 = 2.0f * (d.x * d.x + d.y * d.y);
  return {z - sag, d.z - dsag * dr2, -(d2sag * dr2 * dr2 + dsag * d2r2)};
}

constexpr int kAsphSteps = 4;  // Halley steps of asph_refine

// One Halley step t - 2 G G' / (2 G'^2 - G G''), the denominator held off
// zero at 1e-12.
__device__ __forceinline__ float asph_step(const Asph& s, V3 o, V3 d, float t) {
  const AsphG G = asph_g(s, o, d, t);
  float denom = 2.0f * G.dg * G.dg - G.g * G.d2g;
  denom = fabsf(denom) < 1e-12f ? 1e-12f : denom;
  return t - 2.0f * G.g * G.dg / denom;
}

// The Halley steps from a base-conic root t.
__device__ __forceinline__ float asph_steps(const Asph& s, V3 o, V3 d, float t) {
#pragma unroll 1
  for (int i = 0; i < kAsphSteps; ++i) t = asph_step(s, o, d, t);
  return t;
}

// Refine a base-conic root t onto the asphere; `valid` stays true where
// |G| < 1e-4 after the steps and t > INTERSECT_EPS.
__device__ __forceinline__ float asph_refine(const Asph& s, V3 o, V3 d, float t, bool& valid) {
  t = asph_steps(s, o, d, t);
  valid = valid && fabsf(asph_g(s, o, d, t).g) < 1e-4f && t > kIntersectEps;
  return t;
}

// The asphere's sag slope dS/dr^2 at a surface-frame point, as
// asph_normal writes it.
__device__ __forceinline__ float asph_slope(const Asph& s, float r2) {
  const float sq = sqrtf(fmaxf(1.0f - s.kc2 * r2, 0.0f) + 1e-24f);
  const float den1 = 1.0f + sq;
  float dsag = s.c / den1 + s.c * r2 * s.kc2 / (2.0f * sq * (den1 * den1));
  float rp = r2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dsag = dsag + static_cast<float>(j + 2) * s.a[j] * rp;
    rp = rp * r2;
  }
  return dsag;
}

// Unit normal (-2 S' x, -2 S' y, 1) / |.| at a surface-frame hit (no
// orientation sign: +z at the vertex).
__device__ __forceinline__ V3 asph_normal(const Asph& s, V3 h) {
  const float dsag = asph_slope(s, h.x * h.x + h.y * h.y);
  const float gx = -2.0f * dsag * h.x, gy = -2.0f * dsag * h.y;
  const float inv = 1.0f / sqrtf(gx * gx + gy * gy + 1.0f + 1e-24f);
  return {gx * inv, gy * inv, inv};
}

// ---- Dispersive media (kExt): core/static_dispatch.py::dispersive_iors.
// A dispersive row's disp columns hold [in side 6 | out side 6]: a Cauchy
// side's B (um^2) first, a Sellmeier side's B1 B2 B3 C1 C2 C3 (C in um^2);
// a Cauchy or constant side's d-line index is its ph column. ----

enum DispModel { DISP_NONE = 0, DISP_CAUCHY = 1, DISP_SELLMEIER = 2 };

// lambda_d^2 and its inverse (the d line, 0.5876 um), rounded once to float
constexpr float kDLine2 = static_cast<float>(0.5876 * 0.5876);
constexpr float kInvDLine2 = static_cast<float>(1.0 / (0.5876 * 0.5876));

// The DispModel of a row's side 0 (in) or 1 (out).
__device__ __forceinline__ int disp_model(int dispm, int side) {
  return (dispm >> (2 * side)) & 3;
}

// lambda^2 (um^2) of a wavelength, held at 1e-6 or more; an unset one (not
// > 0) the d line's.
__device__ __forceinline__ float disp_l2(float wl) {
  return wl > 0.0f ? fmaxf(wl * wl, 1e-6f) : kDLine2;
}

// A Sellmeier term's denominator lambda^2 - C, held off zero at 1e-9.
__device__ __forceinline__ float sellmeier_den(float l2, float c) {
  const float den = l2 - c;
  return fabsf(den) < 1e-9f ? (den < 0.0f ? -1e-9f : 1e-9f) : den;
}

// One side's index at lambda^2 l2: c, its 6 disp columns; nd, its ph.
__device__ __forceinline__ float disp_side(int model, float nd, const float* c, float l2) {
  if (model == DISP_SELLMEIER) {
    float n2 = 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) n2 = n2 + c[i] * l2 / sellmeier_den(l2, c[3 + i]);
    return sqrtf(fmaxf(n2, 1e-6f));
  }
  if (model == DISP_CAUCHY) return nd + c[0] * (1.0f / l2 - kInvDLine2);
  return nd;
}

// The indices (n1, n2) of the media of incidence and transmission of a
// SNELL or PHASE_GRID row: ph[0:2] by the side the ray arrives from, or
// with kDispersion on a dispersive row (dispm) each side's index at the ray's
// wavelength wl.
template <bool kDispersion>
__device__ __forceinline__ void media_iors(const float* r, bool from_in, int dispm, float wl,
                                           float& n1, float& n2) {
  if constexpr (kDispersion) {
    float n_in = r[kPh], n_out = r[kPh + 1];
    if (dispm != 0) {
      const float l2 = disp_l2(wl);
      n_in = disp_side(disp_model(dispm, 0), n_in, r + kDisp, l2);
      n_out = disp_side(disp_model(dispm, 1), n_out, r + kDisp + 6, l2);
    }
    n1 = from_in ? n_in : n_out;
    n2 = from_in ? n_out : n_in;
  } else {
    n1 = from_in ? r[kPh] : r[kPh + 1];
    n2 = from_in ? r[kPh + 1] : r[kPh];
  }
}

// One row's hit: the ray parameter t (0 where invalid), validity, the hit in
// the surface frame, and the branches the adjoint needs: which root is the
// minimum (both on a tie) and whether the quadric solver took its linear path.
struct RowHit {
  float t;
  bool valid;
  V3 hs;
  bool root1, root2, linear;
};

// Intersect a ray (world frame) with a row (core/intersect.py): plane fast
// path or the quadric solver (with kExt, an asphere's roots refined onto its
// sag), surface-local bound per root, the minimum positive root above the
// world-scale epsilon, then the volume bound.  The row is a RecRow or a
// FlatRowRef (a FlatRowRef only with kExt): the same arithmetic on the same
// values.  kDiff adds the ELLIPSE bound.  With kFreeform (which has kExt) a
// row with exponent pairs `ffp` (ff_row_of; null: not freeform) refines its
// roots onto its sag (freeform.cuh::ff_refine).
template <bool kPlates, bool kExt, bool kDiff = false, bool kFreeform = false, class Row>
__device__ __forceinline__ RowHit intersect_row_of(const Row& row, const RowKinds& kd, V3 p,
                                                   V3 d, const int32_t* ffp = nullptr) {
  const auto Rw = row.rw();
  const V3 tw = row.tw();
  const V3 o = rot(V3{p.x - tw.x, p.y - tw.y, p.z - tw.z}, Rw);
  const V3 ds = rot(d, Rw);
  float t1, t2;
  bool v1, v2, linear = false;
  if (kd.plane) {
    // q = (0,0,0,-2,0): the solver's linear branch, t = 2 oz / B_safe
    const float B = -2.0f * ds.z;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    t1 = (2.0f * o.z) / B_safe;
    v1 = fabsf(B) >= kSolverEps;
    t2 = t1;
    v2 = false;
  } else {
    // geom/surfaces.py::solve_roots
    const auto q = row.q();
    const float A = q[0] * ds.x * ds.x + q[1] * ds.y * ds.y + q[2] * ds.z * ds.z;
    const float B =
        2.0f * (q[0] * o.x * ds.x + q[1] * o.y * ds.y + q[2] * o.z * ds.z) + q[3] * ds.z;
    const float C = q[0] * o.x * o.x + q[1] * o.y * o.y + q[2] * o.z * o.z + q[3] * o.z + q[4];
    const float disc = B * B - 4.0f * A * C;
    const bool hit = disc >= 0.0f;
    const float sq = sqrtf((hit ? disc : 1.0f) + 1e-24f);
    linear = fabsf(A) < kSolverEps;
    const float A_safe = linear ? 1.0f : A;
    const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
    const float t_lin = -C / B_safe;
    t1 = linear ? t_lin : (-B - sq) / (2.0f * A_safe);
    t2 = linear ? t_lin : (-B + sq) / (2.0f * A_safe);
    v1 = (linear && fabsf(B) >= kSolverEps) || (!linear && hit);
    v2 = v1;
    if constexpr (kExt) {
      bool ff_row = false;
      if constexpr (kFreeform) {
        if (ffp != nullptr) {
          ff_row = true;
          const Freeform s = freeform_of(row.q(), row.asph(), row.ff(), ffp);
          t1 = ff_refine(s, o.x, o.y, o.z, ds.x, ds.y, ds.z, t1, v1, kIntersectEps);
          // on the solver's linear path (a plane base: every example's
          // window and plate) both roots are one t with one validity, so
          // the second refinement would repeat the first bit for bit
          if (linear) {
            t2 = t1;
            v2 = v1;
          } else {
            t2 = ff_refine(s, o.x, o.y, o.z, ds.x, ds.y, ds.z, t2, v2, kIntersectEps);
          }
        }
      }
      if (!ff_row && kd.asph) {
        const Asph s = asph_of(row.q(), row.asph());
        t1 = asph_refine(s, o, ds, t1, v1);
        t2 = asph_refine(s, o, ds, t2, v2);
      }
    }
  }
  if (kd.sb != SB_NONE) {
    const auto sb = row.sb();
    bool keep1, keep2;
    sb_check2<kPlates, kDiff, kExt>(kd.sb, sb, fma3(o, t1, ds), fma3(o, t2, ds), keep1, keep2);
    if (kd.invert) {
      keep1 = !keep1;
      keep2 = !keep2;
    }
    v1 = v1 && keep1;
    v2 = v2 && keep2;
  }
  // geom/surfaces.py::min_positive with the world-scale epsilon
  const float scale = sqrtf(dot3(o, o) + dot3(p, p) + 1e-12f);
  const float eps = kIntersectEps + kRelEps * scale;
  const float tm1 = (v1 && t1 > eps) ? t1 : kBig;
  const float tm2 = (v2 && t2 > eps) ? t2 : kBig;
  const float t_best = fminf(tm1, tm2);
  RowHit h;
  h.root1 = tm1 <= tm2;
  h.root2 = tm2 <= tm1;
  h.linear = linear;
  h.valid = t_best < kBig * 0.5f;
  h.t = h.valid ? t_best : 0.0f;
  h.hs = fma3(o, h.t, ds);
  if (kd.vb != VB_NONE) {
    const V3 e = rot_t(h.hs, row.rs());
    const V3 ts = row.ts();
    const V3 he = {e.x + ts.x, e.y + ts.y, e.z + ts.z};
    if constexpr (kExt) {
      h.valid = h.valid && vb_check<kExt>(kd.vb, row.vb(), he, row.row());
    } else {
      h.valid = h.valid && vb_check<kExt>(kd.vb, row.vb(), he);
    }
  }
  return h;
}

// Intersect a ray with flat row r (K1, and the adjoints' recompute).
template <bool kPlates, bool kExt = false, bool kDiff = false, bool kFreeform = false>
__device__ __forceinline__ RowHit intersect_row(const float* r, const RowKinds& kd, V3 p, V3 d,
                                                const int32_t* ffp = nullptr) {
  return intersect_row_of<kPlates, kExt, kDiff, kFreeform>(FlatRowRef{r}, kd, p, d, ffp);
}

// World-frame unit normal at a surface-frame hit (core/intersect.py::
// normal_world).  `degen_out`, when given, receives whether the quadric's
// gradient was degenerate (the normal then defaults to +z).  With kExt an
// asphere row (`asph`) takes the sag's normal, never degenerate; with
// kFreeform a freeform row (`ffp`, its exponent pairs) its sag's.
template <bool kExt = false, bool kFreeform = false>
__device__ __forceinline__ V3 world_normal(const float* r, bool plane, V3 hs,
                                           bool* degen_out = nullptr, bool asph = false,
                                           const int32_t* ffp = nullptr) {
  const float* q = r + kQ;
  const float* Rw = r + kRw;
  if (plane) return {Rw[2], Rw[5], Rw[8]};
  if constexpr (kFreeform) {
    if (ffp != nullptr) {
      V3 nl;
      ff_normal(freeform_of(q, r + kAsph, r + kFf, ffp), hs.x, hs.y, nl.x, nl.y, nl.z);
      return rot_t(nl, Rw);
    }
  }
  if constexpr (kExt) {
    if (asph) return rot_t(asph_normal(asph_of(q, r + kAsph), hs), Rw);
  }
  const float gx = 2.0f * q[0] * hs.x;
  const float gy = 2.0f * q[1] * hs.y;
  const float gz = 2.0f * q[2] * hs.z + q[3];
  const float g2 = gx * gx + gy * gy + gz * gz;
  const bool degen = g2 < kNormalEps * kNormalEps;
  if (degen_out != nullptr) *degen_out = degen;
  const float inv = (r[kNSign] < 0.0f ? -1.0f : 1.0f) / (sqrtf(degen ? 1.0f : g2) + kNormalEps);
  const V3 nl = degen ? V3{0.0f, 0.0f, 1.0f} : V3{gx * inv, gy * inv, gz * inv};
  return rot_t(nl, Rw);
}

// The phase maps of a scene's PHASE_GRID rows, and one ray's wavelength.
struct Plates {
  const float* maps;     // every map, row-major, one after the other
  const int32_t* desc;   // per map: its offset in maps, h, w
  float wl;              // the ray's wavelength in um (not > 0: unset)
};

// The bilinear patch of a PHASE_GRID row's map at a surface-frame hit
// (core/physics.py::phase_grid_dir): the cell coordinates u, v (clipped to
// [0, n - 1 - 1e-6], that bound rounded once to float32), the cell iu, iv
// they truncate to, the four corner cells (clamped into the map) and their
// values.
struct PlatePatch {
  const float* map;
  int h, w;
  float hx, hy, u, v, fu, fv;
  bool u_clip, v_clip;  // u, v was outside its range (no derivative)
  CornerCells cells;
  Corners g;
};

__device__ __forceinline__ float cell_clip(int n) {
  return __double2float_rn(static_cast<double>(n - 1) - 1e-6);
}

__device__ __forceinline__ PlatePatch plate_patch(const float* r, const Plates& pl, int map,
                                                  V3 hs) {
  PlatePatch pt;
  const int32_t* dsc = pl.desc + 3 * map;
  pt.map = pl.maps + dsc[0];
  pt.h = dsc[1];
  pt.w = dsc[2];
  pt.hx = r[kPh + 4];
  pt.hy = r[kPh + 5];
  const float u_raw = (hs.x + pt.hx) / (2.0f * pt.hx) * static_cast<float>(pt.w - 1);
  const float v_raw = (hs.y + pt.hy) / (2.0f * pt.hy) * static_cast<float>(pt.h - 1);
  const float u_max = cell_clip(pt.w), v_max = cell_clip(pt.h);
  pt.u_clip = !(u_raw >= 0.0f && u_raw <= u_max);
  pt.v_clip = !(v_raw >= 0.0f && v_raw <= v_max);
  pt.u = fminf(fmaxf(u_raw, 0.0f), u_max);  // NaN -> 0: no index leaves the map
  pt.v = fminf(fmaxf(v_raw, 0.0f), v_max);
  const int iu = static_cast<int>(pt.u), iv = static_cast<int>(pt.v);
  pt.fu = pt.u - static_cast<float>(iu);
  pt.fv = pt.v - static_cast<float>(iv);
  pt.cells = corner_cells(pt.h, pt.w, iv, iu);
  pt.g = read_corners(pt.map, pt.cells);
  return pt;
}

// The physics branches the adjoint needs (all false unless set below).
struct PhysBranch {
  bool from_in;   // SNELL, PHASE_GRID, DOE: d.n < 0
  bool dn_pos;    // SNELL: d.n > 0
  bool tir;       // SNELL: total internal reflection
  bool n2_small;  // SNELL: |n2| < 1e-12
  bool pass;      // APERTURE: the filter passes the ray
  bool pg_ok;     // PHASE_GRID, GRATING, DOE: the order propagates
  bool u_clip;    // PHASE_GRID: u was clipped
  bool v_clip;    // PHASE_GRID: v was clipped
  bool reflect;   // FRESNEL: the draw chose reflection (u < R; always under TIR)
};

// The unpolarized Fresnel reflectance of a bare interface (core/physics.py::
// fresnel_reflectance): (Rs + Rp) / 2 with the 1e-8 in each denominator.
__device__ __forceinline__ float fresnel_R(float cos_i, float cos_t, float n1, float n2) {
  const float xs = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t + 1e-8f);
  const float xp = (n1 * cos_t - n2 * cos_i) / (n1 * cos_t + n2 * cos_i + 1e-8f);
  return 0.5f * (xs * xs + xp * xp);
}

// The stack of a coated Fresnel row (kCoat; core/static_dispatch.py::
// coated_rt_sp) for a ray arriving from the medium of index n1 into n2 at
// cos_i: the layers in reverse order when the ray meets them from the higher
// index (n1 >= n2) and there are more than one; the ray's wavelength, or the
// d line where it is unset.  `side` is the row's side-buffer row.
__device__ __forceinline__ StackIn coated_stack(const float* r, int coat, const float* side,
                                                float n1, float n2, float cos_i, float wl) {
  StackIn a;
  a.coat = r + kCoatCol;
  a.k = side + kSideK;
  a.n = coat & kCoatCountMask;
  a.rev = a.n > 1 && !(n1 < n2);
  a.absorbing = (coat & kCoatAbsorbing) != 0;
  a.metal = false;
  a.n_in = n1;
  a.n_out = n2;
  a.k_out = 0.0f;
  a.cos_i = cos_i;
  a.lam = wl > 0.0f ? wl : kDLineUm;
  return a;
}

// The stack of a metal mirror row (kCoat; core/static_dispatch.py::
// mirror_reflectances_sp): ph = (n_metal, k_metal, n_ambient), the layers
// outermost first, never reversed; a dispersive metal's (n, k) at the ray's
// wavelength on its side-buffer knots.
__device__ __forceinline__ StackIn metal_stack(const float* r, int coat, const float* side,
                                               float cos_i, float wl) {
  StackIn a;
  a.coat = r + kCoatCol;
  a.k = side + kSideK;
  a.n = coat & kCoatCountMask;
  a.rev = false;
  a.absorbing = (coat & kCoatAbsorbing) != 0;
  a.metal = true;
  a.n_in = r[kPh + 2];
  a.cos_i = cos_i;
  a.lam = wl > 0.0f ? wl : kDLineUm;
  if (coat & kCoatMetalNk) {
    metal_nk(side, a.lam, a.n_out, a.k_out);
  } else {
    a.n_out = r[kPh];
    a.k_out = r[kPh + 1];
  }
  return a;
}

// A coated Fresnel kind's or a metal mirror's stack under the field
// (kField): its kind (field.cuh::kStackNone, kStackCoated, kStackMetal),
// its inputs at the ray's incidence |d . nw| (a coated row's media by the
// side of d . nw), and one evaluation per polarization of its R, T and
// amplitudes (thin_film.cuh::stack_field), which the draw or weight and
// the field's transport share.
struct FieldStack {
  int kind;
  StackIn a;
  StackField s, p;
};

template <bool kDispersion>
__device__ __forceinline__ FieldStack field_stack(const float* r, const RowKinds& kd, V3 d, V3 nw,
                                                  float wl, const float* side) {
  FieldStack fs;
  const float dn = dot3(d, nw);
  if (kd.ph == REFLECT && (kd.coat & kCoatMetal)) {
    fs.kind = kStackMetal;
    fs.a = metal_stack(r, kd.coat, side, fabsf(dn), wl);
  } else if (field_fresnel_kind(kd.ph) && (kd.coat & kCoatCountMask) != 0) {
    float n1, n2;
    media_iors<kDispersion>(r, dn < 0.0f, kd.dispm, wl, n1, n2);
    fs.kind = kStackCoated;
    fs.a = coated_stack(r, kd.coat, side, n1, n2, fabsf(dn), wl);
  } else {
    fs.kind = kStackNone;
    return fs;
  }
  fs.s = stack_field(fs.a, false);
  fs.p = stack_field(fs.a, true);
  return fs;
}

// The Fresnel kinds' physics (kFresnel; core/static_dispatch.py::
// apply_physics_one): the refraction's geometry as SNELL takes it, then
// FRESNEL reflects where u < R (R = 1 under TIR), FRESNEL_W refracts (TIR
// reflects at full power) with imod = clip(1 - R, 0, 1), REFLECT_W reflects
// with imod = clip(R, 0, 1) (1 under TIR).  With kCoat a coated row (`coat`,
// its side-buffer row `side`) takes R (and T) from its stack; an absorbing
// stack weighs FRESNEL's transmitted branch by clip(T / max(1 - R, 1e-12),
// 0, 1) and FRESNEL_W by clip(T, 0, 1).  With kField (core/static_dispatch.py
// ::_polarized_fresnel) R (and T) are the polarized reflectance (and
// transmittance) of the ray's field *e: a bare interface's (field.cuh::
// polarized_r) or, with kCoat, a coated one's (polarized_rt of its stack's
// Rs, Rp, Ts, Tp, evaluated by the caller: *fs).
template <bool kDispersion, bool kCoat = false, bool kField = false>
__device__ __forceinline__ void fresnel_physics(const float* r, int ph, V3 d, V3 nw, float wl,
                                                int dispm, float u, V3& nd, float& imod,
                                                PhysBranch* br, int coat = 0,
                                                const float* side = nullptr,
                                                const Fld* e = nullptr,
                                                const FieldStack* fs = nullptr) {
  const float dn = dot3(d, nw);
  const bool from_in = dn < 0.0f;
  const float eff_sign = from_in ? 1.0f : -1.0f;
  const float cos_i = fabsf(dn);
  float n1, n2;
  media_iors<kDispersion>(r, from_in, dispm, wl, n1, n2);
  const bool n2_small = fabsf(n2) < 1e-12f;
  const float mu = n1 / (n2_small ? 1e-12f : n2);
  const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
  const bool tir = sin2_t > 1.0f;
  const float cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
  float R, T = 0.0f;
  if constexpr (kField) {
    const SpBasis b = sp_basis(F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z});
    if (kCoat && fs->kind == kStackCoated) {
      const PolRT w = polarized_rt(*e, b, fs->s.R, fs->p.R, fs->s.T, fs->p.T);
      R = w.R;
      T = w.T;
    } else {
      R = polarized_r(*e, b, cos_i, cos_t, n1, n2).R;
    }
  } else if (kCoat && (coat & kCoatCountMask) != 0) {
    const StackRT rt = stack_rt_unpolarized(coated_stack(r, coat, side, n1, n2, cos_i, wl));
    R = rt.R;
    T = rt.T;
  } else {
    R = fresnel_R(cos_i, cos_t, n1, n2);
  }
  const bool reflect = ph == REFLECT_W || tir || (ph == FRESNEL && u < R);
  if (reflect) {
    nd = fma3(d, -2.0f * dn, nw);
  } else {
    const float coef = (mu * cos_i - cos_t) * eff_sign;
    nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
  }
  imod = ph == FRESNEL || tir ? 1.0f : fminf(fmaxf(ph == FRESNEL_W ? 1.0f - R : R, 0.0f), 1.0f);
  if (kCoat && (coat & kCoatAbsorbing) && !tir) {
    if (ph == FRESNEL_W) imod = fminf(fmaxf(T, 0.0f), 1.0f);
    if (ph == FRESNEL && !reflect) imod = fminf(fmaxf(T / fmaxf(1.0f - R, 1e-12f), 0.0f), 1.0f);
  }
  if (br != nullptr) {
    br->from_in = from_in;
    br->dn_pos = dn > 0.0f;
    br->tir = tir;
    br->n2_small = n2_small;
    br->reflect = ph == FRESNEL && reflect;
  }
}

// What a row's field transport reads (field.cuh::FieldRow): the incoming
// direction d, the new one nd, the normal nw, the media by the side of
// d . nw (the transport kinds of field.cuh's Fresnel branch), the row's
// factor imod (after a fuzzy program's), a JONES row's angle,
// amplitudes, retardance at the ray's wavelength wl (its static bits in
// kd.coat: field.cuh::jones_delta) and Rw columns 0 and 1, and a coated
// Fresnel kind's or a metal mirror's stack amplitudes (field_stack's fs).
template <bool kDispersion>
__device__ __forceinline__ FieldRow field_row(const float* r, const RowKinds& kd, V3 d, V3 nd,
                                              V3 nw, float imod, float wl, const FieldStack& fs) {
  FieldRow fr;
  fr.ph = kd.ph;
  fr.d = F3{d.x, d.y, d.z};
  fr.nd = F3{nd.x, nd.y, nd.z};
  fr.nw = F3{nw.x, nw.y, nw.z};
  fr.imod = imod;
  fr.n1 = 1.0f;
  fr.n2 = 1.0f;
  fr.theta = fr.a1 = fr.a2 = fr.delta = 0.0f;
  fr.xw = fr.yw = F3{0.0f, 0.0f, 0.0f};
  if (field_fresnel_kind(kd.ph))
    media_iors<kDispersion>(r, dot3(d, nw) < 0.0f, kd.dispm, wl, fr.n1, fr.n2);
  fr.stack = fs.kind;
  if (fs.kind != kStackNone) {
    fr.ts = fs.s.t;
    fr.rs = fs.s.r;
    fr.tp = fs.p.t;
    fr.rp = fs.p.r;
  }
  if (kd.ph == JONES) {
    fr.theta = r[kPh];
    fr.a1 = r[kPh + 1];
    fr.a2 = r[kPh + 2];
    fr.delta = jones_delta(kd.coat, r[kPh + 3], r[kPh + 4], wl);
    fr.xw = F3{r[kRw], r[kRw + 3], r[kRw + 6]};
    fr.yw = F3{r[kRw + 1], r[kRw + 4], r[kRw + 7]};
  }
  return fr;
}

// The diffractive and ideal kinds' physics (kDiff; core/static_dispatch.py::
// apply_physics_one): LINEAR, GRATING, MLA and DOE map the direction in the
// row's surface frame (diffractive.cuh) at the surface-frame hit hs; GRATING
// and DOE read the ray's wavelength wl, and an evanescent order has imod =
// 0; a DOE row (`doe`: its term count and efficiency flag, doe_of) kicks
// between the side-aware media of media_iors (its from_in the side of d .
// nw) and with its efficiency weighs by kinoform_eff.
template <bool kDispersion>
__device__ __forceinline__ void diffractive_physics(const float* r, int ph, V3 d, V3 nw, V3 hs,
                                                    float wl, int dispm, int doe, V3& nd,
                                                    float& imod, PhysBranch* br) {
  const float* Rw = r + kRw;
  const V3 dv = rot(d, Rw);
  const Loc dl = {dv.x, dv.y, dv.z};
  Loc ol;
  bool ok = true;
  if (ph == LINEAR) {
    ol = linear_local(dl, hs.x, hs.y, r + kPh + 2);
  } else if (ph == MLA) {
    ol = mla_local(dl, hs.x, hs.y, r[kPh], r[kPh + 1]);
  } else if (ph == GRATING) {
    ol = grating_local(dl, r[kPh + 2], r[kPh + 3], r[kPh + 4], wl, ok);
  } else {
    const bool from_in = dot3(d, nw) < 0.0f;
    float n1, n2;
    media_iors<kDispersion>(r, from_in, dispm, wl, n1, n2);
    ol = doe_local(dl, hs.x, hs.y, r + kFf, doe & kDoeTermsMask, r[kPh + 2], r[kPh + 3], wl, n1,
                   n2, ok);
    if (br != nullptr) br->from_in = from_in;
  }
  nd = rot_t(V3{ol.x, ol.y, ol.z}, Rw);
  imod = ok ? 1.0f : 0.0f;
  if (ph == DOE && (doe & kDoeEfficiency) && ok) imod = kinoform_eff(r[kPh + 2], r[kPh + 3], wl);
  if (br != nullptr) br->pg_ok = ok;
}

// The row's physics (core/static_dispatch.py::apply_physics_one): the new
// direction nd and the intensity factor imod of a ray d meeting normal nw at
// surface-frame hit hs.  `br`, when given, receives the branches taken.  A
// PHASE_GRID row (kPlates only) reads map kd_map of `pl`; a dispersive row
// (kDispersion only: `dispm`) refracts at the indices of the ray's wavelength
// pl.wl; the Fresnel kinds (kFresnel only) take fresnel_physics, FRESNEL
// with the ray's uniform u.  With kCoat (which has kFresnel) a coated row's
// stack (`coat`, the row's kinds; `side`, its side-buffer row) gives the
// Fresnel kinds' R, and a metal REFLECT row reflects with imod =
// (Rs + Rp) / 2 of its metal under its stack.  With kDiff (which has
// kCoat) the diffractive and ideal kinds take diffractive_physics (a DOE
// row's data above `coat`'s bits), and an APERTURE row's re-check takes the
// ELLIPSE bound.
template <bool kPlates, bool kExt = false, bool kDispersion = kExt, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false>
__device__ __forceinline__ void apply_physics(const float* r, int ph, int sbk, int kd_map, V3 d,
                                              V3 nw, V3 hs, const Plates& pl, V3& nd, float& imod,
                                              PhysBranch* br = nullptr, int dispm = 0,
                                              float u = 0.0f, int coat = 0,
                                              const float* side = nullptr) {
  nd = d;
  imod = 1.0f;
  if (kPlates && ph == PHASE_GRID) {
    // core/physics.py::phase_grid_dir: n2 d_out_t = n1 d_in_t + m lam grad(phi)
    const bool from_in = dot3(d, nw) < 0.0f;
    float n1, n2;
    media_iors<kDispersion>(r, from_in, dispm, pl.wl, n1, n2);
    const float* Rw = r + kRw;
    const V3 dl = rot(d, Rw);
    const float lam_mm = (pl.wl > 0.0f ? pl.wl : r[kPh + 3]) * 1e-3f;
    const PlatePatch pt = plate_patch(r, pl, kd_map, hs);
    const float su = static_cast<float>(pt.w - 1) / (2.0f * pt.hx);
    const float sv = static_cast<float>(pt.h - 1) / (2.0f * pt.hy);
    const float gx =
        ((1.0f - pt.fv) * (pt.g.g01 - pt.g.g00) + pt.fv * (pt.g.g11 - pt.g.g10)) * su;
    const float gy =
        ((1.0f - pt.fu) * (pt.g.g10 - pt.g.g00) + pt.fu * (pt.g.g11 - pt.g.g01)) * sv;
    const float kick = r[kPh + 2] * lam_mm;
    const float tx = n1 * dl.x + kick * gx;
    const float ty = n1 * dl.y + kick * gy;
    const float t2 = tx * tx + ty * ty;
    const float n2sq = n2 * n2;
    const bool ok = t2 < n2sq;
    const float tz = sqrtf(ok ? fmaxf(n2sq - t2, 0.0f) : 1.0f);
    const float zs = fabsf(dl.z) < 1e-12f ? 1.0f : dl.z;
    const float sign = zs > 0.0f ? 1.0f : (zs < 0.0f ? -1.0f : zs);
    const float inv = 1.0f / n2;
    nd = rot_t(V3{tx * inv, ty * inv, ok ? tz * sign * inv : dl.z}, Rw);
    imod = ok ? 1.0f : 0.0f;
    if (br != nullptr) {
      br->from_in = from_in;
      br->pg_ok = ok;
      br->u_clip = pt.u_clip;
      br->v_clip = pt.v_clip;
    }
  } else if (ph == BLOCK) {
    nd = {0.0f, 0.0f, 0.0f};
    imod = 0.0f;
  } else if (ph == REFLECT) {
    nd = fma3(d, -2.0f * dot3(d, nw), nw);
    if constexpr (kCoat) {
      if (coat & kCoatMetal)
        imod = stack_rt_unpolarized(metal_stack(r, coat, side, fabsf(dot3(d, nw)), pl.wl)).R;
    }
  } else if (ph == SNELL) {
    const float dn = dot3(d, nw);
    const bool from_in = dn < 0.0f;
    const float eff_sign = from_in ? 1.0f : -1.0f;
    const float cos_i = fabsf(dn);
    float n1, n2;
    media_iors<kDispersion>(r, from_in, dispm, pl.wl, n1, n2);
    const bool n2_small = fabsf(n2) < 1e-12f;
    const float mu = n1 / (n2_small ? 1e-12f : n2);
    const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
    if (br != nullptr) {
      br->from_in = from_in;
      br->dn_pos = dn > 0.0f;
      br->tir = sin2_t > 1.0f;
      br->n2_small = n2_small;
    }
    if (sin2_t > 1.0f) {  // total internal reflection
      nd = fma3(d, -2.0f * dn, nw);
    } else {
      const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
      const float coef = (mu * cos_i - cos_t) * eff_sign;
      nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
    }
  } else if (ph == APERTURE) {
    // the filter re-checks its own RAW (non-inverted) bound
    const float mod = sb_check<kPlates, kDiff, kExt>(sbk, r + kSb, hs) ? 1.0f : 0.0f;
    nd = {d.x * mod, d.y * mod, d.z * mod};
    imod = mod;
    if (br != nullptr) br->pass = mod != 0.0f;
  } else if (kFresnel && (ph == FRESNEL || ph == FRESNEL_W || ph == REFLECT_W)) {
    fresnel_physics<kDispersion, kCoat>(r, ph, d, nw, pl.wl, dispm, u, nd, imod, br, coat, side);
  } else if (kDiff && (ph == LINEAR || ph == GRATING || ph == MLA || ph == DOE)) {
    diffractive_physics<kDispersion>(r, ph, d, nw, hs, pl.wl, dispm, doe_of(coat), nd, imod, br);
  }
}

// A row's physics under the field (kField): a coated Fresnel kind's or a
// metal mirror's stack is evaluated once (field_stack, into fs, which the
// transport reads too); the Fresnel kinds, bare or coated, by
// fresnel_physics with the field, a metal mirror reflects with the
// polarized R of its stack's Rs and Rp (core/static_dispatch.py::
// apply_physics_one), every other kind by apply_physics (a JONES row falls
// through it: nd = d, imod = 1).
template <bool kDispersion, bool kDiff>
__device__ __forceinline__ void field_physics(const float* r, const RowKinds& kd, V3 d, V3 nw,
                                              V3 hs, const Plates& pl, float u, const Fld& e,
                                              const float* side, V3& nd, float& imod,
                                              PhysBranch* br, FieldStack& fs) {
  fs = field_stack<kDispersion>(r, kd, d, nw, pl.wl, side);
  if (kd.ph == FRESNEL || kd.ph == FRESNEL_W || kd.ph == REFLECT_W) {
    fresnel_physics<kDispersion, true, true>(r, kd.ph, d, nw, pl.wl, kd.dispm, u, nd, imod, br,
                                             kd.coat, side, &e, &fs);
  } else if (fs.kind == kStackMetal) {
    nd = fma3(d, -2.0f * dot3(d, nw), nw);
    imod = polarized_rt(e, sp_basis(F3{d.x, d.y, d.z}, F3{nw.x, nw.y, nw.z}), fs.s.R, fs.p.R,
                        0.0f, 0.0f)
               .R;
  } else
    apply_physics<true, true, kDispersion, true, true, kDiff>(
        r, kd.ph, kd.sb, kd.map, d, nw, hs, pl, nd, imod, br, kd.dispm, u, kd.coat, side);
}

// A non-sequential winner's physics and transport under the field (kField,
// K5's and K6's): field_physics (with kDiff the diffractive kinds), the
// winner's fuzzy factor `fz` (1 without a program) times its factor, then
// field_transport of the field *e into itself, so the transport sees the
// apodized factor as K1's does.  Out of line, so that K5 and K6's replay run
// one compiled body and the replay reaches K5's field bit for bit: inlined,
// the two kernels contracted the transport's multiply-adds apart (its rays
// agreed, its field did not).
template <bool kDispersion, bool kDiff, bool kFuzzy>
__device__ __noinline__ void field_winner(const float* r, const RowKinds& kd, V3 d, V3 nw, V3 hs,
                                          const Plates& pl, float u, const float* side, float fz,
                                          V3& nd, float& imod, PhysBranch* br, Fld& e) {
  FieldStack fst;
  field_physics<kDispersion, kDiff>(r, kd, d, nw, hs, pl, u, e, side, nd, imod, br, fst);
  if constexpr (kFuzzy) imod = imod * fz;
  e = field_transport(field_row<kDispersion>(r, kd, d, nd, nw, imod, pl.wl, fst), e);
}

// The index of the medium a ray travels in after an active row
// (core/static_dispatch.py::medium_after): a SNELL (or FRESNEL_W) row moves
// it into the transmission-side medium unless total internal reflection
// keeps it in the incidence medium, a FRESNEL row unless its draw reflected
// it (`reflect`), a PHASE_GRID (or, with kDiff, a DOE) row always transmits;
// every other row leaves n_cur.  from_in, tir and reflect are the physics'
// own decisions (PhysBranch, or the adjoint's saved bits), the indices
// media_iors's.
template <bool kDispersion, bool kFresnel = false, bool kDiff = false>
__device__ __forceinline__ float medium_after(const float* r, const RowKinds& kd, bool from_in,
                                              bool tir, float wl, float n_cur,
                                              bool reflect = false) {
  if constexpr (kDiff) {
    if (kd.ph == DOE) {
      float n1, n2;
      media_iors<kDispersion>(r, from_in, kd.dispm, wl, n1, n2);
      return n2;
    }
  }
  if constexpr (kFresnel) {
    const bool snell_like = kd.ph == SNELL || kd.ph == FRESNEL_W;
    if (!snell_like && kd.ph != FRESNEL && kd.ph != PHASE_GRID) return n_cur;
    float n1, n2;
    media_iors<kDispersion>(r, from_in, kd.dispm, wl, n1, n2);
    return (snell_like && tir) || (kd.ph == FRESNEL && reflect) ? n1 : n2;
  } else {
    if (kd.ph != SNELL && kd.ph != PHASE_GRID) return n_cur;
    float n1, n2;
    media_iors<kDispersion>(r, from_in, kd.dispm, wl, n1, n2);
    return kd.ph == SNELL && tir ? n1 : n2;
  }
}

// A ray's field as grin.cuh carries it, and back.
__device__ __forceinline__ GrinFld grin_fld(const Fld& e) {
  return {{e.r.x, e.r.y, e.r.z}, {e.i.x, e.i.y, e.i.z}};
}
__device__ __forceinline__ Fld fld_of(const GrinFld& e) {
  return {{e.r.x, e.r.y, e.r.z}, {e.i.x, e.i.y, e.i.z}};
}

// A GRIN rod's run from its entry-plane hit hs (grin.cuh::grin_rod), with
// kField (fe not null) carrying the ray's field *fe through it
// (grin_rod_field).
template <bool kField>
__device__ __forceinline__ GrinExit grin_run(const float* r, int steps, V3 d, V3 hs, Fld* fe) {
  if constexpr (kField) {
    GrinFld e = grin_fld(*fe);
    const GrinExit ge = grin_rod_field(r, steps, d.x, d.y, d.z, hs.x, hs.y, e);
    *fe = fld_of(e);
    return ge;
  } else {
    return grin_rod(r, steps, d.x, d.y, d.z, hs.x, hs.y);
  }
}

// A GRIN row of K1's chain (and of K2's forward sweep, kGrin): the entry
// plane's hit, and where the row is active (valid, intensity > 0, the ray
// travelling +z in the rod's frame: grin_fwd) the whole rod (grin.cuh::
// grin_rod): the ray lands at the exit face with its intensity times 1 or 0
// (dead), with kField its field *fe carried through the rod.  Returns
// whether the row was active; `ge` and `t` receive the rod's exit and the
// entry plane's ray parameter.
template <bool kPlates, bool kField = false>
__device__ __forceinline__ bool grin_row(const float* r, const RowKinds& kd, V3& p, V3& d,
                                         float& inten, GrinExit& ge, float& t,
                                         Fld* fe = nullptr) {
  const RowHit h = intersect_row<kPlates, true>(r, kd, p, d);
  t = h.t;
  if (!(h.valid && inten > 0.0f && grin_fwd(r, d.x, d.y, d.z))) return false;
  ge = grin_run<kField>(r, kd.map, d, h.hs, fe);
  p = {ge.p.x, ge.p.y, ge.p.z};
  d = {ge.d.x, ge.d.y, ge.d.z};
  if (!(ge.bits & kGrinAlive)) inten = 0.0f;
  return true;
}

// The stream outputs of K1's and K5's instantiation with the streams, each
// null when not wanted: the optical path length and the final medium's
// index (n floats each); the positions (K1: the launch position, then after
// each of the K rows, [K + 1][3][n]; K5: after each bounce of the budget,
// [B][3][n]); the hits ([K or B][3][n]), their weights ([K or B][n]) and
// (K5) the sensor slots ([B][n] int32).  Planar, so that a warp's stores
// coalesce; the wrappers return permuted views in the JAX package's shapes.
struct StreamOut {
  float* opl;
  float* n_final;
  float* paths;
  float* hits;
  float* hit_w;
  int32_t* hit_slot;
};

// A bounce's sensor record (core/trace.py::bounce_step): the local hit and
// slot of the last sensor row that was the nearest so far when the scan met
// it (a nearer non-sensor winner later zeroes only the weight), or zeros.
struct SensorRec {
  V3 hs;
  int slot;
};

// One bounce of the non-sequential loop (core/trace.py::bounce_step), as K5
// runs it and K6 replays it: every row is intersected, from its packed
// record `recs`, and the nearest valid row wins with a strict t < best_t
// (the first of equals wins); then the winner's normal and physics, from
// its flat row in `tab` and its kinds row in `knd`, and the move p += t d,
// d = the new direction, I *= the winner's factor.  Returns the winner row,
// or -1 when no row wins (nothing moves).  `hw` receives the winner's hit
// and `kw` its kinds; `degen` and `br`, when given, the winner's branches.
// The caller records a sensor winner.  Only the winner reads its phase map.
// With kRecord (the instantiation with the streams, which has kExt) `rec`
// receives the bounce's sensor record.  With kFresnel (which has kRecord) a
// FRESNEL winner draws philox_uniform at `rd`'s counter and its own row.
// The extended kinds' instantiation (kExt) scans the flat rows and their
// kinds rows instead: its kinds need fields (the asphere's terms, all 8 of
// a volume bound's) that the packed record does not hold.  With kCoat
// (which has kFresnel) a coated or metal winner reads its side-buffer row
// of `cside` ([K][kCoatSide]); with kDiff (which has kCoat) the scan takes
// the ELLIPSE bound and the winner the diffractive kinds; with kFuzzy (which
// has kDiff) a winner with a fuzzy program in `fz` (fuzzy.cuh) multiplies
// its factor by the program's value at its surface-frame hit; with
// kFreeform (which has kFuzzy) the freeform rows of the side buffer `ffs`
// ([K][kFfSide]) intersect and take their normals as freeform surfaces.
// A null `fz` or `ffs` (a table without that family) skips its code.
// With kField (which has kCoat) the winner's physics sees the ray's field
// *fe (field_physics) and the winner transports it (field_winner), so that
// K6's replay reaches K5's field.  With kGrin (which has kExt) a GRIN row's
// entry face wins only a ray travelling +z in its frame (grin_fwd), and a
// GRIN winner runs its whole rod (grin.cuh::grin_rod, out of line, so that
// K6's replay reaches K5's state; with kField grin_rod_field, its field
// too): the ray lands at the exit face, and `ge` receives the rod's exit
// (its in-medium path and bits).
template <bool kPlates, bool kExt = false, bool kDispersion = kExt, bool kRecord = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false, bool kField = false, bool kGrin = false>
__device__ __forceinline__ int nonseq_bounce(const float4* recs, const float* tab,
                                             const int32_t* knd, int n_rows, const Plates& pl,
                                             V3& p, V3& d, float& inten, RowHit& hw,
                                             RowKinds& kw, bool* degen = nullptr,
                                             PhysBranch* br = nullptr, SensorRec* rec = nullptr,
                                             const RayDraw* rd = nullptr,
                                             const float* cside = nullptr,
                                             const int32_t* fz = nullptr,
                                             const int32_t* ffs = nullptr, Fld* fe = nullptr,
                                             GrinExit* ge = nullptr) {
  static_assert(kExt || !kRecord, "the records read the kinds rows of the flat scan");
  static_assert(kExt || !kFresnel, "the Fresnel kinds read the kinds rows of the flat scan");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(!kField || kCoat, "the field runs with the coatings");
  static_assert(!kGrin || kExt, "GRIN rods read the kinds rows of the flat scan");
  float best_t = kBig;
  int k_win = -1;
  if constexpr (kRecord) *rec = SensorRec{V3{0.0f, 0.0f, 0.0f}, 0};
  for (int k = 0; k < n_rows; ++k) {
    RowHit h;
    if constexpr (kExt) {
      const RowKinds kk = read_row_kinds<kExt>(knd + k * kKindWidth);
      h = intersect_row<kPlates, kExt, kDiff, kFreeform>(
          tab + k * kRowWidth, kk, p, d, kFreeform && ffs != nullptr ? ff_row_of(ffs, k) : nullptr);
      if constexpr (kGrin) {
        // a backward ray never couples into a rod: its hit is a miss
        if (kk.ph == GRIN && !grin_fwd(tab + k * kRowWidth, d.x, d.y, d.z)) h.valid = false;
      }
      if constexpr (kRecord) {
        if (h.valid && h.t < best_t && kk.sensor) *rec = SensorRec{h.hs, kk.slot};
      }
    } else {
      const RecRow row = {recs + k * kRec4};
      h = intersect_row_of<kPlates, kExt>(row, row.scan_kinds(), p, d);
    }
    if (h.valid && h.t < best_t) {
      best_t = h.t;
      k_win = k;
      hw = h;
    }
  }
  if (k_win < 0) return -1;
  const float* r = tab + k_win * kRowWidth;
  kw = read_row_kinds<kExt, kDispersion, kCoat>(knd + k_win * kKindWidth);
  if constexpr (kGrin) {
    if (kw.ph == GRIN) {
      *ge = grin_run<kField>(r, kw.map, d, hw.hs, fe);
      p = {ge->p.x, ge->p.y, ge->p.z};
      d = {ge->d.x, ge->d.y, ge->d.z};
      if (!(ge->bits & kGrinAlive)) inten = 0.0f;
      return k_win;
    }
  }
  V3 nd;
  float imod;
  if constexpr (kField) {
    const float u = kw.ph == FRESNEL
                        ? philox_uniform(rd->key, rd->ray, rd->bounce, static_cast<uint32_t>(k_win))
                        : 0.0f;
    const float fzw =
        kFuzzy && fz != nullptr ? fuzzy_factor(fz, k_win, hw.hs.x, hw.hs.y, hw.hs.z) : 1.0f;
    const int32_t* ffp = kFreeform && ffs != nullptr ? ff_row_of(ffs, k_win) : nullptr;
    field_winner<kDispersion, kDiff, kFuzzy>(
        r, kw, d, world_normal<kExt, kFreeform>(r, kw.plane, hw.hs, degen, kw.asph, ffp), hw.hs,
        pl, u, cside + k_win * kCoatSide, fzw, nd, imod, br, *fe);
  } else if constexpr (kFreeform) {
    const float u = kw.ph == FRESNEL
                        ? philox_uniform(rd->key, rd->ray, rd->bounce, static_cast<uint32_t>(k_win))
                        : 0.0f;
    apply_physics<kPlates, kExt, kDispersion, true, true, kDiff>(
        r, kw.ph, kw.sb, kw.map, d,
        world_normal<kExt, true>(r, kw.plane, hw.hs, degen, kw.asph,
                                 ffs != nullptr ? ff_row_of(ffs, k_win) : nullptr),
        hw.hs, pl, nd, imod, br, kw.dispm, u, kw.coat, cside + k_win * kCoatSide);
  } else if constexpr (kCoat) {
    const float u = kw.ph == FRESNEL
                        ? philox_uniform(rd->key, rd->ray, rd->bounce, static_cast<uint32_t>(k_win))
                        : 0.0f;
    apply_physics<kPlates, kExt, kDispersion, true, true, kDiff>(
        r, kw.ph, kw.sb, kw.map, d, world_normal<kExt>(r, kw.plane, hw.hs, degen, kw.asph), hw.hs,
        pl, nd, imod, br, kw.dispm, u, kw.coat, cside + k_win * kCoatSide);
  } else if constexpr (kFresnel) {
    const float u = kw.ph == FRESNEL
                        ? philox_uniform(rd->key, rd->ray, rd->bounce, static_cast<uint32_t>(k_win))
                        : 0.0f;
    apply_physics<kPlates, kExt, kDispersion, true>(
        r, kw.ph, kw.sb, kw.map, d, world_normal<kExt>(r, kw.plane, hw.hs, degen, kw.asph), hw.hs,
        pl, nd, imod, br, kw.dispm, u);
  } else {
    apply_physics<kPlates, kExt, kDispersion>(r, kw.ph, kw.sb, kw.map, d,
                                 world_normal<kExt>(r, kw.plane, hw.hs, degen, kw.asph), hw.hs, pl,
                                 nd, imod, br, kw.dispm);
  }
  if constexpr (kFuzzy && !kField) {
    if (fz != nullptr) imod = imod * fuzzy_factor(fz, k_win, hw.hs.x, hw.hs.y, hw.hs.z);
  }
  p = fma3(p, best_t, d);
  d = nd;
  inten = inten * imod;
  return k_win;
}

}  // namespace rtt
