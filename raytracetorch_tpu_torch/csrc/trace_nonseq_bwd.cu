// Fused non-sequential backward trace for Hopper (sm_90a): kernel K6, the
// hand-written adjoint of the bounce loop K5 (trace_nonseq_fwd.cu).
//
// Replaces the TPU kernels raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_nonseq_bwd_scan (mode='scan', the default) and _kernel_nonseq_bwd
// (mode='unrolled'), both launched by trace_nonseq_pallas_bwd and joined to
// the forward by the custom_vjp fused_nonseq_grad.  The two compute the same
// vector-Jacobian product (tests/test_pallas.py::
// test_nonseq_bwd_scan_matches_unrolled holds them equal), so this one kernel
// is the counterpart of both, for K5's kinds (pixelated phase plates and the
// extended kinds included), the optical path length, the Fresnel kinds
// with their draws, thin-film coatings and metal mirrors, the diffractive
// and ideal elements, component-style fuzzy apodization (the TPU kernel's
// fuzzy_fns, :2292), freeform surfaces, the solids' and cones' bounds
// (HALFSPACES, CONE_NAPPE: decisions without a cotangent, which the replay
// takes through K5's nonseq_bounce) and the polarized field (g_field),
// with every other optional stream off.
// Its plain PyTorch version is ops/fused_nonseq.py::trace_nonseq_bwd_plain
// (autograd of the eager bounce loop), and the wrapper that launches it is
// ops/fused_nonseq.py::trace_nonseq_bwd_cuda.
//
// What it computes: given the table, the input rays, the cotangents of the 7
// output ray streams, of the [S, B, 7] moments and (with a grid) of the
// [S, H, W] grid, the cotangents of the 7 input ray streams and of the
// table, and with phase plates those of their maps (the TPU kernel's
// ct['grids']): a PHASE_GRID winner's adjoint adds its four corner
// cotangents into the maps' cotangent by atomicAdd (kernel K4's scatter,
// grid_corners.cuh), bounce after bounce, as the TPU scan kernel
// accumulates its per-bounce map cotangent.  Per ray the forward is a loop
// of bounces whose length differs per ray; each bounce is one table row (its
// winner) applied as K2 applies a row, so the reverse of a bounce is K2's
// row adjoint (trace_seq_adjoint.cuh).
//
// Design: one thread per ray, 256 threads per block.  The flat [K, 160]
// table, the int32 [K, 8] kinds and the moment cotangent sit in shared
// memory.
// - Forward replay: K5's loop with the same per-ray exit (intensity not > 0,
//   or no row wins), through the same device function (nonseq_bounce,
//   trace_seq_common.cuh, reading the same packed scan records, built in
//   shared memory as K5 builds them), so it reaches K5's state bit for bit
//   and picks K5's winners; each live bounce keeps its
//   input state (7 floats), its winner row and the winner's branch bits,
//   which come from the very calls that moved the ray (the optional outputs
//   of intersect_row, world_normal and apply_physics).  The wrapper can ask
//   for the state the replay ends at; chip_smoke.py holds it to K5's output.
// - Checkpoints: the TPU kernel keeps every bounce's state in VMEM scratch
//   sized by the budget.  A thread here keeps up to kCkpt = 13 bounces
//   (input state, winner row and bits: trace_seq_adjoint.cuh::put_state)
//   in shared memory, [bounce][word][thread], 8 KB a bounce for a block,
//   min(budget, 13) of them; nothing of size budget x N is allocated (7
//   floats x 100 bounces x 1M rays would be 2.8 GB), and no register holds
//   them, so the bounce loops need not unroll and the kernel keeps one copy
//   of the bounce and of the adjoint.  The naive scene (budget 8, 4 winning
//   bounces) and the plates (3) never run out.  A ray that lives longer
//   than 13 bounces (the two-mirror cavity, 25) is reversed in segments of
//   13, the last first: the first replay leaves the last segment in the
//   checkpoints (bounce b in slot b % 13); for each earlier segment the
//   thread replays from its start to the segment's first bounce and saves
//   the segment.  The replay runs the same code on the same inputs, so it
//   reaches the same states bit for bit.  The cost is a replay of
//   about L^2 / (2 * 13) bounces for a ray that lives L bounces.
// - Occupancy: __launch_bounds__(256, 2) caps the instantiation without
//   plate code at 128 registers, so two blocks (16 warps) share an SM
//   (trace_seq_adjoint.cuh::kBwdMinBlocks).
// - Reverse sweep, last live bounce to first: K2's row adjoint of the
//   winner with its saved bits.  A sensor winner adds the moment adjoint
//   with the constant g_moments[slot, bundle] at its hit, weighted by the
//   incoming intensity (only for 0 <= ray_id < B, as K5 counts), and the
//   grid's cotangent g_grid[slot, iy, ix] to the incoming intensity's (the
//   gather of the TPU kernel's _grid_partial_g_bwd, exact in float32).
//   Bounces after a ray settled have an identity adjoint and add nothing, so
//   skipping them is exact.
// - Table cotangent: each ray adds to the row it won at each bounce, and the
//   rays of a warp win different rows.  The reverse loop runs warp-uniform,
//   to the warp's largest live bounce count (lanes past their own count add
//   zeros), and per bounce the warp reduces one row at a time for each
//   distinct winner among its lanes (a ballot picks them; K2's transpose
//   reduce-scatter, trace_seq_adjoint.cuh::reduce_row) into a [K, 19] slot
//   in shared memory that only this warp writes.  At the end a fixed-order
//   sum over the warps writes a [blocks, K, 19] buffer that the wrapper sums
//   and scatters into [K, 160].  No atomics: deterministic.
//   The cotangent is nonzero only in K2's 19 columns (q, Rw, tw, ph), 23
//   with phase plates, 27 with the extended kinds (asph).  A scene with
//   neither a plate nor a RECT bound runs the instantiation without plate
//   code (kPlates = false); a scene with the extended kinds (the caller's
//   `ext`) the one with plate code and kExt, whose replay is K5's of the
//   same kinds (the scan over the flat rows) and whose adjoint is K2's.
//   There a dispersive winner adds its 12 disp columns (reduced per distinct
//   dispersive winner after the 27 others; only when the caller says the
//   table has such a row, `disp`, which takes 12 more columns a row of shared
//   memory) and the ray's wavelength its cotangent.  Like K2's, that code sits
//   in a fourth instantiation (kDispersion), an overload of the kernel with
//   one more argument (WaveOut), so the other three keep their parameters and
//   their code; all four run one body, nonseq_bwd.
// - The optical path length (K5's track_opl): a fifth instantiation, kOpl,
//   built on the fourth (an overload with OplIn: the cotangents of K5's opl
//   and n_final).  Its replays carry the medium's index (medium_after of
//   each winner, as K5's instantiation with the streams takes it), each
//   checkpoint keeps the one before its bounce as a ninth word (the state
//   grows from 8 to 9 words: 9 KB a bounce for a block; opl itself needs no
//   word, its cotangent being the same at every bounce), and the reverse
//   sweep runs K2's path-length adjoint of the winner.
//
// - The families of kinds (the Fresnel kinds, coatings and metal mirrors,
//   the diffractive and ideal elements, fuzzy apodization, freeform
//   surfaces, GRIN rods): one more instantiation, the family
//   instantiation, built on the fifth (an overload with one more argument,
//   FamSide: K5's side data and the runtime word `fam` of the families the
//   table has, trace_seq_common.cuh), so that the others keep their code.
//   It compiles every family together, so a scene may mix them; a family
//   the table lacks skips its block setup and its columns (a table that
//   one of the chain's links took runs that link's instantiation,
//   trace_seq_common.cuh::fam_link, as K1 does, but for GRIN rods alone,
//   which run the family instantiation, as K5).  Its replays
//   run K5's bounce with every family (nonseq_bounce), so they reach K5's
//   state bit for bit.  Per family:
//   - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W).  The TPU scan
//     kernel replays its in-kernel draws by reseeding per tile and bounce
//     (_kernel_nonseq_bwd_scan :2227-2246); here a FRESNEL winner's draw is
//     philox_uniform of (ray, bounce, row) under FamSide::key, so the
//     first replay and every segment replay recompute K5's very draws from
//     their counters, and nothing is stored.  The drawn branch is a saved
//     bit (kReflect), and the reverse sweep runs K2's Fresnel adjoints
//     (trace_seq_adjoint.cuh).
//   - Thin-film coatings and metal mirrors: the rows' [K][20] side buffer
//     sits in shared memory after the moment cotangent.  Replays and the
//     reverse sweep take a coated or metal winner's weight through its
//     stack (thin_film.cuh, recomputed: the checkpoints keep their words),
//     and a winner's 8 coat-thickness columns are reduced after its disp
//     columns.
//   - The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA
//     rows, the ELLIPSE bound): the reverse sweep runs
//     diffractive_backward (trace_seq_adjoint.cuh) and reduces a DOE
//     winner's 8 ff columns after the coat columns.
//   - Fuzzy apodization (the traced programs' int32 buffer, in shared
//     memory after the side buffer): the reverse sweep re-runs a fuzzy
//     winner's program at the replayed hit with forward-mode partials
//     (fuzzy.cuh) and adds g I imod dw/d(hit) to the hit's cotangent
//     (row_backward).
//   - Freeform surfaces (the rows' exponent pairs, in shared memory after
//     the programs): the reverse sweep reverses a freeform winner's normal
//     and 8 Newton steps (freeform.cuh, through row_backward); the warp
//     slots hold 32 ff columns a row in place of a DOE winner's 8.
//   - GRIN rods: a GRIN winner's checkpoint keeps the rod's decisions in
//     its bits (the steps it applied, whether it lived, whether its exit
//     coupled), and the reverse sweep runs K2's rod adjoint
//     (trace_seq_adjoint.cuh::grin_row_backward) on a GRIN winner, into the
//     pose columns and ph[0:6].  The checkpoints stay 9 words.  Under the
//     field (below) the rod takes the field's cotangent back too (grin.cuh::
//     grin_backward with kField, its own checkpoints of the field beside
//     the rod's state, in local memory).
//
// What bounds it: per ray it reads 8 input streams and up to 7 cotangents
// (60 B) and writes 7 cotangents (28 B): 88 MB at 1M rays, ~26 us at the
// H100's 3.35 TB/s.  Its arithmetic is K5's (the replay scans every row on
// every bounce) plus, per live bounce, about 3x the winner's own
// intersection and physics (the winner's recompute in row_backward, then an
// adjoint about twice its size; the rows that lose the argmin have a zero
// adjoint), plus the segment replays of long-lived rays and a
// reduce-scatter (31 shuffles) per bounce and distinct winner of a warp.  On the naive scene that is ~1.6x K5's
// operations, so like K2 and K5 it should be bound by its arithmetic.  This
// is an estimate by count (chip_smoke.py computes the bound from a run's
// rays); PERF.md holds the measured time.
//
// The polarized field runs in the field's instantiations, kField, which
// compile every family but GRIN rods (for a table without the
// diffractive, fuzzy or freeform kinds the Fresnel kinds and coatings
// alone, kFamFieldCoat, as K5) or, for a table with a GRIN rod, every
// family (kFamAll: trace_seq_common.cuh::field_link) (an overload with one
// more argument
// after the side data, FieldIn: K5's launch field, the
// cotangent of its final field, the launch field's cotangent and the
// replay's final field, each [6][N] planar; the TPU kernels' g_field,
// :2054-2149 and :2182-2406).  Its replays carry the field through K5's
// bounce (nonseq_bounce with kField: the winner's field_physics and
// transport), so they reach K5's field bit for bit, and each checkpoint
// keeps the field before its bounce after the medium: 15 words
// (state_words<true, true>), 15 KB a bounce for a block.  So it keeps
// kFieldCkpt = 6 bounces, not 13: 90 KB, with which two blocks of a table
// of up to 12 rows (the naive scene's 5 among them) still share an SM's
// 228 KB (at 7, 105 KB, only up to 4 rows would).  A ray that lives L
// bounces is reversed in segments of 6, which replays about L^2 / 12
// bounces in place of L^2 / 26.  Of chip_smoke.py section 19's scenes only
// the light guide's rays (16 bounces: three segments, 18 replayed) run out
// (the mirror fold's live 2 bounces, the naive scene's up to 5, the coated
// singlet's budget is 6).  The reverse sweep runs K2's row adjoint with
// the field (trace_seq_adjoint.cuh::row_backward with kField, field.cuh,
// thin_film.cuh::stack_field_ct), the new direction of each bounce's
// transport being the next bounce's saved direction (the ray's final one
// after the last bounce), and the final field's cotangent comes back as
// the launch field's.
//
// Limits (checked by the wrapper): 1..64 rows, <= 8 sensor slots, 1..18
// bundles and slots x bundles <= 64, any bounce budget >= 0.  Shared memory is 4 * (204 K + 7 S B +
// 8 * 19 K + 8 * 256 * min(budget, 13)) bytes: 71 KB for the naive scene,
// 111 KB for the cavity, 198 KB at 64 rows, so the launcher raises the
// block's dynamic shared-memory limit above 48 KB.
//
// Numerics: fp32 throughout, built without --use_fast_math, as K2, with K2's
// derivative conventions (trace_seq_bwd.cu).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "trace_seq_adjoint.cuh"

using namespace rtt;

namespace {

// The most checkpointed bounces per thread, in shared memory: kCkpt x
// kStateWords x 256 x 4 bytes, 104 KB at 13: the most with which two blocks
// of a table of up to 8 rows still share an SM's 228 KB.  A launch keeps
// min(budget, kCkpt) (checkpoints()): a budget that fits takes no more
// shared memory than it needs, and leaves the rest to L1.
constexpr int kCkpt = 13;
// The instantiation with the field (kField) keeps kFieldCkpt bounces of
// state_words<true, true>() = 15 words: 90 KB at 6.
constexpr int kFieldCkpt = 6;

template <bool kField = false>
__host__ __device__ __forceinline__ int checkpoints(int n_bounces) {
  constexpr int kMax = kField ? kFieldCkpt : kCkpt;
  return n_bounces < 1 ? 1 : (n_bounces < kMax ? n_bounces : kMax);
}
constexpr unsigned kFull = 0xffffffffu;

// One bounce of K5 (nonseq_bounce, the very function K5 runs).  Returns the
// winner row, or -1 when no row wins (nothing moves); `bits` receives the
// winner's branch bits.  With kOpl, n_cur becomes the winner's medium
// (medium_after, as K5's instantiation with the streams takes it).  The
// family flags as for nonseq_bounce: with kFresnel a FRESNEL winner draws at
// `rd`'s counter, as K5 drew; with kCoat a coated or metal winner reads its
// row of the side buffer `cside`; with kDiff the diffractive kinds; with
// kFuzzy a winner with a program in `fz` (null: none) weighs by it; with
// kFreeform the freeform rows of `ffs` (null: none); with kField the winner
// sees and transports the field *fe; with kGrin a GRIN winner runs its rod
// (with kField carrying *fe through it), its bits being the rod's
// decisions and its medium the rod's ambient index.
template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false, bool kFuzzy = false, bool kFreeform = false,
          bool kField = false, bool kGrin = false>
__device__ __forceinline__ int bounce(const float4* recs, const float* tab, const int32_t* knd,
                                      int n_rows, const Plates& pl, V3& p, V3& d, float& inten,
                                      uint32_t& bits, float* n_cur = nullptr,
                                      const RayDraw* rd = nullptr,
                                      const float* cside = nullptr,
                                      const int32_t* fz = nullptr,
                                      const int32_t* ffs = nullptr, Fld* fe = nullptr) {
  RowHit hw = {};
  RowKinds kw = {};
  bool degen = false;
  PhysBranch br = {};
  if constexpr (kGrin) {
    GrinExit ge;
    const int k = nonseq_bounce<kPlates, kExt, kDispersion, false, kFresnel, kCoat, kDiff, kFuzzy,
                                kFreeform, kField, true>(recs, tab, knd, n_rows, pl, p, d, inten,
                                                         hw, kw, &degen, &br, nullptr, rd, cside,
                                                         fz, ffs, fe, &ge);
    if (k >= 0 && kw.ph == GRIN) {
      bits = kActive | ge.bits;
      *n_cur = tab[k * kRowWidth + kPh];
      return k;
    }
    if (k >= 0) {
      bits = branch_bits<kFresnel>(hw, degen, br) | kActive;
      *n_cur = medium_after<kDispersion, kFresnel, kDiff>(tab + k * kRowWidth, kw, br.from_in,
                                                          br.tir, pl.wl, *n_cur, br.reflect);
    }
    return k;
  }
  const int k = nonseq_bounce<kPlates, kExt, kDispersion, false, kFresnel, kCoat, kDiff, kFuzzy,
                              kFreeform, kField>(recs, tab, knd, n_rows, pl, p, d, inten, hw, kw,
                                                 &degen, &br, nullptr, rd, cside, fz, ffs, fe);
  if (k >= 0) bits = branch_bits<kFresnel>(hw, degen, br) | kActive;
  if constexpr (kOpl) {
    if (k >= 0)
      *n_cur = medium_after<kDispersion, kFresnel, kDiff>(tab + k * kRowWidth, kw, br.from_in,
                                                          br.tir, pl.wl, *n_cur, br.reflect);
  }
  return k;
}

// Add kCols table cotangents tg of a warp's lanes into the warp's slots,
// `stride` floats a row: one reduction per distinct winner row k among the
// lanes (k < 0: the lane applied no row).  Every lane of the warp calls it.
template <int kCols>
__device__ __forceinline__ void reduce_winners(int k, const float* tg, float* slots, int stride,
                                               int lane) {
  unsigned pending = __ballot_sync(kFull, k >= 0);
  while (pending != 0u) {
    const int row = __shfl_sync(kFull, k, __ffs(pending) - 1);
    const bool mine = k == row;
    pending &= ~__ballot_sync(kFull, mine);
    float m[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) m[c] = mine ? tg[c] : 0.0f;
    reduce_cols<kCols>(m, slots + row * stride, lane);
  }
}

// What only the instantiation with dispersion takes.
struct WaveOut {
  float* cwl;     // the wavelength's cotangent, n floats (null: not wanted)
  int disp_cols;  // kDispGradCols when the table has a dispersive row, else 0
};

// What only the instantiation with the optical path length takes: the
// cotangents of K5's opl and n_final streams (n floats each; null: zero).
struct OplIn {
  const float* g_opl;
  const float* g_nfinal;
};

// What only the instantiation with the field takes, [6][n] floats each (Er
// x, y, z, then Ei x, y, z): K5's launch field `in`, the cotangent of K5's
// final field `g_out` (null: zero), the launch field's cotangent `c_in`
// (null: not wanted) and the field the forward replay ends at `r_out`
// (null: not wanted).
struct FieldIn {
  const float* in;
  const float* g_out;
  float* c_in;
  float* r_out;
};

// A ray's launch field (kField; zero past the ragged edge or without the
// field).
template <bool kField>
__device__ __forceinline__ Fld launch_field(const FieldIn& fi, long long i, long long n,
                                            bool live) {
  Fld fe = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if constexpr (kField) {
    if (live) {
      fe.r = {fi.in[i], fi.in[n + i], fi.in[2 * n + i]};
      fe.i = {fi.in[3 * n + i], fi.in[4 * n + i], fi.in[5 * n + i]};
    }
  }
  return fe;
}

// The kernel's body, shared by its six instantiations (the kernels below).
// With kOpl (which has kDispersion) the replays also carry the index of the
// medium, each checkpoint keeps the one before its bounce as a ninth word
// (a segment replay recomputes it from the launch, as it recomputes the
// rest), and the reverse sweep runs row_backward's path-length adjoint.
// The family flags (each with kOpl) compile a family of kinds in, and the
// runtime word fs.fam says which of them the table has: with kFresnel
// every replayed bounce draws under fs.key at its own counter (ray,
// bounce); with kCoat coated and metal winners read their rows of fs.coat,
// and (with kFamCoat) a row's 8 coat-thickness columns follow its disp
// columns; with kDiff the diffractive kinds, and (with kFamDiff) a DOE
// winner's 8 ff columns follow the coat columns; with kFuzzy the winners
// with a program in fs.fuzzy (copied into shared memory after the side
// buffer) weigh by it; with kFreeform the freeform rows of fs.ff (copied
// into shared memory after the programs), and (with kFamFreeform) 32 ff
// columns a row; with kGrin the replays run GRIN winners' rods and the
// reverse sweep their adjoints.  With kField (which has every family flag
// but kGrin, and kGrin in the instantiation for rods) the replays carry
// the field from `fi.in`, each checkpoint
// keeps the field before its bounce, and the reverse sweep carries its
// cotangent from `fi.g_out` to `fi.c_in`.
template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false, bool kFuzzy = false, bool kFreeform = false,
          bool kField = false, bool kGrin = false>
__device__ __forceinline__ void nonseq_bwd(
    const float* __restrict__ table, const int32_t* __restrict__ kinds, int n_rows,
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
    const float* __restrict__ gpx, const float* __restrict__ gpy, const float* __restrict__ gpz,
    const float* __restrict__ gdx, const float* __restrict__ gdy, const float* __restrict__ gdz,
    const float* __restrict__ gintensity, const float* __restrict__ gmom,
    float* __restrict__ cpx, float* __restrict__ cpy, float* __restrict__ cpz,
    float* __restrict__ cdx, float* __restrict__ cdy, float* __restrict__ cdz,
    float* __restrict__ cintensity, float* __restrict__ partials, float* __restrict__ rpx,
    float* __restrict__ rpy, float* __restrict__ rpz, float* __restrict__ rdx,
    float* __restrict__ rdy, float* __restrict__ rdz, float* __restrict__ rintensity,
    int n_slots, int n_bundles, GridCt gg, const float* __restrict__ maps,
    const int32_t* __restrict__ map_desc, const float* __restrict__ wavelength,
    float* __restrict__ gmaps, int n_bounces, long long n, WaveOut wo,
    OplIn oi = {nullptr, nullptr}, FamSide fs = {},
    FieldIn fi = {nullptr, nullptr, nullptr, nullptr}) {
  static_assert(kOpl || !kFresnel, "the Fresnel kinds run with the path length");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(kCoat || !kField, "the field runs with the coatings");
  static_assert(!kGrin || kOpl, "GRIN rods run with the path length");
  constexpr int kCols = grad_cols<kPlates, kExt>();
  constexpr int kWords = state_words<kOpl, kField>();
  constexpr int kFfCols = kFreeform ? kMaxFfTerms : kMaxDoeTerms;  // kDiff: the ff columns
  // the families the table has (fs.fam), each false without its flag
  const bool coat = kCoat && (fs.fam & kFamCoat);
  const bool freeform = kFreeform && (fs.fam & kFamFreeform);
  // a row's columns in the warp slots and the partials: with a dispersive
  // row (kDispersion) its disp columns after the kCols, with the coatings
  // the coat columns after those, with the freeform surfaces or the
  // diffractive kinds a row's ff columns after those
  const int coat_cols = coat ? kMaxCoatLayers : 0;
  const int ff_cols = freeform ? kMaxFfTerms : kDiff && (fs.fam & kFamDiff) ? kMaxDoeTerms : 0;
  const int n_cols = kDispersion ? kCols + wo.disp_cols + coat_cols + ff_cols : kCols;
  extern __shared__ float4 smem4[];
  // the packed scan records (none with kExt, whose scan reads the flat rows)
  constexpr int kRecs = kExt ? 0 : kRec4;
  const float4* recs = smem4;
  float* tab = reinterpret_cast<float*>(smem4 + n_rows * kRecs);
  int32_t* knd = reinterpret_cast<int32_t*>(tab + n_rows * kRowWidth);
  float* gm = tab + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* cside = gm + n_mom;  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? fam_coat_words(fs, n_rows) : 0));
  int32_t* ffs = fzs + (kFuzzy ? fam_fuzzy_words(fs) : 0);  // kFreeform: the pairs
  float* warp_tab = cside + (kCoat ? fam_coat_words(fs, n_rows) : 0) +
                    (kFuzzy ? fam_fuzzy_words(fs) : 0) +
                    (kFreeform ? fam_ff_words(fs, n_rows) : 0);  // [kWarps, n_rows, n_cols]
  // the programs and the pairs, null where the table lacks their family
  const int32_t* progs = kFuzzy && (fs.fam & kFamFuzzy) ? fzs : nullptr;
  const int32_t* pairs = freeform ? ffs : nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (!kExt)
    build_scan_records(reinterpret_cast<float*>(smem4), table, kinds, n_rows, tid, kThreads);
  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < n_mom; j += kThreads) gm[j] = gmom[j];
  if constexpr (kCoat) {
    for (int j = tid; j < fam_coat_words(fs, n_rows); j += kThreads) cside[j] = fs.coat[j];
  }
  if constexpr (kFuzzy) {
    for (int j = tid; j < fam_fuzzy_words(fs); j += kThreads) fzs[j] = fs.fuzzy[j];
  }
  if constexpr (kFreeform) {
    for (int j = tid; j < fam_ff_words(fs, n_rows); j += kThreads) ffs[j] = fs.ff[j];
  }
  for (int j = tid; j < kWarps * n_rows * n_cols; j += kThreads) warp_tab[j] = 0.0f;
  __syncthreads();
  if constexpr (kDiff) {
    if (fs.fam & kFamDiff) {  // uniform across the block
      ellipse_rows(tab, knd, n_rows, tid, kThreads);
      __syncthreads();
    }
  }

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  // Threads past the ragged edge hold a zero ray of zero intensity: no live
  // bounce, so they add nothing and write nothing.
  V3 p0 = {0.0f, 0.0f, 0.0f}, d0 = {0.0f, 0.0f, 1.0f};
  float i0 = 0.0f;
  int rid = -1;
  Plates pl = {maps, map_desc, 0.0f};
  if (live) {
    p0 = {px[i], py[i], pz[i]};
    d0 = {dx[i], dy[i], dz[i]};
    i0 = intensity[i];
    rid = ray_id[i];
    if (kPlates) pl.wl = wavelength[i];
  }

  // ---- forward replay: K5's loop; counts the live bounces L and leaves the
  // last segment of them in the checkpoints, bounce b in slot b % n_ck ----
  // each checkpoint: a bounce's input state p, d, intensity and its winner
  // row << 16 | the winner's bits, [n_ck][kStateWords][kThreads]
  const int n_ck = checkpoints<kField>(n_bounces);
  float* const ck = warp_tab + kWarps * n_rows * n_cols + tid;
  constexpr int kSlot = kWords * kThreads;
  V3 p = p0, d = d0;
  float inten = i0;
  int n_live = 0;
  float n_cur = 1.0f;  // kOpl: the medium (index 1 at launch)
  RayDraw rd = {fs.key, static_cast<uint32_t>(i), 0u};  // kFresnel: the draws' counter
  // kField: the ray's field, from its launch
  Fld fe = launch_field<kField>(fi, i, n, live);
#pragma unroll 1
  for (int b = 0; b < n_bounces && inten > 0.0f; ++b) {
    const V3 pb = p, db = d;
    const float ib = inten, nb = n_cur;
    const Fld fb = fe;
    uint32_t bits = 0;
    rd.bounce = static_cast<uint32_t>(b);
    const int k =
        bounce<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy, kFreeform, kField,
               kGrin>(recs, tab, knd, n_rows, pl, p, d, inten, bits, &n_cur, &rd, cside, progs,
                      pairs, kField ? &fe : nullptr);
    // a bounce that no row wins leaves its slot alone: it may hold bounce
    // b - n_ck of the last segment, which the reverse sweep needs
    if (k < 0) break;
    put_state<kThreads>(ck + (b % n_ck) * kSlot, pb, db, ib,
                        (static_cast<uint32_t>(k) << 16) | bits);
    if constexpr (kOpl) put_medium<kThreads>(ck + (b % n_ck) * kSlot, nb);
    if constexpr (kField) put_field<kThreads>(ck + (b % n_ck) * kSlot, fb);
    n_live = b + 1;
  }
  if (live && rpx != nullptr) {
    rpx[i] = p.x;
    rpy[i] = p.y;
    rpz[i] = p.z;
    rdx[i] = d.x;
    rdy[i] = d.y;
    rdz[i] = d.z;
    rintensity[i] = inten;
  }
  if constexpr (kField) {
    if (live && fi.r_out != nullptr) {
      const float v[6] = {fe.r.x, fe.r.y, fe.r.z, fe.i.x, fe.i.y, fe.i.z};
#pragma unroll
      for (int j = 0; j < 6; ++j) fi.r_out[j * n + i] = v[j];
    }
  }

  // ---- reverse sweep, in segments of n_ck bounces, the last first ----
  V3 gp = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  float gi = 0.0f, gwl = 0.0f;
  OplCt oc = {0.0f, 1.0f, 0.0f};  // kOpl: the path length's adjoint
  if (live) {
    gp = {gpx ? gpx[i] : 0.0f, gpy ? gpy[i] : 0.0f, gpz ? gpz[i] : 0.0f};
    gd = {gdx ? gdx[i] : 0.0f, gdy ? gdy[i] : 0.0f, gdz ? gdz[i] : 0.0f};
    gi = gintensity ? gintensity[i] : 0.0f;
    if constexpr (kOpl) {
      oc.g_opl = oi.g_opl ? oi.g_opl[i] : 0.0f;
      oc.g_n = oi.g_nfinal ? oi.g_nfinal[i] : 0.0f;
    }
  }
  // kField: the field's cotangent, and the direction after the bounce (the
  // ray's final one after the last bounce)
  FieldCt fc = {{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}},
                {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}},
                d};
  if constexpr (kField) {
    if (live && fi.g_out != nullptr) {
      fc.g.r = {fi.g_out[i], fi.g_out[n + i], fi.g_out[2 * n + i]};
      fc.g.i = {fi.g_out[3 * n + i], fi.g_out[4 * n + i], fi.g_out[5 * n + i]};
    }
  }
  const int warp_live = __reduce_max_sync(kFull, n_live);
  const int s_last = warp_live > 0 ? (warp_live - 1) / n_ck * n_ck : -1;
  float* slots = warp_tab + warp * n_rows * n_cols;
#pragma unroll 1
  for (int s = s_last; s >= 0; s -= n_ck) {  // warp-uniform
    if (s != s_last && s < n_live) {
      // replay from the ray's start to bounce s, then save [s, s + n_ck)
      p = p0;
      d = d0;
      inten = i0;
      n_cur = 1.0f;
      fe = launch_field<kField>(fi, i, n, live);
      uint32_t bits = 0;
#pragma unroll 1
      for (int b = 0; b < s; ++b) {
        rd.bounce = static_cast<uint32_t>(b);
        bounce<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy, kFreeform,
               kField, kGrin>(recs, tab, knd, n_rows, pl, p, d, inten, bits, &n_cur, &rd, cside,
                              progs, pairs, kField ? &fe : nullptr);
      }
#pragma unroll 1
      for (int j = 0; j < n_ck && s + j < n_live; ++j) {
        const V3 pb = p, db = d;
        const float ib = inten, nb = n_cur;
        if constexpr (kField) put_field<kThreads>(ck + j * kSlot, fe);
        rd.bounce = static_cast<uint32_t>(s + j);
        const int k = bounce<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy,
                             kFreeform, kField, kGrin>(recs, tab, knd, n_rows, pl, p, d, inten,
                                                       bits, &n_cur, &rd, cside, progs, pairs,
                                                       kField ? &fe : nullptr);
        put_state<kThreads>(ck + j * kSlot, pb, db, ib, (static_cast<uint32_t>(k) << 16) | bits);
        if constexpr (kOpl) put_medium<kThreads>(ck + j * kSlot, nb);
      }
    }
    const int j_top = min(n_ck, warp_live - s) - 1;
#pragma unroll 1
    for (int j = j_top; j >= 0; --j) {  // warp-uniform
      const bool act = s + j < n_live;
      V3 sp, sd;
      float si;
      uint32_t word = 0;
      if (act) get_state<kThreads>(ck + j * kSlot, sp, sd, si, word);
      if constexpr (kOpl) {
        if (act) oc.n_cur = get_medium<kThreads>(ck + j * kSlot);
      }
      if constexpr (kField) {
        if (act) fc.e = get_field<kThreads>(ck + j * kSlot);
      }
      const int k = act ? static_cast<int>(word >> 16) : -1;
      float tg[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) tg[c] = 0.0f;
      if constexpr (kDispersion) {
        WaveCt wc = {0.0f, 0.0f, 0.0f};
        int dispm = 0, coated = 0;
        bool doe = false;
        float tc[kCoat ? kMaxCoatLayers : 1];  // kCoat: the coat columns
#pragma unroll
        for (int c = 0; c < (kCoat ? kMaxCoatLayers : 1); ++c) tc[c] = 0.0f;
        // kDiff: a DOE winner's ff columns (kFreeform: a freeform winner's too)
        float tf[kDiff ? kFfCols : 1];
#pragma unroll
        for (int c = 0; c < (kDiff ? kFfCols : 1); ++c) tf[c] = 0.0f;
        if (act) {
          const RowKinds kd =
              read_row_kinds<kExt, kDispersion, kCoat>(knd + k * kKindWidth);
          const int32_t* ffp = freeform ? ff_row_of(ffs, k) : nullptr;
          if (kGrin && kd.ph == GRIN) {  // a GRIN winner: the rod's adjoint
            grin_row_backward<kField>(tab + k * kRowWidth, kd, sp, sd, word & 0xffffu, oc, gp,
                                      gd, gi, tg, kField ? &fc : nullptr);
          } else {
            row_backward<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy,
                         kFreeform, kField>(tab + k * kRowWidth, kd, sp, sd, si, word & 0xffffu,
                                            rid, gm, n_bundles, gg, pl, gmaps, gp, gd, gi, tg,
                                            &wc, &oc, cside + k * kCoatSide, tc, tf,
                                            progs != nullptr && fzs[k] >= 0 ? fzs + fzs[k]
                                                                            : nullptr,
                                            ffp, kField ? &fc : nullptr);
          }
          if constexpr (kField) fc.nd = sd;
          dispm = kd.dispm;
          coated = coat ? kd.coat & kCoatCountMask : 0;
          doe = kDiff && (kd.ph == DOE || ffp != nullptr);
        }
        if (partials != nullptr) reduce_winners<kCols>(k, tg, slots, n_cols, lane);
        // a dispersive winner: its media's cotangents on to the disp
        // columns and the wavelength, once tg is reduced
        gwl += wc.wl;
        float td[kDispGradCols];
#pragma unroll
        for (int c = 0; c < kDispGradCols; ++c) td[c] = 0.0f;
        if (dispm != 0) gwl += disp_backward(tab + k * kRowWidth, dispm, pl.wl, wc, td);
        if (partials != nullptr && wo.disp_cols != 0)
          reduce_winners<kDispGradCols>(dispm != 0 ? k : -1, td, slots + kCols, n_cols, lane);
        // a coated or metal winner: its thickness columns
        if constexpr (kCoat) {
          if (partials != nullptr && coat)
            reduce_winners<kMaxCoatLayers>(coated != 0 ? k : -1, tc,
                                           slots + kCols + wo.disp_cols, n_cols, lane);
        }
        // a DOE or freeform winner: its coefficients' columns
        if constexpr (kDiff) {
          float* ffslot = slots + kCols + wo.disp_cols + coat_cols;
          if (partials != nullptr && freeform)
            reduce_winners<kFfCols>(doe ? k : -1, tf, ffslot, n_cols, lane);
          else if (partials != nullptr && ff_cols != 0)
            reduce_winners<kMaxDoeTerms>(doe ? k : -1, tf, ffslot, n_cols, lane);
        }
      } else {
        if (act)
          row_backward<kPlates, kExt>(tab + k * kRowWidth,
                                      read_row_kinds<kExt, false>(knd + k * kKindWidth), sp, sd,
                                      si, word & 0xffffu, rid, gm, n_bundles, gg, pl, gmaps, gp,
                                      gd, gi, tg);
        if (partials != nullptr) reduce_winners<kCols>(k, tg, slots, kCols, lane);
      }
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
  if constexpr (kDispersion) {
    if (live && wo.cwl != nullptr) wo.cwl[i] = gwl;
  }
  if constexpr (kField) {
    if (live && fi.c_in != nullptr) {
      const float v[6] = {fc.g.r.x, fc.g.r.y, fc.g.r.z, fc.g.i.x, fc.g.i.y, fc.g.i.z};
#pragma unroll
      for (int j = 0; j < 6; ++j) fi.c_in[j * n + i] = v[j];
    }
  }

  if (partials == nullptr) return;
  __syncthreads();
  const int n_tab = n_rows * n_cols;
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_tab;
  for (int j = tid; j < n_tab; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_tab[w * n_tab + j];
    out[j] = s;
  }
}

#define RTT_NONSEQ_BWD_PARAMS                                                                      \
  const float *__restrict__ table, const int32_t *__restrict__ kinds, int n_rows,                  \
      const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,    \
      const float *__restrict__ dx, const float *__restrict__ dy, const float *__restrict__ dz,    \
      const float *__restrict__ intensity, const int32_t *__restrict__ ray_id,                     \
      const float *__restrict__ gpx, const float *__restrict__ gpy,                                \
      const float *__restrict__ gpz, const float *__restrict__ gdx,                                \
      const float *__restrict__ gdy, const float *__restrict__ gdz,                                \
      const float *__restrict__ gintensity, const float *__restrict__ gmom,                        \
      float *__restrict__ cpx, float *__restrict__ cpy, float *__restrict__ cpz,                   \
      float *__restrict__ cdx, float *__restrict__ cdy, float *__restrict__ cdz,                   \
      float *__restrict__ cintensity, float *__restrict__ partials, float *__restrict__ rpx,       \
      float *__restrict__ rpy, float *__restrict__ rpz, float *__restrict__ rdx,                   \
      float *__restrict__ rdy, float *__restrict__ rdz, float *__restrict__ rintensity,            \
      int n_slots, int n_bundles, GridCt gg, const float *__restrict__ maps,                       \
      const int32_t *__restrict__ map_desc, const float *__restrict__ wavelength,                  \
      float *__restrict__ gmaps, int n_bounces, long long n
#define RTT_NONSEQ_BWD_ARGS                                                                        \
  table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx, gdy, gdz,  \
      gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials, rpx, rpy, rpz, rdx,   \
      rdy, rdz, rintensity, n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n_bounces, \
      n

// The kernel without dispersion: with or without plate code, with or
// without the extended kinds.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_nonseq_bwd_kernel(RTT_NONSEQ_BWD_PARAMS) {
  nonseq_bwd<kPlates, kExt, false>(RTT_NONSEQ_BWD_ARGS, WaveOut{nullptr, 0});
}

// The kernel with plate code, the extended kinds and dispersion.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_nonseq_bwd_kernel(RTT_NONSEQ_BWD_PARAMS, WaveOut wo) {
  static_assert(kPlates && kExt, "dispersion runs with the extended kinds");
  nonseq_bwd<kPlates, kExt, true>(RTT_NONSEQ_BWD_ARGS, wo);
}

// The kernel with those and the optical path length.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_nonseq_bwd_kernel(RTT_NONSEQ_BWD_PARAMS, WaveOut wo, OplIn oi) {
  static_assert(kPlates && kExt, "the path length runs with the extended kinds");
  nonseq_bwd<kPlates, kExt, true, true>(RTT_NONSEQ_BWD_ARGS, wo, oi);
}

// The family instantiation (kFams = kFamAll; kFamGrin for GRIN rods
// alone): those and the families of kFams, which the table has reading
// fs.fam.
template <bool kPlates, bool kExt, uint32_t kFams = kFamAll>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_nonseq_bwd_kernel(RTT_NONSEQ_BWD_PARAMS, WaveOut wo, OplIn oi, FamSide fs) {
  static_assert(kPlates && kExt, "the families run with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  nonseq_bwd<kPlates, kExt, true, true, kF, kC, kD, kZ, kFF, false,
             fam_has(kFams, kFamGrin)>(RTT_NONSEQ_BWD_ARGS, wo, oi, fs);
}

// The field's instantiation: those, the families of kFams (every family
// but GRIN rods; kFamFieldCoat for tables without the diffractive, fuzzy or
// freeform kinds; kFamAll, with GRIN rods, for tables with a rod) and the
// field.
template <bool kPlates, bool kExt, uint32_t kFams = kFamField>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_nonseq_bwd_kernel(RTT_NONSEQ_BWD_PARAMS, WaveOut wo, OplIn oi, FamSide fs, FieldIn fi) {
  static_assert(kPlates && kExt, "the field runs with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  nonseq_bwd<kPlates, kExt, true, true, kF, kC, kD, kZ, kFF, true, fam_has(kFams, kFamGrin)>(
      RTT_NONSEQ_BWD_ARGS, wo, oi, fs, fi);
}

// The types of the kernels.
using BwdKernel = void (*)(RTT_NONSEQ_BWD_PARAMS);
using BwdExtKernel = void (*)(RTT_NONSEQ_BWD_PARAMS, WaveOut);
using BwdOplKernel = void (*)(RTT_NONSEQ_BWD_PARAMS, WaveOut, OplIn);
using BwdFamKernel = void (*)(RTT_NONSEQ_BWD_PARAMS, WaveOut, OplIn, FamSide);
using BwdFieldKernel = void (*)(RTT_NONSEQ_BWD_PARAMS, WaveOut, OplIn, FamSide, FieldIn);

#undef RTT_NONSEQ_BWD_PARAMS
#undef RTT_NONSEQ_BWD_ARGS

// The dynamic shared memory of a launch: the packed scan records (not with
// kExt), the table, its kinds, the moment cotangent, in the family and field
// instantiations the side data of the families `fs` has (the side buffer,
// the programs' words, the exponent pairs), the warp slots (disp_cols more
// columns a row on a table with a dispersive row, 8 more with the coatings,
// then 32 with freeform surfaces or 8 with the diffractive kinds), and the
// checkpoints (kField: fewer, of 15 words).  Without the records the
// mixed-surface Scene's 11 rows and 12 checkpoints fit two blocks an SM.
template <bool kPlates, bool kExt, bool kOpl = false, bool kField = false>
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, int n_bounces, int disp_cols,
                    const FamSide& fs = {}) {
  const int ff_cols = (fs.fam & kFamFreeform) ? kMaxFfTerms
                      : (fs.fam & kFamDiff)   ? kMaxDoeTerms
                                              : 0;
  return sizeof(float) *
         (static_cast<size_t>(n_rows) * ((kExt ? 0 : kRecWords) + kRowWidth + kKindWidth) +
          static_cast<size_t>(fam_coat_words(fs, n_rows)) +
          static_cast<size_t>(fam_fuzzy_words(fs)) + static_cast<size_t>(fam_ff_words(fs, n_rows)) +
          static_cast<size_t>(n_slots) * n_bundles * kMoments +
          static_cast<size_t>(kWarps) * n_rows *
              (grad_cols<kPlates, kExt>() + disp_cols +
               ((fs.fam & kFamCoat) ? kMaxCoatLayers : 0) + ff_cols) +
          static_cast<size_t>(checkpoints<kField>(n_bounces)) * state_words<kOpl, kField>() *
              kThreads);
}

// The kernel of an instantiation: without dispersion (kPlates, kExt), with
// it (kDispersion), with the path length (kOpl), the family instantiation
// (kFam) or the field's (kField).
template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, uint32_t kFams = 0u,
          bool kField = false>
const void* kernel_fn() {
  if constexpr (kField)
    return reinterpret_cast<const void*>(
        static_cast<BwdFieldKernel>(trace_nonseq_bwd_kernel<true, true, kFams>));
  else if constexpr (kFams != 0u)
    return reinterpret_cast<const void*>(
        static_cast<BwdFamKernel>(trace_nonseq_bwd_kernel<true, true, kFams>));
  else if constexpr (kOpl)
    return reinterpret_cast<const void*>(
        static_cast<BwdOplKernel>(trace_nonseq_bwd_kernel<true, true>));
  else if constexpr (kDispersion)
    return reinterpret_cast<const void*>(
        static_cast<BwdExtKernel>(trace_nonseq_bwd_kernel<true, true>));
  else
    return reinterpret_cast<const void*>(
        static_cast<BwdKernel>(trace_nonseq_bwd_kernel<kPlates, kExt>));
}

// Allow the kernel its shared memory (beyond 48 KB only on request).
template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, uint32_t kFams = 0u,
          bool kField = false>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_fn<kPlates, kExt, kDispersion, kOpl, kFams, kField>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The side data of a family or field launch from its C arguments, checked,
// as K5's (trace_nonseq_fwd.cu::fam_side).
cudaError_t fam_side(uint32_t key0, uint32_t key1, const float* coat_side, const int32_t* fuzzy,
                     int fuzzy_words, const int32_t* ff_side, unsigned fam, int n_rows,
                     FamSide* fs) {
  if (fam & ~(kFamFresnel | kFamCoat | kFamDiff | kFamFuzzy | kFamFreeform | kFamGrin))
    return cudaErrorInvalidValue;
  if ((coat_side != nullptr) != ((fam & kFamCoat) != 0) ||
      (fuzzy != nullptr) != ((fam & kFamFuzzy) != 0) ||
      (ff_side != nullptr) != ((fam & kFamFreeform) != 0))
    return cudaErrorInvalidValue;
  if (fuzzy != nullptr && (fuzzy_words < n_rows || fuzzy_words > kFuzzyMaxWords))
    return cudaErrorInvalidValue;
  *fs = FamSide{nullptr, 0, PhiloxKey{key0, key1}, coat_side, fuzzy,
                fuzzy == nullptr ? 0 : fuzzy_words, ff_side, fam};
  return cudaSuccess;
}

template <bool kPlates, bool kExt, bool kDispersion>
int launch(long long blocks, cudaStream_t stream, const float* table, const int32_t* kinds,
           int n_rows, const float* const* rays, const int32_t* ray_id,
           const float* const* g_rays, const float* gmom, float* const* c_rays, float* partials,
           float* const* r_rays, int n_slots, int n_bundles, GridCt gg, const float* maps,
           const int32_t* map_desc, const float* wavelength, float* gmaps, WaveOut wo,
           int n_bounces, long long n) {
  const size_t smem =
      shared_bytes<kPlates, kExt>(n_rows, n_slots, n_bundles, n_bounces, wo.disp_cols);
  const cudaError_t e = prepare<kPlates, kExt, kDispersion>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kDispersion)
    trace_nonseq_bwd_kernel<true, true><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
        ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6], gmom,
        c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6], partials,
        r_rays[0], r_rays[1], r_rays[2], r_rays[3], r_rays[4], r_rays[5], r_rays[6], n_slots,
        n_bundles, gg, maps, map_desc, wavelength, gmaps, n_bounces, n, wo);
  else
    trace_nonseq_bwd_kernel<kPlates, kExt>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
            ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6],
            gmom, c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6],
            partials, r_rays[0], r_rays[1], r_rays[2], r_rays[3], r_rays[4], r_rays[5], r_rays[6],
            n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n_bounces, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer.  Each of the 7 output-ray cotangents g* may
// be null (a zero cotangent); the 7 input-ray cotangents c* are all given or
// all null (not wanted), and so is the partials buffer of ceil(n / 256) *
// n_rows * 19 floats (the table cotangent), and so are the 7 replay outputs
// r*, which receive the state the forward replay ends at.  gmom holds
// n_slots * n_bundles * 7 floats; ggrid, the grid's cotangent, holds
// n_slots * grid_h * grid_w floats over [-grid_e, grid_e]^2, or is null.
// With phase plates, `maps`, `map_desc` and `wavelength` are K5's, the
// partials hold 23 columns, and `gmaps` (laid out as `maps`, zeroed by the
// caller, or null: not wanted) receives the maps' cotangent; with none all
// four are null.  `ext` as for rtt_trace_seq_fwd (the partials then hold 27
// columns), `cwl` and `disp` as for rtt_trace_seq_bwd (39 columns with
// `disp`).
extern "C" int rtt_trace_nonseq_bwd(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, float* rpx, float* rpy, float* rpz, float* rdx,
    float* rdy, float* rdz, float* rintensity, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, int ext, int n_bounces,
    long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ext && maps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!ext && (cwl != nullptr || disp)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  const float* g_rays[7] = {gpx, gpy, gpz, gdx, gdy, gdz, gintensity};
  float* c_rays[7] = {cpx, cpy, cpz, cdx, cdy, cdz, cintensity};
  float* r_rays[7] = {rpx, rpy, rpz, rdx, rdy, rdz, rintensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  const WaveOut none = {nullptr, 0};
  if (disp || cwl != nullptr)
    return launch<true, true, true>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom,
                                    c_rays, partials, r_rays, n_slots, n_bundles, gg, maps,
                                    map_desc, wavelength, gmaps,
                                    WaveOut{cwl, disp ? kDispGradCols : 0}, n_bounces, n);
  if (ext)
    return launch<true, true, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom,
                                     c_rays, partials, r_rays, n_slots, n_bundles, gg, maps,
                                     map_desc, wavelength, gmaps, none, n_bounces, n);
  if (maps != nullptr)
    return launch<true, false, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays,
                                      gmom, c_rays, partials, r_rays, n_slots, n_bundles, gg,
                                      maps, map_desc, wavelength, gmaps, none, n_bounces, n);
  return launch<false, false, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom,
                                     c_rays, partials, r_rays, n_slots, n_bundles, gg, nullptr,
                                     nullptr, nullptr, nullptr, none, n_bounces, n);
}

// Launches the instantiation with the optical path length on `stream`: the
// arguments of rtt_trace_nonseq_bwd (its `ext` implied: `maps`, `map_desc`
// and `wavelength` must be given, a PHASE_GRID row or not), then `g_opl`
// and `g_nfinal`, the cotangents of K5's opl and n_final streams (n floats
// each; null: zero), then K5's families: `fam` nonzero (kFam* bits)
// selects the family instantiation, which replays K5's draws under its
// Philox key (key0, key1) and reads `coat_side`, `fuzzy` (`fuzzy_words`
// int32 words) and `ff_side`, each null where its family's bit is clear.
// Its partials hold a row's 27 columns, the disp columns with `disp`, the
// 8 coat thicknesses with kFamCoat, then 32 ff columns with kFamFreeform or
// 8 (a DOE row's coefficients) with kFamDiff.  Returns a cudaError_t.
extern "C" int rtt_trace_nonseq_bwd_opl(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, float* rpx, float* rpy, float* rpz, float* rdx,
    float* rdy, float* rdz, float* rintensity, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, const float* g_opl,
    const float* g_nfinal, uint32_t key0, uint32_t key1, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam, int n_bounces,
    long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(key0, key1, coat_side, fuzzy, fuzzy_words, ff_side, fam, n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WaveOut wo = {cwl, disp ? kDispGradCols : 0};
  const size_t smem =
      shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, n_bounces, wo.disp_cols, fs);
  const unsigned g = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  const OplIn oi = {g_opl, g_nfinal};
  if (fam == 0) {  // the path length's kernel: the overload without side data
    e = prepare<true, true, true, true>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    trace_nonseq_bwd_kernel<true, true><<<g, kThreads, smem, s>>>(
        table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx, gdy,
        gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials, rpx, rpy, rpz,
        rdx, rdy, rdz, rintensity, n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps,
        n_bounces, n, wo, oi);
    return static_cast<int>(cudaGetLastError());
  }
  // the family instantiation of kFams: its overload takes the side data last
  auto go = [&](auto fams) {
    constexpr uint32_t kFams = decltype(fams)::value;
    const cudaError_t e2 = prepare<true, true, true, true, kFams>(smem);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    trace_nonseq_bwd_kernel<true, true, kFams><<<g, kThreads, smem, s>>>(
        table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx, gdy,
        gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials, rpx, rpy, rpz,
        rdx, rdy, rdz, rintensity, n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps,
        n_bounces, n, wo, oi, fs);
    return static_cast<int>(cudaGetLastError());
  };
  return with_fam_link<false>(fam, go);
}

// Launches the instantiation with the field on `stream` (field_link: the
// one with every family for a table with a GRIN rod): the arguments of
// rtt_trace_nonseq_bwd_opl up to `fam`, then K5's launch field `field_in`,
// the cotangent of K5's final
// field `g_field` (null: zero), the launch field's cotangent `c_field` and
// the field the forward replay ends at `r_field` (null: not wanted), [6][n]
// floats each.  Its partials hold the columns of rtt_trace_nonseq_bwd_opl's
// family instantiation.  Returns a cudaError_t.
extern "C" int rtt_trace_nonseq_bwd_field(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, float* rpx, float* rpy, float* rpz, float* rdx,
    float* rdy, float* rdz, float* rintensity, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, const float* g_opl,
    const float* g_nfinal, uint32_t key0, uint32_t key1, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam,
    const float* field_in, const float* g_field, float* c_field, float* r_field, int n_bounces,
    long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(key0, key1, coat_side, fuzzy, fuzzy_words, ff_side, fam, n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (field_in == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WaveOut wo = {cwl, disp ? kDispGradCols : 0};
  const size_t smem = shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, n_bounces,
                                                           wo.disp_cols, fs);
  auto go = [&](auto fams) {
    constexpr uint32_t kFams = decltype(fams)::value;
    const cudaError_t e2 = prepare<true, true, true, true, kFams, true>(smem);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    trace_nonseq_bwd_kernel<true, true, kFams>
        <<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
            gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials, rpx,
            rpy, rpz, rdx, rdy, rdz, rintensity, n_slots, n_bundles,
            GridCt{ggrid, grid_h, grid_w, grid_e}, maps, map_desc, wavelength, gmaps, n_bounces,
            n, wo, OplIn{g_opl, g_nfinal}, fs, FieldIn{field_in, g_field, c_field, r_field});
    return static_cast<int>(cudaGetLastError());
  };
  return with_field_link<true>(fam, go);
}

// The resident blocks per SM of the instantiation that a launch with these
// sizes runs, at its dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  `code`: 0 without
// plate code, 1 with it, 2 with it and the extended kinds, 3 with those and
// dispersion on a table with a dispersive row, 4 the instantiation with the
// path length on such a table, 5 the family instantiation on such a table,
// 6 the field's on such a table, these two with the families `fam` (kFam*
// bits) and programs of `fuzzy_words` words.  Returns a cudaError_t.
extern "C" int rtt_trace_nonseq_bwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                              int n_bounces, int code, int fuzzy_words,
                                              unsigned fam, int* blocks) {
  if (n_rows <= 0 || n_rows > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FamSide fs = {nullptr, 0, PhiloxKey{0u, 0u}, nullptr, nullptr, fuzzy_words, nullptr,
                      code >= 5 ? fam : 0u};
  size_t smem;
  cudaError_t e;
  const void* fn;
  if (code == 6) {
    smem = shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, n_bounces,
                                                kDispGradCols, fs);
    with_field_link<true>(fam, [&](auto fams) {
      constexpr uint32_t kFams = decltype(fams)::value;
      e = prepare<true, true, true, true, kFams, true>(smem);
      fn = kernel_fn<true, true, true, true, kFams, true>();
      return 0;
    });
  } else if (code == 5) {
    smem = shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, n_bounces, kDispGradCols,
                                          fs);
    with_fam_link<false>(fam, [&](auto fams) {
      constexpr uint32_t kFams = decltype(fams)::value;
      e = prepare<true, true, true, true, kFams>(smem);
      fn = kernel_fn<true, true, true, true, kFams>();
      return 0;
    });
  } else if (code == 4) {
    smem = shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, n_bounces, kDispGradCols);
    e = prepare<true, true, true, true>(smem);
    fn = kernel_fn<true, true, true, true>();
  } else if (code == 3) {
    smem = shared_bytes<true, true>(n_rows, n_slots, n_bundles, n_bounces, kDispGradCols);
    e = prepare<true, true, true>(smem);
    fn = kernel_fn<true, true, true>();
  } else if (code == 2) {
    smem = shared_bytes<true, true>(n_rows, n_slots, n_bundles, n_bounces, 0);
    e = prepare<true, true, false>(smem);
    fn = kernel_fn<true, true, false>();
  } else if (code == 1) {
    smem = shared_bytes<true, false>(n_rows, n_slots, n_bundles, n_bounces, 0);
    e = prepare<true, false, false>(smem);
    fn = kernel_fn<true, false, false>();
  } else {
    smem = shared_bytes<false, false>(n_rows, n_slots, n_bundles, n_bounces, 0);
    e = prepare<false, false, false>(smem);
    fn = kernel_fn<false, false, false>();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}

// The dynamic shared memory that a launch of the family instantiation
// (`field` zero) or of the field's (`field` nonzero) takes, into *bytes:
// `disp` whether the table has a dispersive row, `fam` its families (kFam*
// bits), `fuzzy_words` the program buffer's words.  The host's limit
// (ops/fused_nonseq.py::k6_shared_bytes) is held to it.  Returns a
// cudaError_t.
extern "C" int rtt_trace_nonseq_bwd_smem(int n_rows, int n_slots, int n_bundles, int n_bounces,
                                         int disp, int fuzzy_words, unsigned fam, int field,
                                         long long* bytes) {
  if (n_rows <= 0 || n_rows > 64 || n_bounces < 0 || bytes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FamSide fs = {nullptr, 0, PhiloxKey{0u, 0u}, nullptr, nullptr, fuzzy_words, nullptr, fam};
  const int disp_cols = disp ? kDispGradCols : 0;
  *bytes = static_cast<long long>(
      field ? shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, n_bounces,
                                                    disp_cols, fs)
            : shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, n_bounces, disp_cols,
                                             fs));
  return 0;
}
