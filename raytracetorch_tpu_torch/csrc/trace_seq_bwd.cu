// Fused sequential backward trace for Hopper (sm_90a): kernel K2, the
// hand-written adjoint of K1 (trace_seq_fwd.cu).
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_v2_bwd (launched by trace_sequential_pallas_v2_bwd, joined to the
// forward by the custom_vjp fused_trace_grad) for the main-path kinds,
// pixelated phase plates, the extended kinds of the mixed-surface and
// asphere scenes and dispersive media, the optical path length (g_opl,
// g_nfinal), the Fresnel kinds with K1's pre-drawn uniforms (the TPU
// kernel's u_vals, :1883-1891), thin-film coatings and metal mirrors, the
// diffractive and ideal elements, component-style fuzzy apodization (the
// TPU kernel's fuzzy_fns, :1775), freeform surfaces and the solids' and
// cones' bounds (HALFSPACES, CONE_NAPPE: decisions without a cotangent,
// which the row replay takes through K1's intersect_row), with every other
// optional stream off.  Its plain
// PyTorch version is ops/fused_trace.py::trace_seq_bwd_plain (autograd of
// the eager chain), and the wrapper that launches it is
// ops/fused_trace.py::trace_seq_bwd_cuda.
//
// What it computes: the vector-Jacobian product of the fused forward.  Given
// the table, the input rays, the cotangents of the 7 output ray streams, of
// the [S, B, 7] moments and (when K1 binned a grid) of the [S, H, W] grid,
// it returns the cotangents of the 7 input ray streams and of the table, and
// with phase plates those of their maps (the TPU kernel's ct['grids']).
// The TPU kernel re-runs the chain and transposes it with an in-kernel
// jax.vjp; a CUDA kernel has no autodiff, so the adjoint of every step is
// written out below.
//
// One row's forward step with its branch bits (row_forward), one row's
// adjoint (row_backward) and the per-warp table-cotangent reduction
// (reduce_row) live in trace_seq_adjoint.cuh, shared with K6.
//
// Design: one thread per ray, 256 threads per block; the flat table, the
// int32 kinds and the moment cotangent sit in shared memory, and every thread
// visits the same row at the same time, so the switch on a row's kinds is
// warp-uniform.
// - Forward sweep: the chain of K1, row by row, saving each row's input
//   state (p, d, intensity: 7 floats) and its branch decisions as bits
//   (active, chosen root, linear, degenerate normal, from_in, TIR, ...).
//   The reverse sweep takes the saved branches; it never re-decides them
//   from a re-rounded state.  The saved states of a table of up to 8 rows
//   live in shared memory, [row][word][thread] (trace_seq_adjoint.cuh::
//   put_state), sized by the launch's own row count: 8 KB a row, 40 KB for
//   the bench scene's 5 rows.  So no register holds them across the sweeps,
//   the row loops need not unroll, and the kernel keeps one copy of each
//   row's forward and adjoint (an unrolled 8-row bucket held 8 of each:
//   ~20k instructions).  Longer tables (up to 64 rows) keep them in a
//   per-thread array in local memory.
// - Occupancy: __launch_bounds__(256, 2) caps the instantiation without
//   plate code at 128 registers, so two blocks (16 warps) share an SM and
//   hide the latency of the IEEE sqrt and division subroutines
//   (trace_seq_adjoint.cuh::kBwdMinBlocks; PERF.md holds the measured
//   registers, spills and blocks per SM).
// - Reverse sweep, row K-1 down to 0: the adjoint of the masked update
//   where(active, new, old), of the sensor moment terms, of the physics
//   (REFLECT, SNELL with the from_in and TIR branches, APERTURE with its mask
//   constant, BLOCK), of the normal (zero for a degenerate one) and of the
//   intersection (plane formula or the quadric root taken), then of the
//   world->surface frame.  An inactive row passes every cotangent through.
// - Table cotangent: the world-scale epsilon, the bound columns (sb, vb, Rs,
//   ts) and n_sign enter the chain only through comparisons and selects, so
//   their cotangent is zero.  A row's cotangent is nonzero only in q[0:5],
//   Rw[0:9], tw[0:3] and ph[0:2]: 19 of 160 columns, and with phase plates
//   also ph[2:6] (order, design wavelength, half extents): 23.  Those are
//   reduced over the block (the transpose reduce-scatter of trace_seq_adjoint.cuh::reduce_row:
//   31 shuffles a row, lane c ends with column c), one slot per warp and
//   row in shared memory, a fixed-order sum over warps, into a [blocks, K,
//   19 or 23] buffer that the wrapper sums and scatters into [K, 160].  No
//   atomics: deterministic.
// - Phase maps: a PHASE_GRID row's adjoint (trace_seq_adjoint.cuh::
//   phase_grid_backward) re-reads the four corners of its cell and adds
//   their cotangents into the maps' cotangent in device memory with one
//   atomicAdd each (kernel K4's scatter, grid_corners.cuh): the transpose
//   that the TPU kernel takes with jax.vjp of its one-hot matmuls.  Float
//   atomics add in a run-dependent order.  With no plate and no RECT bound
//   the kernel is instantiated without plate code (kPlates = false).
// - The extended kinds (kExt, with plate code; the caller's `ext`): an even
//   asphere's row reverses its normal and its 4 Halley steps, recomputed
//   from the saved state (trace_seq_adjoint.cuh), and its table cotangent
//   adds asph[0:4]: 27 columns.  The saved state stays 8 words a row.
//   A dispersive row's SNELL (or PHASE_GRID) adjoint hands the cotangents of
//   its two per-ray indices to disp_backward, which adds those of ph[0:2],
//   of the row's 12 disp columns (a second reduce-scatter after the 27, run
//   only for dispersive rows: 39 columns a row when the caller says the
//   table has one, `disp`, else the parent's 27 and its shared memory) and
//   of the ray's wavelength.  That code sits in a fourth instantiation
//   (kDispersion), an overload of the kernel with one more argument,
//   WaveOut: the wavelength's cotangent (null: not wanted) and the disp
//   flag.  The other three keep their parameters and their code (with
//   dispersion in it, the extended instantiation spilled 156 B, not 92, and
//   the mixed-surface scene's K2 ran ~7% slower, PERF.md); all four run one
//   body, seq_bwd.  A phase-plate scene whose wavelength is under grad
//   takes the fourth too, for the kick's wavelength cotangent.
// - The optical path length (K1's track_opl): a fifth instantiation, kOpl,
//   built on the fourth (an overload with one more argument, OplIn: the
//   cotangents of K1's opl and n_final), so that the others keep their
//   code.  Its forward sweep carries the medium's index and saves it before
//   each row as a ninth state word (9 KB a row of shared memory: 45 KB on
//   the bench scene); its reverse sweep runs row_backward's path-length
//   adjoint (trace_seq_adjoint.cuh: g_opl n_cur joins t's cotangent,
//   g_opl t the medium's, and a refracting row hands the medium's
//   cotangent to the index it took).  A recording run's backward does not
//   come here: it recomputes through the eager chain, as the reference's
//   _fused_bwd does (ops/fused_trace.py).
// - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W): a sixth
//   instantiation, kFresnel, built on the fifth (an overload with one more
//   argument, SeqDraws: K1's [F][N] uniforms), so that the others keep their
//   code.  Its forward sweep reads each FRESNEL row's uniform as K1 does and
//   saves the drawn branch as a bit (kReflect); its reverse sweep runs
//   row_backward's Fresnel adjoints (trace_seq_adjoint.cuh): the chosen
//   direction alone for FRESNEL, and for FRESNEL_W and REFLECT_W the
//   cotangent of the reflectance R in their weights.  The saved state stays
//   9 words.
// - Thin-film coatings and metal mirrors: a seventh instantiation, kCoat,
//   built on the sixth (an overload with one more argument, CoatSide: the
//   rows' [K][20] side buffer, copied into shared memory after the moment
//   cotangent), so that the others keep their code.  Its reverse sweep
//   takes a coated or metal row's weight back through the row's stack
//   (thin_film.cuh::stack_rt_ct, recomputed there: no saved state for it)
//   and reduces the 8 coat-thickness columns after the others.
// - The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA rows,
//   the ELLIPSE bound): an eighth instantiation, kDiff, built on the
//   seventh (an overload with one more argument, DiffKinds), so that the
//   others keep their code.  Its reverse sweep runs diffractive_backward
//   (trace_seq_adjoint.cuh, diffractive.cuh) and reduces a DOE row's 8 ff
//   columns after the coat columns, only on DOE rows; GRATING and DOE rows
//   add their share to the wavelength's cotangent.
// - Fuzzy apodization: a ninth instantiation, kFuzzy, built on the eighth
//   (an overload with one more argument, FuzzyProgs: the traced programs'
//   int32 buffer, copied into shared memory after the side buffer), so that
//   the others keep their code.  Its forward sweep multiplies a row's
//   factor by its program's value at the hit, as K1 does; its reverse sweep
//   re-runs the program at the replayed hit with forward-mode partials
//   (fuzzy.cuh: 4 floats a register, no stored tape) and adds g I imod
//   dw/d(hit) to the hit's cotangent (row_backward).  The programs have no
//   parameters of the table: the table's columns are unchanged.
// - Freeform surfaces: a tenth instantiation, kFreeform, built on the ninth
//   (an overload with one more argument, FfSide: the rows' exponent pairs,
//   copied into shared memory after the programs), so that the others keep
//   their code.  Its forward sweep refines a freeform row's roots as K1
//   does; its reverse sweep reverses the row's normal and its 8 Newton
//   steps (freeform.cuh, recomputed from the saved state: the saved state
//   stays 9 words), and its warp slots hold 32 ff columns a row in place of
//   a DOE row's 8: the coefficients of up to MAX_FF_TERMS monomials, after
//   the coat columns (67 columns a row, 79 on a table with a dispersive
//   row: 2.5 KB a row of shared memory beside the 9 KB of saved state).
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
// adjoint about twice the size of the forward), plus one reduce-scatter (31
// shuffles) per row.  At 1M rays that is 88 MB, ~26 us at the H100's 3.35
// TB/s; K1 measured far above its bandwidth bound, so K2 should be bound by
// its arithmetic.  This is an estimate by count; PERF.md holds the measured
// time.
//
// Numerics: fp32 throughout, built without --use_fast_math (IEEE sqrt and
// division, denormals kept), as K1.  The derivative conventions follow
// PyTorch autograd of the eager chain: ties of the two roots split the
// cotangent in halves (torch.minimum), |x| has derivative 0 at 0, and the
// where-guarded sqrt and division branches get no cotangent.

#include <cstdint>

#include <cuda_runtime.h>

#include "trace_seq_adjoint.cuh"

using namespace rtt;

namespace {

// Tables of up to kSharedRows rows keep each thread's saved state in shared
// memory (kStateWords x 256 x 4 = 8 KB a row: 40 KB for the bench scene's 5
// rows); longer ones (up to kMaxRows) in a per-thread array in local
// memory.
constexpr int kSharedRows = 8;
constexpr int kMaxRows = 64;

// What only the instantiation with dispersion takes.
struct WaveOut {
  float* cwl;     // the wavelength's cotangent, n floats (null: not wanted)
  int disp_cols;  // kDispGradCols when the table has a dispersive row, else 0
};

// What only the instantiation with the optical path length takes: the
// cotangents of K1's opl and n_final streams (n floats each; null: zero).
struct OplIn {
  const float* g_opl;
  const float* g_nfinal;
};

// What only the instantiation with the Fresnel kinds takes: K1's uniforms,
// n_draws streams of n floats, one per FRESNEL row in row order.
struct SeqDraws {
  const float* u;
  int n_draws;
};

// What only the instantiation with the coatings takes: the rows' side
// buffer, [K][kCoatSide] floats (ops/fused_trace.py::coat_side).
struct CoatSide {
  const float* side;
};

// The instantiation with the diffractive kinds (kDiff): its overload's tag.
struct DiffKinds {
  int unused;
};

// What only the instantiation with the fuzzy programs takes: their n_words
// int32 words (fuzzy.cuh's layout).
struct FuzzyProgs {
  const int32_t* words;
  int n_words;
};

// What only the instantiation with the freeform surfaces takes: the rows'
// exponent pairs, [K][kFfSide] int32 words (freeform.cuh's layout).
struct FfSide {
  const int32_t* pw;
};

// The kernel's body, shared by its six instantiations (the kernels below).
// With kOpl (which has kDispersion) the forward sweep also carries the
// index of the medium and saves it before each row as a ninth state word
// (recomputing it in the reverse sweep would mean replaying the chain up to
// each row: the word costs 1 KB a row of shared memory), and the reverse
// sweep runs row_backward's path-length adjoint (OplCt).  With kFresnel
// (which has kOpl) a FRESNEL row of the forward sweep reads the ray's
// uniform from the next stream of `dr`.  With kCoat (which has kFresnel)
// coated and metal rows read their rows of `cs`, and a row's 8
// coat-thickness columns follow its disp columns.  With kDiff (which has
// kCoat) the diffractive kinds, and a DOE row's 8 ff columns follow the coat
// columns.  With kFuzzy (which has kDiff) the rows with a program in `fp`
// (copied into shared memory after the side buffer) weigh by it.  With
// kFreeform (which has kFuzzy) the freeform rows of `ff` (copied into shared
// memory after the programs) refine their roots onto their sags, and the ff
// columns are 32 a row (a freeform row's coefficients, or a DOE row's in
// the first 8).
template <bool kShared, bool kPlates, bool kExt, bool kDispersion, bool kOpl = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false>
__device__ __forceinline__ void seq_bwd(
    const float* __restrict__ table, const int32_t* __restrict__ kinds, int n_rows,
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
    const float* __restrict__ gpx, const float* __restrict__ gpy, const float* __restrict__ gpz,
    const float* __restrict__ gdx, const float* __restrict__ gdy, const float* __restrict__ gdz,
    const float* __restrict__ gintensity, const float* __restrict__ gmom,
    float* __restrict__ cpx, float* __restrict__ cpy, float* __restrict__ cpz,
    float* __restrict__ cdx, float* __restrict__ cdy, float* __restrict__ cdz,
    float* __restrict__ cintensity, float* __restrict__ partials, int n_slots, int n_bundles,
    GridCt gg, const float* __restrict__ maps, const int32_t* __restrict__ map_desc,
    const float* __restrict__ wavelength, float* __restrict__ gmaps, long long n, WaveOut wo,
    OplIn oi = {nullptr, nullptr}, SeqDraws dr = {nullptr, 0}, CoatSide cs = {nullptr},
    FuzzyProgs fp = {nullptr, 0}, FfSide ff = {nullptr}) {
  static_assert(kOpl || !kFresnel, "the Fresnel kinds run with the path length");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  constexpr int kCols = grad_cols<kPlates, kExt>();
  constexpr int kFfCols = kFreeform ? kMaxFfTerms : kMaxDoeTerms;  // kDiff: the ff columns
  constexpr int kStride = kShared ? kThreads : 1;
  constexpr int kWords = state_words<kOpl>();
  // a row's columns in the warp slots and the partials: with a dispersive
  // row (kDispersion) its disp columns after the kCols, with kCoat the coat
  // columns after those, with kDiff a DOE row's ff columns after those
  const int n_cols = kDispersion ? kCols + wo.disp_cols + (kCoat ? kMaxCoatLayers : 0) +
                                       (kDiff ? kFfCols : 0)
                                 : kCols;
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* gm = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* cside = gm + n_mom;  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? n_rows * kCoatSide : 0));
  int32_t* ffs = fzs + (kFuzzy ? fp.n_words : 0);  // kFreeform: the pairs
  float* warp_tab = cside + (kCoat ? n_rows * kCoatSide : 0) + (kFuzzy ? fp.n_words : 0) +
                    (kFreeform ? n_rows * kFfSide : 0);  // [kWarps, n_rows, n_cols]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // each row's saved state: [n_rows][kStateWords][kThreads] after the
  // warp slots, or a per-thread array
  float local[kShared ? 1 : kMaxRows * kWords];
  float* const saved = kShared ? warp_tab + kWarps * n_rows * n_cols + tid : local;

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < n_mom; j += kThreads) gm[j] = gmom[j];
  if constexpr (kCoat) {
    for (int j = tid; j < n_rows * kCoatSide; j += kThreads) cside[j] = cs.side[j];
  }
  if constexpr (kFuzzy) {
    for (int j = tid; j < fp.n_words; j += kThreads) fzs[j] = fp.words[j];
  }
  if constexpr (kFreeform) {
    for (int j = tid; j < n_rows * kFfSide; j += kThreads) ffs[j] = ff.pw[j];
  }
  for (int j = tid; j < kWarps * n_rows * n_cols; j += kThreads) warp_tab[j] = 0.0f;
  __syncthreads();
  if constexpr (kDiff) {
    ellipse_rows(tab, knd, n_rows, tid, kThreads);
    __syncthreads();
  }

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  V3 p = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  float inten = 0.0f;
  int rid = -1;
  Plates pl = {maps, map_desc, 0.0f};
  if (live) {
    p = {px[i], py[i], pz[i]};
    d = {dx[i], dy[i], dz[i]};
    inten = intensity[i];
    rid = ray_id[i];
    if (kPlates) pl.wl = wavelength[i];
  }

  // ---- forward sweep: save each row's input state and branch bits ----
  float n_cur = 1.0f;  // kOpl: the medium (index 1 at launch)
  int f = 0;           // kFresnel: the next FRESNEL row's stream
#pragma unroll 1
  for (int k = 0; k < n_rows; ++k) {
    const V3 p0 = p, d0 = d;
    const float i0 = inten;
    const RowKinds kd = read_row_kinds<kExt, kDispersion, kCoat>(knd + k * kKindWidth);
    float u = 0.0f;
    if constexpr (kFresnel) {
      if (kd.ph == FRESNEL) {  // warp-uniform
        if (live && f < dr.n_draws) u = dr.u[static_cast<long long>(f) * n + i];
        ++f;
      }
    }
    const uint32_t bits =
        row_forward<kPlates, kExt, kDispersion, kFresnel, kCoat, kDiff, kFuzzy, kFreeform>(
            tab + k * kRowWidth, kd, pl, p, d, inten, u, cside + k * kCoatSide,
            kFuzzy && fzs[k] >= 0 ? fzs + fzs[k] : nullptr,
            kFreeform ? ff_row_of(ffs, k) : nullptr);
    put_state<kStride>(saved + k * kWords * kStride, p0, d0, i0, bits);
    if constexpr (kOpl) {
      put_medium<kStride>(saved + k * kWords * kStride, n_cur);
      if (bits & kActive)
        n_cur = medium_after<kDispersion, kFresnel, kDiff>(tab + k * kRowWidth, kd,
                                                           bits & kFromIn, bits & kTir, pl.wl,
                                                           n_cur, bits & kReflect);
    }
  }

  // ---- reverse sweep ----
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
#pragma unroll 1
  for (int k = n_rows - 1; k >= 0; --k) {
    const float* r = tab + k * kRowWidth;
    const RowKinds kd = read_row_kinds<kExt, kDispersion, kCoat>(knd + k * kKindWidth);
    V3 sp, sd;
    float si;
    uint32_t bits;
    get_state<kStride>(saved + k * kWords * kStride, sp, sd, si, bits);
    if constexpr (kOpl) oc.n_cur = get_medium<kStride>(saved + k * kWords * kStride);
    float tg[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) tg[c] = 0.0f;
    if constexpr (kDispersion) {
      WaveCt wc = {0.0f, 0.0f, 0.0f};
      float tc[kCoat ? kMaxCoatLayers : 1];  // kCoat: the coat columns
#pragma unroll
      for (int c = 0; c < (kCoat ? kMaxCoatLayers : 1); ++c) tc[c] = 0.0f;
      // kDiff: a DOE row's ff columns (kFreeform: a freeform row's too)
      float tf[kDiff ? kFfCols : 1];
#pragma unroll
      for (int c = 0; c < (kDiff ? kFfCols : 1); ++c) tf[c] = 0.0f;
      const int32_t* ffp = kFreeform ? ff_row_of(ffs, k) : nullptr;
      row_backward<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy, kFreeform>(
          r, kd, sp, sd, si, bits, rid, gm, n_bundles, gg, pl, gmaps, gp, gd, gi, tg, &wc, &oc,
          cside + k * kCoatSide, tc, tf, kFuzzy && fzs[k] >= 0 ? fzs + fzs[k] : nullptr, ffp);
      const bool any = partials != nullptr && __any_sync(0xffffffffu, bits & kActive);
      float* slot = warp_tab + (warp * n_rows + k) * n_cols;
      if (any) reduce_row<kPlates, kExt>(tg, slot, lane);
      // a dispersive row (warp-uniform): its media's cotangents on to the
      // disp columns and the wavelength, once tg is reduced
      gwl += wc.wl;
      if (kd.dispm != 0) {
        float td[kDispGradCols];
#pragma unroll
        for (int c = 0; c < kDispGradCols; ++c) td[c] = 0.0f;
        if (bits & kActive) gwl += disp_backward(r, kd.dispm, pl.wl, wc, td);
        if (any && wo.disp_cols != 0) reduce_cols<kDispGradCols>(td, slot + kCols, lane);
      }
      // a coated or metal row (warp-uniform): its thickness columns
      if constexpr (kCoat) {
        if (any && (kd.coat & kCoatCountMask) != 0)
          reduce_cols<kMaxCoatLayers>(tc, slot + kCols + wo.disp_cols, lane);
      }
      // a DOE or freeform row (warp-uniform): its coefficients' columns
      if constexpr (kDiff) {
        if (any && (kd.ph == DOE || (kFreeform && ffp != nullptr)))
          reduce_cols<kFfCols>(tf, slot + kCols + wo.disp_cols + kMaxCoatLayers, lane);
      }
    } else {
      row_backward<kPlates, kExt>(r, kd, sp, sd, si, bits, rid, gm, n_bundles, gg, pl, gmaps, gp,
                                  gd, gi, tg);
      if (partials != nullptr && __any_sync(0xffffffffu, bits & kActive))
        reduce_row<kPlates, kExt>(tg, warp_tab + (warp * n_rows + k) * kCols, lane);
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

#define RTT_SEQ_BWD_PARAMS                                                                        \
  const float *__restrict__ table, const int32_t *__restrict__ kinds, int n_rows,                 \
      const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,    \
      const float *__restrict__ dx, const float *__restrict__ dy, const float *__restrict__ dz,    \
      const float *__restrict__ intensity, const int32_t *__restrict__ ray_id,                    \
      const float *__restrict__ gpx, const float *__restrict__ gpy,                               \
      const float *__restrict__ gpz, const float *__restrict__ gdx,                               \
      const float *__restrict__ gdy, const float *__restrict__ gdz,                               \
      const float *__restrict__ gintensity, const float *__restrict__ gmom,                       \
      float *__restrict__ cpx, float *__restrict__ cpy, float *__restrict__ cpz,                  \
      float *__restrict__ cdx, float *__restrict__ cdy, float *__restrict__ cdz,                  \
      float *__restrict__ cintensity, float *__restrict__ partials, int n_slots, int n_bundles,   \
      GridCt gg, const float *__restrict__ maps, const int32_t *__restrict__ map_desc,            \
      const float *__restrict__ wavelength, float *__restrict__ gmaps, long long n
#define RTT_SEQ_BWD_ARGS                                                                          \
  table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx, gdy, gdz, \
      gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials, n_slots, n_bundles,  \
      gg, maps, map_desc, wavelength, gmaps, n

// The kernel without dispersion: with or without plate code, with or
// without the extended kinds.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS) {
  seq_bwd<kShared, kPlates, kExt, false>(RTT_SEQ_BWD_ARGS, WaveOut{nullptr, 0});
}

// The kernel with plate code, the extended kinds and dispersion.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo) {
  static_assert(kPlates && kExt, "dispersion runs with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true>(RTT_SEQ_BWD_ARGS, wo);
}

// The kernel with those and the optical path length.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi) {
  static_assert(kPlates && kExt, "the path length runs with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true>(RTT_SEQ_BWD_ARGS, wo, oi);
}

// The kernel with those and the Fresnel kinds.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, SeqDraws dr) {
  static_assert(kPlates && kExt, "the Fresnel kinds run with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true, true>(RTT_SEQ_BWD_ARGS, wo, oi, dr);
}

// The kernel with those and the coatings.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, SeqDraws dr, CoatSide cs) {
  static_assert(kPlates && kExt, "the coatings run with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true, true, true>(RTT_SEQ_BWD_ARGS, wo, oi, dr, cs);
}

// The kernel with those and the diffractive kinds.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, SeqDraws dr, CoatSide cs,
                     DiffKinds) {
  static_assert(kPlates && kExt, "the diffractive kinds run with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true, true, true, true>(RTT_SEQ_BWD_ARGS, wo, oi, dr,
                                                                cs);
}

// The kernel with those and the fuzzy programs.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, SeqDraws dr, CoatSide cs,
                     DiffKinds, FuzzyProgs fp) {
  static_assert(kPlates && kExt, "the fuzzy programs run with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true, true, true, true, true>(RTT_SEQ_BWD_ARGS, wo, oi,
                                                                      dr, cs, fp);
}

// The kernel with those and the freeform surfaces.
template <bool kShared, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, SeqDraws dr, CoatSide cs,
                     DiffKinds, FuzzyProgs fp, FfSide ff) {
  static_assert(kPlates && kExt, "the freeform surfaces run with the extended kinds");
  seq_bwd<kShared, kPlates, kExt, true, true, true, true, true, true, true>(
      RTT_SEQ_BWD_ARGS, wo, oi, dr, cs, fp, ff);
}

// The types of the eight kernels.
using BwdKernel = void (*)(RTT_SEQ_BWD_PARAMS);
using BwdExtKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut);
using BwdOplKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn);
using BwdFresnelKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, SeqDraws);
using BwdCoatKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, SeqDraws, CoatSide);
using BwdDiffKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, SeqDraws, CoatSide,
                               DiffKinds);
using BwdFuzzyKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, SeqDraws, CoatSide,
                                DiffKinds, FuzzyProgs);
using BwdFreeformKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, SeqDraws, CoatSide,
                                   DiffKinds, FuzzyProgs, FfSide);

#undef RTT_SEQ_BWD_PARAMS
#undef RTT_SEQ_BWD_ARGS

// The plate arguments of a launch: the maps, their descriptors, the rays'
// wavelengths and the maps' cotangent.
struct PlateArgs {
  const float* maps;
  const int32_t* desc;
  const float* wavelength;
  float* gmaps;
};

// The dynamic shared memory of a launch: the table, its kinds, the moment
// cotangent, with kCoat the side buffer, the warp slots (disp_cols more
// columns a row on a table with a dispersive row, with kCoat 8 more, with
// kDiff 8 more again, with kFreeform 32 in their place), the fuzzy
// programs' `fuzzy_words`, with kFreeform the rows' exponent pairs and, for
// tables of up to kSharedRows rows, the saved states (a word more a row
// with the path length).
template <bool kPlates, bool kExt, bool kOpl = false, bool kCoat = false, bool kDiff = false,
          bool kFreeform = false>
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, int disp_cols,
                    int fuzzy_words = 0) {
  const size_t rows = static_cast<size_t>(n_rows);
  return sizeof(float) *
         (rows * (kRowWidth + kKindWidth) + static_cast<size_t>(n_slots) * n_bundles * kMoments +
          (kCoat ? rows * kCoatSide : 0) + static_cast<size_t>(fuzzy_words) +
          (kFreeform ? rows * kFfSide : 0) +
          static_cast<size_t>(kWarps) * rows *
              (grad_cols<kPlates, kExt>() + disp_cols + (kCoat ? kMaxCoatLayers : 0) +
               (kDiff ? (kFreeform ? kMaxFfTerms : kMaxDoeTerms) : 0)) +
          (n_rows <= kSharedRows ? rows * state_words<kOpl>() * kThreads : 0));
}

// The kernel of an instantiation.
template <bool kShared, bool kPlates, bool kExt, bool kDispersion, bool kOpl = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false>
const void* kernel_fn() {
  if constexpr (kFreeform)
    return reinterpret_cast<const void*>(
        static_cast<BwdFreeformKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kFuzzy)
    return reinterpret_cast<const void*>(
        static_cast<BwdFuzzyKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kDiff)
    return reinterpret_cast<const void*>(
        static_cast<BwdDiffKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kCoat)
    return reinterpret_cast<const void*>(
        static_cast<BwdCoatKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kFresnel)
    return reinterpret_cast<const void*>(
        static_cast<BwdFresnelKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kOpl)
    return reinterpret_cast<const void*>(
        static_cast<BwdOplKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else if constexpr (kDispersion)
    return reinterpret_cast<const void*>(
        static_cast<BwdExtKernel>(trace_seq_bwd_kernel<kShared, true, true>));
  else
    return reinterpret_cast<const void*>(
        static_cast<BwdKernel>(trace_seq_bwd_kernel<kShared, kPlates, kExt>));
}

// The instantiation a launch runs, its shared memory allowed (beyond 48 KB
// only on request) -> (cudaError_t, the kernel).
template <bool kShared, bool kPlates, bool kExt, bool kDispersion, bool kOpl = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false>
cudaError_t prepare(size_t smem, const void** fn) {
  *fn = kernel_fn<kShared, kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy,
                  kFreeform>();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false, bool kFuzzy = false, bool kFreeform = false>
cudaError_t prepare_rows(int n_rows, size_t smem, const void** fn) {
  return n_rows <= kSharedRows
             ? prepare<true, kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy,
                       kFreeform>(smem, fn)
             : prepare<false, kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy,
                       kFreeform>(smem, fn);
}

template <bool kShared, bool kPlates, bool kExt, bool kDispersion>
int launch(long long blocks, cudaStream_t stream, size_t smem, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           const float* const* g_rays, const float* gmom, float* const* c_rays, float* partials,
           int n_slots, int n_bundles, GridCt gg, const PlateArgs& pa, WaveOut wo, long long n) {
  const void* fn;
  const cudaError_t e = prepare<kShared, kPlates, kExt, kDispersion>(smem, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kDispersion)
    trace_seq_bwd_kernel<kShared, true, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
        ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6], gmom,
        c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6], partials,
        n_slots, n_bundles, gg, pa.maps, pa.desc, pa.wavelength, pa.gmaps, n, wo);
  else
    trace_seq_bwd_kernel<kShared, kPlates, kExt>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
            ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6],
            gmom, c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6],
            partials, n_slots, n_bundles, gg, pa.maps, pa.desc, pa.wavelength, pa.gmaps, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlates, bool kExt, bool kDispersion>
int launch_rows(long long blocks, cudaStream_t stream, const float* table, const int32_t* kinds,
                int n_rows, const float* const* rays, const int32_t* ray_id,
                const float* const* g_rays, const float* gmom, float* const* c_rays,
                float* partials, int n_slots, int n_bundles, GridCt gg, const PlateArgs& pa,
                WaveOut wo, long long n) {
  const size_t smem = shared_bytes<kPlates, kExt>(n_rows, n_slots, n_bundles, wo.disp_cols);
  if (n_rows <= kSharedRows)
    return launch<true, kPlates, kExt, kDispersion>(blocks, stream, smem, table, kinds, n_rows,
                                                    rays, ray_id, g_rays, gmom, c_rays, partials,
                                                    n_slots, n_bundles, gg, pa, wo, n);
  return launch<false, kPlates, kExt, kDispersion>(blocks, stream, smem, table, kinds, n_rows,
                                                   rays, ray_id, g_rays, gmom, c_rays, partials,
                                                   n_slots, n_bundles, gg, pa, wo, n);
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer.  Each of the 7 output-ray cotangents
// g* may be null (a zero cotangent); the 7 input-ray cotangents c* are all
// given or all null (not wanted), and so is the partials buffer of
// ceil(n / 256) * n_rows * 19 floats (the table cotangent; 23 with plates,
// 27 with the extended kinds, 39 with `disp` too).
// gmom holds n_slots * n_bundles * 7 floats; ggrid, the grid's cotangent,
// holds n_slots * grid_h * grid_w floats over [-grid_e, grid_e]^2, or is
// null.  With phase plates, `maps`, `map_desc` and `wavelength` are K1's,
// and `gmaps` (laid out as `maps`, zeroed by the caller, or null: not
// wanted) receives the maps' cotangent; with none all four are null.  `ext`
// as for rtt_trace_seq_fwd; with it, `cwl` (n floats, or null: not wanted)
// receives the wavelength's cotangent, and `disp` nonzero says that the
// table has a dispersive row (its disp columns' cotangents are computed only
// so): either selects the instantiation with dispersion.  Without `ext` both
// must be null and 0.
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
                                 const float* maps, const int32_t* map_desc,
                                 const float* wavelength, float* gmaps, float* cwl, int disp,
                                 int ext, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ext && maps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!ext && (cwl != nullptr || disp)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  const float* g_rays[7] = {gpx, gpy, gpz, gdx, gdy, gdz, gintensity};
  float* c_rays[7] = {cpx, cpy, cpz, cdx, cdy, cdz, cintensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  const PlateArgs pa = {maps, map_desc, wavelength, gmaps};
  const WaveOut none = {nullptr, 0};
  if (disp || cwl != nullptr)
    return launch_rows<true, true, true>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays,
                                         gmom, c_rays, partials, n_slots, n_bundles, gg, pa,
                                         WaveOut{cwl, disp ? kDispGradCols : 0}, n);
  if (ext)
    return launch_rows<true, true, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays,
                                          gmom, c_rays, partials, n_slots, n_bundles, gg, pa,
                                          none, n);
  if (maps != nullptr)
    return launch_rows<true, false, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays,
                                           gmom, c_rays, partials, n_slots, n_bundles, gg, pa,
                                           none, n);
  return launch_rows<false, false, false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays,
                                          gmom, c_rays, partials, n_slots, n_bundles, gg,
                                          PlateArgs{nullptr, nullptr, nullptr, nullptr}, none, n);
}

// Launches the instantiation with the optical path length on `stream`: the
// arguments of rtt_trace_seq_bwd (its `ext` implied: `maps`, `map_desc` and
// `wavelength` must be given, a PHASE_GRID row or not), then `g_opl` and
// `g_nfinal`, the cotangents of K1's opl and n_final streams (n floats
// each; null: zero).  `fresnel` nonzero selects the instantiation with the
// Fresnel kinds, which reads K1's `uniforms`, n_draws * n floats (null with
// n_draws 0 when no row draws); without it both are ignored.  `coat_side`,
// when not null, selects the instantiation with the coatings (which also
// takes the Fresnel kinds and reads `uniforms` so): the n_rows * 20 floats
// of ops/fused_trace.py::coat_side; its partials hold 8 more columns a row
// (the coat thicknesses, after the disp columns).  With `coat_side`, `diff`
// nonzero selects the instantiation with the diffractive kinds, whose
// partials hold 8 more (a DOE row's coefficients, after the coat columns),
// and with it `fuzzy`, when not null, the one with the fuzzy programs: K1's
// `fuzzy_words` int32 words; with that `ff_side`, when not null, the one
// with the freeform surfaces: K1's exponent pairs, whose partials hold 32
// ff columns a row in place of the 8.  Returns a cudaError_t.
extern "C" int rtt_trace_seq_bwd_opl(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, const float* g_opl,
    const float* g_nfinal, const float* uniforms, int n_draws, int fresnel,
    const float* coat_side, int diff, const int32_t* fuzzy, int fuzzy_words,
    const int32_t* ff_side, long long n, void* stream) {
  if (n <= 0) return 0;
  if (diff && coat_side == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (ff_side != nullptr && fuzzy == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (fuzzy != nullptr && (!diff || fuzzy_words < n_rows || fuzzy_words > kFuzzyMaxWords))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fuzzy == nullptr) fuzzy_words = 0;
  if (coat_side != nullptr) fresnel = 1;
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fresnel && (n_draws < 0 || (n_draws > 0 && uniforms == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WaveOut wo = {cwl, disp ? kDispGradCols : 0};
  const OplIn oi = {g_opl, g_nfinal};
  const size_t smem =
      ff_side != nullptr
          ? shared_bytes<true, true, true, true, true, true>(n_rows, n_slots, n_bundles,
                                                             wo.disp_cols, fuzzy_words)
      : diff ? shared_bytes<true, true, true, true, true>(n_rows, n_slots, n_bundles, wo.disp_cols,
                                                          fuzzy_words)
      : coat_side != nullptr
          ? shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, wo.disp_cols)
          : shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, wo.disp_cols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  // one launch per row layout for the six instantiations: the Fresnel
  // kernel's overload takes the draws as its last argument, the coated one
  // the draws and the side buffer, the diffractive one those and its tag,
  // the fuzzy one those and the programs, the freeform one those and the
  // exponent pairs
  auto go = [&](auto... draws) {
    const void* fn;
    const cudaError_t e =
        prepare_rows<true, true, true, true, sizeof...(draws) != 0, sizeof...(draws) >= 2,
                     sizeof...(draws) >= 3, sizeof...(draws) >= 4, sizeof...(draws) == 5>(
            n_rows, smem, &fn);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_rows <= kSharedRows)
      trace_seq_bwd_kernel<true, true, true><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, GridCt{ggrid, grid_h, grid_w, grid_e}, maps, map_desc, wavelength,
          gmaps, n, wo, oi, draws...);
    else
      trace_seq_bwd_kernel<false, true, true><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, GridCt{ggrid, grid_h, grid_w, grid_e}, maps, map_desc, wavelength,
          gmaps, n, wo, oi, draws...);
    return static_cast<int>(cudaGetLastError());
  };
  if (ff_side != nullptr)
    return go(SeqDraws{uniforms, n_draws}, CoatSide{coat_side}, DiffKinds{0},
              FuzzyProgs{fuzzy, fuzzy_words}, FfSide{ff_side});
  if (fuzzy != nullptr)
    return go(SeqDraws{uniforms, n_draws}, CoatSide{coat_side}, DiffKinds{0},
              FuzzyProgs{fuzzy, fuzzy_words});
  if (diff) return go(SeqDraws{uniforms, n_draws}, CoatSide{coat_side}, DiffKinds{0});
  if (coat_side != nullptr) return go(SeqDraws{uniforms, n_draws}, CoatSide{coat_side});
  return fresnel ? go(SeqDraws{uniforms, n_draws}) : go();
}

// The resident blocks per SM of the instantiation that a launch with these
// sizes runs, at its dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
// (n_bounces is K6's; K2 has none.)  `code`: 0 without plate code, 1 with
// it, 2 with it and the extended kinds, 3 with those and dispersion on a
// table with a dispersive row, 4 the instantiation with the path length on
// such a table, 5 the one with the Fresnel kinds on such a table, 6 the one
// with the coatings on such a table, 7 the one with the diffractive kinds
// on such a table, 8 the one with the fuzzy programs (of `fuzzy_words`
// words) on such a table, 9 the one with the freeform surfaces (and
// programs of `fuzzy_words` words) on such a table.
extern "C" int rtt_trace_seq_bwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                           int /*n_bounces*/, int code, int fuzzy_words,
                                           int* blocks) {
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int disp_cols = code >= 3 ? kDispGradCols : 0;
  const size_t smem =
      code == 9 ? shared_bytes<true, true, true, true, true, true>(n_rows, n_slots, n_bundles,
                                                                   disp_cols, fuzzy_words)
      : code == 8 ? shared_bytes<true, true, true, true, true>(n_rows, n_slots, n_bundles,
                                                               disp_cols, fuzzy_words)
      : code == 7 ? shared_bytes<true, true, true, true, true>(n_rows, n_slots, n_bundles, disp_cols)
      : code == 6 ? shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, disp_cols)
      : code >= 4 ? shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, disp_cols)
      : code >= 2 ? shared_bytes<true, true>(n_rows, n_slots, n_bundles, disp_cols)
      : code == 1 ? shared_bytes<true, false>(n_rows, n_slots, n_bundles, 0)
                  : shared_bytes<false, false>(n_rows, n_slots, n_bundles, 0);
  const void* fn;
  const cudaError_t e = code == 9 ? prepare_rows<true, true, true, true, true, true, true, true,
                                                 true>(n_rows, smem, &fn)
                        : code == 8 ? prepare_rows<true, true, true, true, true, true, true, true>(
                                        n_rows, smem, &fn)
                        : code == 7 ? prepare_rows<true, true, true, true, true, true, true>(
                                        n_rows, smem, &fn)
                        : code == 6 ? prepare_rows<true, true, true, true, true, true>(n_rows, smem, &fn)
                        : code == 5 ? prepare_rows<true, true, true, true, true>(n_rows, smem, &fn)
                        : code == 4 ? prepare_rows<true, true, true, true>(n_rows, smem, &fn)
                        : code == 3 ? prepare_rows<true, true, true>(n_rows, smem, &fn)
                        : code == 2 ? prepare_rows<true, true, false>(n_rows, smem, &fn)
                        : code == 1 ? prepare_rows<true, false, false>(n_rows, smem, &fn)
                                    : prepare_rows<false, false, false>(n_rows, smem, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}
