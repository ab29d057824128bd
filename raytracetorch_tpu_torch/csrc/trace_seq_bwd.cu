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
// - The families of kinds (the Fresnel kinds, coatings and metal mirrors,
//   the diffractive and ideal elements, fuzzy apodization, freeform
//   surfaces, GRIN rods): one more instantiation, the family
//   instantiation, built on the fifth (an overload with one more argument,
//   FamSide: K1's side data and the runtime word `fam` of the families the
//   table has, trace_seq_common.cuh), so that the others keep their code.
//   It compiles every family together, so a table may mix them; a family
//   the table lacks skips its block setup and its columns (a table that
//   one of the chain's links took runs that link's instantiation,
//   trace_seq_common.cuh::fam_link, as K1 does).  Per family:
//   - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W): the forward sweep
//     reads each FRESNEL row's uniform as K1 does and saves the drawn
//     branch as a bit (kReflect); the reverse sweep runs row_backward's
//     Fresnel adjoints (trace_seq_adjoint.cuh): the chosen direction alone
//     for FRESNEL, and for FRESNEL_W and REFLECT_W the cotangent of the
//     reflectance R in their weights.  The saved state stays 9 words.
//   - Thin-film coatings and metal mirrors: the rows' [K][20] side buffer is
//     copied into shared memory after the moment cotangent; the reverse
//     sweep takes a coated or metal row's weight back through the row's
//     stack (thin_film.cuh::stack_rt_ct, recomputed there: no saved state
//     for it) and reduces the 8 coat-thickness columns after the others.
//   - The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA
//     rows, the ELLIPSE bound): the reverse sweep runs diffractive_backward
//     (trace_seq_adjoint.cuh, diffractive.cuh) and reduces a DOE row's 8 ff
//     columns after the coat columns, only on DOE rows; GRATING and DOE rows
//     add their share to the wavelength's cotangent.
//   - Fuzzy apodization: the traced programs' int32 buffer is copied into
//     shared memory after the side buffer; the forward sweep multiplies a
//     row's factor by its program's value at the hit, as K1 does; the
//     reverse sweep re-runs the program at the replayed hit with
//     forward-mode partials (fuzzy.cuh: 4 floats a register, no stored
//     tape) and adds g I imod dw/d(hit) to the hit's cotangent
//     (row_backward).  The programs have no parameters of the table.
//   - Freeform surfaces: the rows' exponent pairs are copied into shared
//     memory after the programs; the forward sweep refines a freeform row's
//     roots as K1 does; the reverse sweep reverses the row's normal and its
//     8 Newton steps (freeform.cuh, recomputed from the saved state), and
//     the warp slots hold 32 ff columns a row in place of a DOE row's 8:
//     the coefficients of up to MAX_FF_TERMS monomials.
//   - GRIN rods: the forward sweep runs a GRIN row as K1 does
//     (trace_seq_common.cuh::grin_row, the rod out of line) and saves the
//     rod's decisions in the row's bits (grin.cuh: it lived, its exit
//     coupled, the steps it applied); the reverse sweep runs the rod's
//     adjoint (grin.cuh::grin_backward), which re-runs the rod from the
//     saved state with those decisions, keeping a checkpoint every 16 steps
//     in local memory, and reverses the steps a segment at a time, into the
//     pose columns (Rw, tw) and ph[0:6] (n_ambient, c0, c2, c4, cz, L), all
//     among the 27 columns.
//   A row's columns: the 27, the disp columns on a table with a dispersive
//   row, the 8 coat columns when the table has coatings, then 32 ff
//   columns with freeform surfaces or 8 with the diffractive kinds.
// - The polarized field: the field's instantiations, kField, one that
//   compiles every family but GRIN rods and one, for tables with a rod,
//   that compiles every family (trace_seq_common.cuh::field_link) (an
//   overload with one more argument, FieldIn: K1's launch field, the
//   cotangent of its final field and the launch field's cotangent, each
//   [6][N] planar), so that the others keep their code.  A rod takes the
//   field's cotangent back through its exit coupling, its steps (the field
//   at each of the rod's checkpoints rides beside its state) and its entry
//   coupling (grin.cuh::grin_backward with kField).  Its forward sweep
//   carries the field as K1 does and saves
//   the incoming field as six more state words a row (15 in all: 15 KB a
//   row of shared memory, so tables of up to kFieldSharedRows rows keep
//   them there, longer ones in local memory); its reverse sweep carries the
//   field's cotangent through row_backward's field adjoint
//   (trace_seq_adjoint.cuh, field.cuh), which adds the cotangents of the
//   directions, the normals, the media, a JONES row's ph[0:5] and Rw
//   columns and the wavelength.  A JONES row's cotangents land in columns
//   the table already reduces (Rw, ph[0:6]).  A coated interface's and a
//   metal mirror's polarized weights and amplitudes go back through their
//   stacks together, one reverse sweep a polarization (thin_film.cuh::
//   stack_field_ct, recomputed: no saved state for them) into the layers'
//   thicknesses (the coat columns), a metal's ambient and (n, k) and the
//   wavelength.
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
#include <type_traits>

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
// With the field (kField) a row saves 15 words: up to 5 rows in shared
// memory keep two blocks an SM.
constexpr int kFieldSharedRows = 5;

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

// What only the instantiation with the field takes, [6][n] floats each (Er
// x, y, z, then Ei x, y, z): K1's launch field `in`, the cotangent of K1's
// final field `g_out` (null: zero) and the launch field's cotangent `c_in`
// (null: not wanted).
struct FieldIn {
  const float* in;
  const float* g_out;
  float* c_in;
};

// The kernel's body, shared by its instantiations (the kernels below).
// With kOpl (which has kDispersion) the forward sweep also carries the
// index of the medium and saves it before each row as a ninth state word
// (recomputing it in the reverse sweep would mean replaying the chain up to
// each row: the word costs 1 KB a row of shared memory), and the reverse
// sweep runs row_backward's path-length adjoint (OplCt).  The family flags
// (each with kOpl) compile a family of kinds in, and the runtime word
// fs.fam says which of them the table has: with kFresnel a FRESNEL row of
// the forward sweep reads the ray's uniform from the next stream of fs.u;
// with kCoat coated and metal rows read their rows of fs.coat, and (with
// kFamCoat) a row's 8 coat-thickness columns follow its disp columns; with
// kDiff the diffractive kinds, and (with kFamDiff) a DOE row's 8 ff columns
// follow the coat columns; with kFuzzy the rows with a program in fs.fuzzy
// (copied into shared memory after the side buffer) weigh by it; with
// kFreeform the freeform rows of fs.ff (copied into shared memory after the
// programs) refine their roots onto their sags, and (with kFamFreeform)
// the ff columns are 32 a row (a freeform row's coefficients, or a DOE
// row's in the first 8); with kGrin a GRIN row runs the rod forward and its
// adjoint back.  With kField (which has every family flag but kGrin, and
// kGrin in the instantiation for rods) the field rides the state as K1
// carries it.
template <bool kShared, bool kPlates, bool kExt, bool kDispersion, bool kOpl = false,
          bool kFresnel = false, bool kCoat = false, bool kDiff = false, bool kFuzzy = false,
          bool kFreeform = false, bool kField = false, bool kGrin = false>
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
    OplIn oi = {nullptr, nullptr}, FamSide fs = {},
    FieldIn fi = {nullptr, nullptr, nullptr}) {
  static_assert(kOpl || !kFresnel, "the Fresnel kinds run with the path length");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(kFreeform || !kField, "the field runs with the freeform surfaces");
  static_assert(!kGrin || kOpl, "GRIN rods run with the path length");
  constexpr int kCols = grad_cols<kPlates, kExt>();
  constexpr int kFfCols = kFreeform ? kMaxFfTerms : kMaxDoeTerms;  // kDiff: the ff columns
  constexpr int kStride = kShared ? kThreads : 1;
  constexpr int kWords = state_words<kOpl, kField>();
  // the families the table has (fs.fam), each false without its flag
  const bool coat = kCoat && (fs.fam & kFamCoat);
  const bool fuzzy = kFuzzy && (fs.fam & kFamFuzzy);
  const bool freeform = kFreeform && (fs.fam & kFamFreeform);
  // a row's columns in the warp slots and the partials: with a dispersive
  // row (kDispersion) its disp columns after the kCols, with the coatings
  // the coat columns after those, with the freeform surfaces or the
  // diffractive kinds a row's ff columns after those
  const int coat_cols = coat ? kMaxCoatLayers : 0;
  const int ff_cols = freeform ? kMaxFfTerms : kDiff && (fs.fam & kFamDiff) ? kMaxDoeTerms : 0;
  const int n_cols = kDispersion ? kCols + wo.disp_cols + coat_cols + ff_cols : kCols;
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* gm = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* cside = gm + n_mom;  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? fam_coat_words(fs, n_rows) : 0));
  int32_t* ffs = fzs + (kFuzzy ? fam_fuzzy_words(fs) : 0);  // kFreeform: the pairs
  float* warp_tab = cside + (kCoat ? fam_coat_words(fs, n_rows) : 0) +
                    (kFuzzy ? fam_fuzzy_words(fs) : 0) +
                    (kFreeform ? fam_ff_words(fs, n_rows) : 0);  // [kWarps, n_rows, n_cols]
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

  // kField: the ray's field (zero past the ragged edge)
  Fld fe = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if constexpr (kField) {
    if (live) {
      fe.r = {fi.in[i], fi.in[n + i], fi.in[2 * n + i]};
      fe.i = {fi.in[3 * n + i], fi.in[4 * n + i], fi.in[5 * n + i]};
    }
  }

  // ---- forward sweep: save each row's input state and branch bits ----
  float n_cur = 1.0f;  // kOpl: the medium (index 1 at launch)
  int f = 0;           // kFresnel: the next FRESNEL row's stream
#pragma unroll 1
  for (int k = 0; k < n_rows; ++k) {
    const V3 p0 = p, d0 = d;
    const float i0 = inten;
    const RowKinds kd = read_row_kinds<kExt, kDispersion, kCoat>(knd + k * kKindWidth);
    if constexpr (kGrin) {
      if (kd.ph == GRIN) {  // warp-uniform: the rod, as K1 runs it
        GrinExit ge;
        float t;
        if constexpr (kField) put_field<kStride>(saved + k * kWords * kStride, fe);
        const uint32_t gbits = grin_row<kPlates, kField>(tab + k * kRowWidth, kd, p, d, inten, ge,
                                                         t, kField ? &fe : nullptr)
                                   ? kActive | ge.bits
                                   : 0u;
        put_state<kStride>(saved + k * kWords * kStride, p0, d0, i0, gbits);
        put_medium<kStride>(saved + k * kWords * kStride, n_cur);
        if (gbits & kActive) n_cur = tab[k * kRowWidth + kPh];
        continue;
      }
    }
    float u = 0.0f;
    if constexpr (kFresnel) {
      if (kd.ph == FRESNEL) {  // warp-uniform
        if (live && f < fs.n_draws) u = fs.u[static_cast<long long>(f) * n + i];
        ++f;
      }
    }
    if constexpr (kField) put_field<kStride>(saved + k * kWords * kStride, fe);
    const uint32_t bits =
        row_forward<kPlates, kExt, kDispersion, kFresnel, kCoat, kDiff, kFuzzy, kFreeform, kField>(
            tab + k * kRowWidth, kd, pl, p, d, inten, u, cside + k * kCoatSide,
            fuzzy && fzs[k] >= 0 ? fzs + fzs[k] : nullptr,
            freeform ? ff_row_of(ffs, k) : nullptr, kField ? &fe : nullptr);
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
  // kField: the field's cotangent, and the direction after the row (the
  // ray's final one after the last row)
  FieldCt fc = {{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}},
                {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}},
                d};
  if constexpr (kField) {
    if (live && fi.g_out != nullptr) {
      fc.g.r = {fi.g_out[i], fi.g_out[n + i], fi.g_out[2 * n + i]};
      fc.g.i = {fi.g_out[3 * n + i], fi.g_out[4 * n + i], fi.g_out[5 * n + i]};
    }
  }
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
    if constexpr (kField) fc.e = get_field<kStride>(saved + k * kWords * kStride);
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
      const int32_t* ffp = freeform ? ff_row_of(ffs, k) : nullptr;
      if (kGrin && kd.ph == GRIN) {  // warp-uniform: the rod's adjoint
        grin_row_backward<kField>(r, kd, sp, sd, bits, oc, gp, gd, gi, tg,
                                  kField ? &fc : nullptr);
      } else {
        row_backward<kPlates, kExt, kDispersion, kOpl, kFresnel, kCoat, kDiff, kFuzzy, kFreeform,
                     kField>(r, kd, sp, sd, si, bits, rid, gm, n_bundles, gg, pl, gmaps, gp, gd,
                             gi, tg, &wc, &oc, cside + k * kCoatSide, tc, tf,
                             fuzzy && fzs[k] >= 0 ? fzs + fzs[k] : nullptr, ffp,
                             kField ? &fc : nullptr);
      }
      if constexpr (kField) fc.nd = sd;
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
        if (any && coat && (kd.coat & kCoatCountMask) != 0)
          reduce_cols<kMaxCoatLayers>(tc, slot + kCols + wo.disp_cols, lane);
      }
      // a DOE or freeform row (warp-uniform): its coefficients' columns
      if constexpr (kDiff) {
        float* ffslot = slot + kCols + wo.disp_cols + coat_cols;
        if (any && freeform && (kd.ph == DOE || ffp != nullptr))
          reduce_cols<kFfCols>(tf, ffslot, lane);
        else if (any && ff_cols != 0 && kd.ph == DOE)
          reduce_cols<kMaxDoeTerms>(tf, ffslot, lane);
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

// The family instantiation (kFams = kFamAll; kFamGrin for GRIN rods
// alone): those and the families of kFams, which the table has reading
// fs.fam.
template <bool kShared, bool kPlates, bool kExt, uint32_t kFams = kFamAll>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, FamSide fs) {
  static_assert(kPlates && kExt, "the families run with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  seq_bwd<kShared, kPlates, kExt, true, true, kF, kC, kD, kZ, kFF, false, fam_has(kFams, kFamGrin)>(
      RTT_SEQ_BWD_ARGS, wo, oi, fs);
}

// The field's instantiation: those, the families of kFams (every family
// but GRIN rods; kFamAll, with them, for tables with a rod) and the field.
template <bool kShared, bool kPlates, bool kExt, uint32_t kFams = kFamField>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
trace_seq_bwd_kernel(RTT_SEQ_BWD_PARAMS, WaveOut wo, OplIn oi, FamSide fs, FieldIn fi) {
  static_assert(kPlates && kExt, "the field runs with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  seq_bwd<kShared, kPlates, kExt, true, true, kF, kC, kD, kZ, kFF, true,
          fam_has(kFams, kFamGrin)>(RTT_SEQ_BWD_ARGS, wo, oi, fs, fi);
}

// The types of the kernels.
using BwdKernel = void (*)(RTT_SEQ_BWD_PARAMS);
using BwdExtKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut);
using BwdOplKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn);
using BwdFamKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, FamSide);
using BwdFieldKernel = void (*)(RTT_SEQ_BWD_PARAMS, WaveOut, OplIn, FamSide, FieldIn);

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
// cotangent, in the family and field instantiations the side data of the
// families `fs` has (the side buffer, the programs' words, the exponent
// pairs), the warp slots (disp_cols more columns a row on a table with a
// dispersive row, 8 more with the coatings, then 32 with freeform surfaces
// or 8 with the diffractive kinds) and, for tables of up to kSharedRows
// rows (kFieldSharedRows with the field), the saved states (a word more a
// row with the path length, six more with the field).
template <bool kPlates, bool kExt, bool kOpl = false, bool kField = false>
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, int disp_cols,
                    const FamSide& fs = {}) {
  const size_t rows = static_cast<size_t>(n_rows);
  const int ff_cols = (fs.fam & kFamFreeform) ? kMaxFfTerms
                      : (fs.fam & kFamDiff)   ? kMaxDoeTerms
                                              : 0;
  return sizeof(float) *
         (rows * (kRowWidth + kKindWidth) + static_cast<size_t>(n_slots) * n_bundles * kMoments +
          static_cast<size_t>(fam_coat_words(fs, n_rows)) +
          static_cast<size_t>(fam_fuzzy_words(fs)) + static_cast<size_t>(fam_ff_words(fs, n_rows)) +
          static_cast<size_t>(kWarps) * rows *
              (grad_cols<kPlates, kExt>() + disp_cols +
               ((fs.fam & kFamCoat) ? kMaxCoatLayers : 0) + ff_cols) +
          (n_rows <= (kField ? kFieldSharedRows : kSharedRows)
               ? rows * state_words<kOpl, kField>() * kThreads
               : 0));
}

// The kernel of an instantiation: without dispersion (kPlates, kExt), with
// it (kDispersion), with the path length (kOpl), the family instantiation
// of the families kFams or the field's (kField).
template <bool kShared, bool kPlates, bool kExt, bool kDispersion, bool kOpl = false,
          uint32_t kFams = 0u, bool kField = false>
const void* kernel_fn() {
  if constexpr (kField)
    return reinterpret_cast<const void*>(
        static_cast<BwdFieldKernel>(trace_seq_bwd_kernel<kShared, true, true, kFams>));
  else if constexpr (kFams != 0u)
    return reinterpret_cast<const void*>(
        static_cast<BwdFamKernel>(trace_seq_bwd_kernel<kShared, true, true, kFams>));
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
          uint32_t kFams = 0u, bool kField = false>
cudaError_t prepare(size_t smem, const void** fn) {
  *fn = kernel_fn<kShared, kPlates, kExt, kDispersion, kOpl, kFams, kField>();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kPlates, bool kExt, bool kDispersion, bool kOpl = false, uint32_t kFams = 0u,
          bool kField = false>
cudaError_t prepare_rows(int n_rows, size_t smem, const void** fn) {
  return n_rows <= (kField ? kFieldSharedRows : kSharedRows)
             ? prepare<true, kPlates, kExt, kDispersion, kOpl, kFams, kField>(smem, fn)
             : prepare<false, kPlates, kExt, kDispersion, kOpl, kFams, kField>(smem, fn);
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

// The side data of a family or field launch from its C arguments, checked,
// as K1's (trace_seq_fwd.cu::fam_side).
cudaError_t fam_side(const float* uniforms, int n_draws, const float* coat_side,
                     const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side,
                     unsigned fam, int n_rows, FamSide* fs) {
  if (fam & ~(kFamFresnel | kFamCoat | kFamDiff | kFamFuzzy | kFamFreeform | kFamGrin))
    return cudaErrorInvalidValue;
  if ((coat_side != nullptr) != ((fam & kFamCoat) != 0) ||
      (fuzzy != nullptr) != ((fam & kFamFuzzy) != 0) ||
      (ff_side != nullptr) != ((fam & kFamFreeform) != 0))
    return cudaErrorInvalidValue;
  if (fuzzy != nullptr && (fuzzy_words < n_rows || fuzzy_words > kFuzzyMaxWords))
    return cudaErrorInvalidValue;
  if (n_draws < 0 || (n_draws > 0 && (uniforms == nullptr || !(fam & kFamFresnel))))
    return cudaErrorInvalidValue;
  *fs = FamSide{uniforms, n_draws, PhiloxKey{0u, 0u}, coat_side, fuzzy,
                fuzzy == nullptr ? 0 : fuzzy_words, ff_side, fam};
  return cudaSuccess;
}

// Launches the instantiation with the optical path length on `stream`: the
// arguments of rtt_trace_seq_bwd (its `ext` implied: `maps`, `map_desc` and
// `wavelength` must be given, a PHASE_GRID row or not), then `g_opl` and
// `g_nfinal`, the cotangents of K1's opl and n_final streams (n floats
// each; null: zero), then K1's families: `fam` nonzero (kFam* bits) selects
// the family instantiation, which reads K1's `uniforms` (n_draws * n
// floats, null with n_draws 0 when no row draws), `coat_side`, `fuzzy`
// (`fuzzy_words` int32 words) and `ff_side`, each null where its family's
// bit is clear.  Its partials hold a row's 27 columns, the disp columns
// with `disp`, the 8 coat thicknesses with kFamCoat, then 32 ff columns
// with kFamFreeform or 8 (a DOE row's coefficients) with kFamDiff.
// Returns a cudaError_t.
extern "C" int rtt_trace_seq_bwd_opl(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, const float* g_opl,
    const float* g_nfinal, const float* uniforms, int n_draws, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam, long long n,
    void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(uniforms, n_draws, coat_side, fuzzy, fuzzy_words, ff_side, fam,
                           n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WaveOut wo = {cwl, disp ? kDispGradCols : 0};
  const OplIn oi = {g_opl, g_nfinal};
  const size_t smem = shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, wo.disp_cols, fs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  const bool shared = n_rows <= kSharedRows;
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  const void* fn;
  e = fam == 0 ? prepare_rows<true, true, true, true>(n_rows, smem, &fn)
               : with_fam_link(fam, [&](auto fams) {
                   return prepare_rows<true, true, true, true, decltype(fams)::value>(
                       n_rows, smem, &fn);
                 });
  if (e != cudaSuccess) return static_cast<int>(e);
  // one launch per row layout for the instantiations: the family kernel's
  // overload takes the side data as its last argument, its family set
  // (kFams) as a template argument
  auto go = [&](auto fams, auto... side) {
    constexpr uint32_t kFams = decltype(fams)::value;
    if (shared)
      trace_seq_bwd_kernel<true, true, true, kFams><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi, side...);
    else
      trace_seq_bwd_kernel<false, true, true, kFams><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi, side...);
    return static_cast<int>(cudaGetLastError());
  };
  if (fam == 0) {
    // the path length's kernel: the overload without side data
    if (shared)
      trace_seq_bwd_kernel<true, true, true><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi);
    else
      trace_seq_bwd_kernel<false, true, true><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi);
    return static_cast<int>(cudaGetLastError());
  }
  return with_fam_link(fam, [&](auto fams) { return go(fams, fs); });
}

// Launches the instantiation with the field on `stream` (field_link: the
// one with every family for a table with a GRIN rod): the arguments of
// rtt_trace_seq_bwd_opl, then `field_in`, K1's launch field, `g_field`, the cotangent of K1's final
// field (null: zero), and `c_field`, which receives the launch field's
// cotangent (null: not wanted), 6 * n floats each ([6][n]: Er x, y, z, then
// Ei x, y, z).  Tables of up to kFieldSharedRows rows keep their saved
// states in shared memory.  Returns a cudaError_t.
extern "C" int rtt_trace_seq_bwd_field(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, float* cwl, int disp, const float* g_opl,
    const float* g_nfinal, const float* uniforms, int n_draws, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam,
    const float* field_in, const float* g_field, float* c_field, long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(uniforms, n_draws, coat_side, fuzzy, fuzzy_words, ff_side, fam,
                           n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (field_in == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WaveOut wo = {cwl, disp ? kDispGradCols : 0};
  const OplIn oi = {g_opl, g_nfinal};
  const size_t smem =
      shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, wo.disp_cols, fs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  const FieldIn fi = {field_in, g_field, c_field};
  e = with_field_link<false>(fam, [&](auto fams) {
    constexpr uint32_t kFams = decltype(fams)::value;
    const void* fn;
    const cudaError_t e2 = prepare_rows<true, true, true, true, kFams, true>(n_rows, smem, &fn);
    if (e2 != cudaSuccess) return e2;
    if (n_rows <= kFieldSharedRows)
      trace_seq_bwd_kernel<true, true, true, kFams><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi, fs, fi);
    else
      trace_seq_bwd_kernel<false, true, true, kFams><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, gpx, gpy, gpz, gdx,
          gdy, gdz, gintensity, gmom, cpx, cpy, cpz, cdx, cdy, cdz, cintensity, partials,
          n_slots, n_bundles, gg, maps, map_desc, wavelength, gmaps, n, wo, oi, fs, fi);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The resident blocks per SM of the instantiation that a launch with these
// sizes runs, at its dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
// (n_bounces is K6's; K2 has none.)  `code`: 0 without plate code, 1 with
// it, 2 with it and the extended kinds, 3 with those and dispersion on a
// table with a dispersive row, 4 the instantiation with the path length on
// such a table, 5 the family instantiation on such a table, 6 the field's,
// these two with the families `fam` (kFam* bits) and programs of
// `fuzzy_words` words.
extern "C" int rtt_trace_seq_bwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                           int /*n_bounces*/, int code, int fuzzy_words,
                                           unsigned fam, int* blocks) {
  if (n_rows <= 0 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int disp_cols = code >= 3 ? kDispGradCols : 0;
  const FamSide fs = {nullptr, 0, PhiloxKey{0u, 0u}, nullptr, nullptr, fuzzy_words, nullptr,
                      code >= 5 ? fam : 0u};
  const size_t smem =
      code == 6   ? shared_bytes<true, true, true, true>(n_rows, n_slots, n_bundles, disp_cols, fs)
      : code >= 4 ? shared_bytes<true, true, true>(n_rows, n_slots, n_bundles, disp_cols, fs)
      : code >= 2 ? shared_bytes<true, true>(n_rows, n_slots, n_bundles, disp_cols)
      : code == 1 ? shared_bytes<true, false>(n_rows, n_slots, n_bundles, 0)
                  : shared_bytes<false, false>(n_rows, n_slots, n_bundles, 0);
  const void* fn;
  const cudaError_t e =
      code == 6   ? with_field_link<false>(fam, [&](auto fams) {
                      return prepare_rows<true, true, true, true, decltype(fams)::value, true>(
                          n_rows, smem, &fn);
                    })
      : code == 5 ? with_fam_link(fam, [&](auto fams) {
                      return prepare_rows<true, true, true, true, decltype(fams)::value>(
                          n_rows, smem, &fn);
                    })
      : code == 4 ? prepare_rows<true, true, true, true>(n_rows, smem, &fn)
      : code == 3 ? prepare_rows<true, true, true>(n_rows, smem, &fn)
      : code == 2 ? prepare_rows<true, true, false>(n_rows, smem, &fn)
      : code == 1 ? prepare_rows<true, false, false>(n_rows, smem, &fn)
                  : prepare_rows<false, false, false>(n_rows, smem, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}
