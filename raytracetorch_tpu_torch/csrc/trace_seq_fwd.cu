// Fused sequential forward trace for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::_kernel_v2
// (launched by trace_sequential_pallas_v2, chain body _chain_pure) for the
// main-path kinds, pixelated phase plates, the extended kinds of the
// mixed-surface and asphere scenes and dispersive media, and the
// deterministic streams of _chain_pure (the optical path length, path and
// hit recording), the Fresnel kinds with their pre-drawn uniforms
// (_chain_pure's u_vals), thin-film coatings and metal mirrors
// (apply_physics_one's coated and metal branches), the diffractive and
// ideal elements, component-style fuzzy apodization (_chain_pure
// :1623-1625), freeform surfaces (its intersect :1567) and the polarized
// field of bare interfaces and polarizers (its field streams :544-567, the
// transport :1653-1661, the |E|^2 weights :1632-1633), with every other
// optional stream off (scatter draws).  Its plain
// PyTorch version is ops/fused_trace.py::trace_sequential_fused_plain, and the wrapper that launches it is
// ops/fused_trace.py::trace_seq_fwd_cuda.  With no grid and no plate it is
// also the counterpart of the first TPU kernel, _kernel (launched by
// trace_sequential_pallas, ops/fused_trace.py::trace_sequential_v1): the same
// function with every stream off.
//
// What it computes, per ray, for each of the K table rows in order:
// intersect (plane fast path or the quadric solver), surface-local bound per
// root, the minimum positive root above the world-scale epsilon, volume
// bound, normal, physics, and the masked update where(active, new, old) with
// active = valid & intensity > 0.  On sensor rows it adds the 7 moment terms
// (w, wx, wy, wx^2, wy^2, wxy, w>0) of the masked INCOMING intensity into
// (slot, bundle) and, when a grid is asked for, bins that intensity at the
// hit's cell of the slot's irradiance grid (kernel K3's device function,
// grid_bin.cuh; the TPU kernel's _grid_accumulate).  A PHASE_GRID row reads
// the four corners of its [H, W] phase map at the hit (kernel K4's device
// functions, grid_corners.cuh; the TPU kernel's _grid_corners_mxu) and the
// ray's wavelength.
//
// Design: one thread per ray, 256 threads per block, the ragged edge masked
// with i < n (no padding copy).  Each thread issues its ray's loads first,
// then the block copies the flat [K, 160] table and the int32 [K, 8] kinds
// into shared memory, so the loads' latency overlaps the copy and the
// barrier.  Every thread visits the same row at the same time, so the
// switch on a row's kinds (read as two 128-bit loads) is warp-uniform and
// costs no divergence.  Moments: a sensor row's 7 sums over the warp by one
// transpose reduce-scatter (9 shuffles, where 7 warp sums take 35), then one
// partial per warp in shared memory, then one per block summed in fixed warp
// order into a [blocks, S, B, 7] buffer that the wrapper sums.  No atomics:
// the moments are deterministic.  The grid takes one atomicAdd per sensor
// hit into the [S, H, W] grid in device memory (grid_bin.cu says what that
// costs); with no grid the pointer is null and nothing else changes.  The
// phase maps stay in device memory, concatenated, read through L2 (a 256 x
// 256 map is 256 KB); with no plate (and no RECT bound, which is plate
// code too: trace_seq_common.cuh) their pointer is null and the kernel
// instantiated without plate code (kPlates = false) runs, so such a scene
// runs the instructions it ran before plates existed.  A scene with the
// extended kinds (an even asphere, VB_RECT, VB_CYL_EDGE, VB_HALFSPACES,
// SB_CONE_NAPPE, a dispersive medium; the caller's `ext`) runs a third
// instantiation, with plate code and kExt: the asphere's Halley refinement
// in the intersection and its normal, a solid's half-spaces (the TPU
// kernel's scalar plane reads, :613-614) and a cone's nappe in the bounds,
// and a dispersive row's indices at the ray's wavelength
// (trace_seq_common.cuh).  It has registers of its own
// (kSeqFwdExtMinBlocks).
//
// What bounds it: per ray it reads 8 streams (32 B; the wavelength stream,
// 4 B more, only with plate code) and writes 7 (28 B): 60 MB at 1M rays, ~18 us
// at the H100's 3.35 TB/s.  It runs at about 3.4x that, bound by the
// instructions it issues, as measured on an H100 (PERF.md): 24 more
// independent FFMAs a row made it 6-8% slower (K5, whose rows wait on their
// dependent chain, did not notice as many).  So the design cuts
// instructions and keeps more warps: 5 blocks an SM without plate code
// (kSeqFwdMinBlocks; 48 registers, with the sensor row's sizes read inside
// its branch so no register holds them across the row loop; 57 registers
// and 4 blocks before), the kinds in two loads, the moments' sums in 9
// shuffles.  Measured and not kept: persistent blocks that stage each tile
// of rays in shared memory with cp.async while the tile before traces (5-7%
// slower), K5's packed scan records (building them costs what reading them
// saves), copying only the row columns the kinds read.
//
// The streams (the caller's track_opl, record_paths, record_hits) run in an
// instantiation of their own, kStreams, an overload of the kernel with one
// more argument (StreamOut), built on the extended one (plate code, the
// extended kinds, dispersion: it takes every scene), so every other
// instantiation keeps its code.  Per active row it adds n_cur t to the path
// length and takes the medium after the row from the refraction's own
// decisions (trace_seq_common.cuh::medium_after); the records go out planar,
// [K + 1][3][N] positions and [K][3][N] hits, so that a warp's stores
// coalesce.  They are bytes: the path length and the medium add 8 B a ray to
// the 64 B it moves, the positions 12 B a row plus the launch's, the hits
// 16 B a row: ~220 B a ray on the 5-row bench scene with both records, ~380
// B on the 11-row Cooke triplet.
//
// The families of kinds run in one more instantiation, the family
// instantiation: an overload of the kernel with one more argument than the
// streams' (FamSide: the families' side data and the runtime word `fam`
// that says which families the table has, trace_seq_common.cuh), built on
// the one with the streams, so every other instantiation keeps its code.
// It compiles every family together, so a table may mix them (a GRIN rod
// beside a coated lens and a DOE, as the TPU kernel's chain runs them); a
// family the table lacks skips its block setup and passes a null buffer.
// A table that the chain of family links took before the collapse (one
// family, with the families the link was built on: the Fresnel kinds; the
// coatings; the diffractive kinds; the fuzzy programs; GRIN rods alone)
// runs the same overload instantiated for that link's family set (a
// template argument, trace_seq_common.cuh::fam_link): carrying every
// family's code, the family instantiation ran such tables 1.1-2.2x slower
// (PERF.md, the collapse's A/B); freeform tables, which the last link took with
// every family below it, and every mix run the family instantiation.
//
// - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W; trace_seq_common.cuh::
//   fresnel_physics): a FRESNEL row reads the ray's uniform from its stream
//   of the [F][N] draws the wrapper pre-draws from the caller's generator
//   (the TPU kernel's pre-drawn u_vals, one stream per FRESNEL row in row
//   order): 4 B a ray and FRESNEL row more to read.  A REFLECT_W row that a
//   ray misses kills it (intensity 0), as core/trace.py::_surface_step does;
//   the TPU kernel's chain omits the kill (ROADMAP Queue 3), and this one
//   follows the eager chain, so a ghost table (utils/ghosts.py) runs here
//   too.
// - Thin-film coatings and metal mirrors (coated FRESNEL, FRESNEL_W and
//   REFLECT_W rows, metal REFLECT rows; trace_seq_common.cuh,
//   thin_film.cuh): the [K][20] side buffer of the rows' static coating
//   data is copied into shared memory after the moment partials.  Per
//   coated row and ray the stack is evaluated twice (s and p): per layer a
//   sin, a cos and ~30 flops (an absorbing layer adds a complex square root,
//   two complex divisions and two exp).
// - The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA rows,
//   the ELLIPSE bound; trace_seq_common.cuh, diffractive.cuh): each block
//   writes an ELLIPSE row's rotation's cosine and sine into its shared table
//   once (ellipse_rows); a DOE row's coefficients are read from the shared
//   table, its radial sum a loop of at most 8 terms.
// - Fuzzy apodization: each block copies the traced programs' int32 buffer
//   (ops/fuzzy_program.py::pack) into shared memory after the side buffer;
//   a row with a program multiplies its factor by the program's value at
//   the surface-frame hit after its physics (fuzzy.cuh's interpreter: one
//   dispatch an operation, its register file in local memory), as
//   _chain_pure multiplies imod by the callable's value.
// - Freeform surfaces (FreeformLens and ZernikeLens faces): each block
//   copies the rows' exponent pairs (ops/fused_trace.py::ff_side) into
//   shared memory after the programs; a freeform row refines both
//   base-conic roots onto its sag by 8 Newton steps and takes its normal
//   from the sag's gradient (freeform.cuh), as _chain_pure's intersect
//   (:1567) does through raytracetorch_tpu/core/intersect.py:69-79 and
//   :149-156.
// - GRIN rods (grin.cuh): a rod's data ride its flat row and its RK4 step
//   count its kinds row's last column.  A GRIN row's active rays (valid,
//   intensity > 0, travelling +z in the rod's frame) run the whole rod, out
//   of line (grin_rod): the entry coupling, the RK4 steps, the exit
//   coupling; the ray lands at the exit face, its intensity times 1 or 0,
//   the path length adds n_cur t + the in-medium path and the medium
//   becomes the ambient index; the records take the exit-face position as
//   the row's position and hit, with weight 0 (_chain_pure :1569-1604).
//
// The polarized field (track_field) runs in one more instantiation, kField,
// an overload with one more argument (FieldIO: the launch field and the
// final field, [6][N] planar: the real parts of x, y, z, then the imaginary
// ones), which compiles every family but GRIN rods (the field through a rod
// is not in the kernels yet: the wrapper refuses it, ROADMAP Queue 1
// position 4b), so every other instantiation keeps its code.  Each thread
// carries its ray's six field floats through the rows: the Fresnel kinds,
// bare or coated, draw and weigh with the polarized reflectance (and an
// absorbing stack's transmittance) of the incoming field
// (trace_seq_common.cuh::fresnel_physics with kField), a metal mirror
// weighs by its polarized R (field_physics), a sensor row's moments and
// grid take w * |E|^2, and an active row transports the field
// (field.cuh::field_transport; a coated interface and a metal mirror with
// their stacks' amplitudes, from the one evaluation per polarization,
// thin_film.cuh::stack_field, that the draw or weight read).  It reads and
// writes 48 B a ray more than the family instantiation.
//
// Numerics: fp32 throughout, built without --use_fast_math, so sqrt and
// division are IEEE-rounded and denormals are kept, which the epsilon rules
// rely on (finite BIG sentinels for misses, +1e-24 under every sqrt, the
// self-intersection epsilon INTERSECT_EPS + REL_EPS * |world scale|).
// Multiply-add contraction is left to nvcc's default (on).

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

using namespace rtt;

namespace {

// Resident blocks of kThreads per SM that the instantiations are capped
// for (__launch_bounds__): without plate code 48 registers a thread, with
// it 64 (at 48 it spills); with the extended kinds 85 (77 used, no spill;
// 12% faster than at 2 blocks, PERF.md).
constexpr int kSeqFwdMinBlocks = 5;
constexpr int kSeqFwdPlateMinBlocks = 4;
constexpr int kSeqFwdExtMinBlocks = 3;

template <bool kPlates, bool kExt>
__host__ __device__ constexpr int seq_fwd_min_blocks() {
  return kExt ? kSeqFwdExtMinBlocks : kPlates ? kSeqFwdPlateMinBlocks : kSeqFwdMinBlocks;
}

// The dynamic shared memory of a launch: the flat table, its kinds (16-byte
// aligned after it), the per-warp moment partials and, in the family and
// field instantiations, the side data of the families `fs` has: the side
// buffer, the fuzzy programs' words and the rows' exponent pairs.
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, const FamSide& fs = {}) {
  return sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                          static_cast<size_t>(kWarps) * n_slots * n_bundles * kMoments +
                          static_cast<size_t>(fam_coat_words(fs, n_rows)) +
                          static_cast<size_t>(fam_fuzzy_words(fs)) +
                          static_cast<size_t>(fam_ff_words(fs, n_rows)));
}

// A row's kinds from its 8 ints in shared memory, 16-byte aligned: two
// 128-bit loads (as read_row_kinds reads them).
template <bool kExt, bool kCoat = false>
__device__ __forceinline__ RowKinds read_row_kinds4(const int4* kd) {
  const int4 a = kd[0], b = kd[1];
  const int k[kKindWidth] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return read_row_kinds<kExt, kExt, kCoat>(k);
}

// The sums over the warp's 32 lanes of each lane's 8 values v: a transpose
// reduce-scatter (4, 2 and 1 shuffles each halve the values a lane holds,
// two more finish the sums), 9 shuffles where 8 warp_sums take 40.  Every
// lane gets the sum of value (lane >> 2) & 7.  Each sum adds the same pairs
// in the same tree as warp_sum's (lanes 16 apart, then 8, 4, 2, 1), so it
// equals warp_sum's bit for bit.
__device__ __forceinline__ float warp_sums8(const float (&v)[8], int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = (h16 ? v[j + 4] : v[j]) + __shfl_xor_sync(kFull, h16 ? v[j] : v[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    b[j] = (h8 ? a[j + 2] : a[j]) + __shfl_xor_sync(kFull, h8 ? a[j] : a[j + 2], 8);
  float c = (h4 ? b[1] : b[0]) + __shfl_xor_sync(kFull, h4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFull, c, 2);
  c += __shfl_xor_sync(kFull, c, 1);
  return c;
}

// The field (kField): the launch field `in` and the final field `out`,
// [6][n] floats each (Er x, y, z, then Ei x, y, z).
struct FieldIO {
  const float* in;
  float* out;
};

// The kernel's body, shared by its instantiations (the kernels below).  With
// kStreams (the instantiation with the streams: plate code, the extended
// kinds and dispersion) it also accumulates the optical path length n_cur t
// of each active row and the medium after it (medium_after), and writes the
// streams of `so` that are not null: the position after each row, and each
// row's raw surface-frame hit (every ray's, active or not) with the
// intensity after the row as its weight where the row is active (0 else).
// The family flags (each with kStreams) compile a family of kinds in, and
// the runtime word fs.fam says which of them the table has
// (trace_seq_common.cuh): with kFresnel the Fresnel kinds, a FRESNEL row
// reading the ray's uniform from the next stream of fs.u, and a REFLECT_W
// row kills the rays it does not hold; with kCoat coated and metal rows
// weigh by their stacks, reading their rows of fs.coat, copied into shared
// memory; with kDiff the diffractive and ideal kinds and the ELLIPSE bound;
// with kFuzzy the rows with a program in fs.fuzzy (copied into shared
// memory after the side buffer) multiply their factor by its value at the
// hit; with kFreeform the freeform rows of fs.ff (copied into shared memory
// after the programs) refine their roots onto their sags; with kGrin a GRIN
// row's active rays run the rod (grin_row).  With kField (which has every
// family flag but kGrin) each ray carries its field from `fio.in`
// (field_physics, the |E|^2 weights, field_transport) to `fio.out`.
template <bool kPlates, bool kExt, bool kStreams, bool kFresnel = false, bool kCoat = false,
          bool kDiff = false, bool kFuzzy = false, bool kFreeform = false, bool kField = false,
          bool kGrin = false>
__device__ __forceinline__ void seq_fwd(
    const float* __restrict__ table, const int32_t* __restrict__ kinds, int n_rows,
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
    float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
    float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
    float* __restrict__ ointensity, float* __restrict__ partials, int n_slots, int n_bundles,
    float* __restrict__ grid, int grid_h, int grid_w, float grid_e,
    const float* __restrict__ maps, const int32_t* __restrict__ map_desc,
    const float* __restrict__ wavelength, long long n, StreamOut so, FamSide fs = {},
    FieldIO fio = {nullptr, nullptr}) {
  static_assert(kStreams || !kFresnel, "the Fresnel kinds run with the streams");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(kFreeform || !kField, "the field runs with the freeform surfaces");
  static_assert(!kGrin || kStreams, "GRIN rods run with the streams");
  static_assert(!(kGrin && kField), "the field through a GRIN rod is not in the kernels");
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  int32_t* knd = reinterpret_cast<int32_t*>(tab + n_rows * kRowWidth);
  const int4* knd4 = reinterpret_cast<const int4*>(knd);
  float* warp_mom = tab + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* cside = warp_mom + kWarps * n_mom;  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? fam_coat_words(fs, n_rows) : 0));
  int32_t* ffs = fzs + (kFuzzy ? fam_fuzzy_words(fs) : 0);  // kFreeform: the pairs
  const bool fuzzy = kFuzzy && (fs.fam & kFamFuzzy);
  const bool freeform = kFreeform && (fs.fam & kFamFreeform);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // The ray's loads go out first, so that their latency overlaps the copy
  // of the table into shared memory and the barrier.  Threads past the
  // ragged edge trace a zero ray of zero intensity: every step stays
  // finite, and they contribute nothing to the moments.
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  V3 p = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
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
      fe.r = {fio.in[i], fio.in[n + i], fio.in[2 * n + i]};
      fe.i = {fio.in[3 * n + i], fio.in[4 * n + i], fio.in[5 * n + i]};
    }
  }
  // the streams: the path length, the medium (index 1 at launch)
  float opl = 0.0f, n_cur = 1.0f;
  if constexpr (kStreams) {
    if (live && so.paths != nullptr) {
      so.paths[i] = p.x;
      so.paths[n + i] = p.y;
      so.paths[2 * n + i] = p.z;
    }
  }

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < kWarps * n_mom; j += kThreads) warp_mom[j] = 0.0f;
  if constexpr (kCoat) {
    for (int j = tid; j < fam_coat_words(fs, n_rows); j += kThreads) cside[j] = fs.coat[j];
  }
  if constexpr (kFuzzy) {
    for (int j = tid; j < fam_fuzzy_words(fs); j += kThreads) fzs[j] = fs.fuzzy[j];
  }
  if constexpr (kFreeform) {
    for (int j = tid; j < fam_ff_words(fs, n_rows); j += kThreads) ffs[j] = fs.ff[j];
  }
  __syncthreads();
  if constexpr (kDiff) {
    if (fs.fam & kFamDiff) {  // uniform across the block
      ellipse_rows(tab, knd, n_rows, tid, kThreads);
      __syncthreads();
    }
  }

  int f = 0;  // kFresnel: the next FRESNEL row's stream
  for (int k = 0; k < n_rows; ++k) {
    const float* r = tab + k * kRowWidth;
    const RowKinds kd = read_row_kinds4<kExt, kCoat>(knd4 + 2 * k);
    if constexpr (kGrin) {
      if (kd.ph == GRIN) {  // warp-uniform: the rod is the row's interaction
        GrinExit ge;
        float t;
        if (grin_row<kPlates>(r, kd, p, d, inten, ge, t)) {
          opl = opl + (n_cur * t + ge.seg);
          n_cur = r[kPh];
        }
        if (live && so.paths != nullptr) {
          float* dst = so.paths + 3 * (k + 1) * n + i;
          dst[0] = p.x;
          dst[n] = p.y;
          dst[2 * n] = p.z;
        }
        if (live && so.hits != nullptr) {
          float* dst = so.hits + 3 * k * n + i;
          dst[0] = p.x;
          dst[n] = p.y;
          dst[2 * n] = p.z;
          so.hit_w[k * n + i] = 0.0f;
        }
        continue;
      }
    }
    const int32_t* ffp = freeform ? ff_row_of(ffs, k) : nullptr;
    const RowHit h = intersect_row<kPlates, kExt, kDiff, kFreeform>(r, kd, p, d, ffp);
    const V3 nw = world_normal<kExt, kFreeform>(r, kd.plane, h.hs, nullptr, kd.asph, ffp);
    V3 nd;
    float imod;
    PhysBranch br = {};
    FieldStack fst;  // kField: a coated or metal row's stack, for the transport
    if constexpr (kFresnel) {
      float u = 0.0f;
      if (kd.ph == FRESNEL) {  // warp-uniform
        if (live && f < fs.n_draws) u = fs.u[static_cast<long long>(f) * n + i];
        ++f;
      }
      if constexpr (kField)
        field_physics<kExt, kDiff>(r, kd, d, nw, h.hs, pl, u, fe, cside + k * kCoatSide, nd, imod,
                                   &br, fst);
      else
        apply_physics<kPlates, kExt, kExt, true, kCoat, kDiff>(r, kd.ph, kd.sb, kd.map, d, nw,
                                                               h.hs, pl, nd, imod, &br, kd.dispm,
                                                               u, kd.coat,
                                                               cside + k * kCoatSide);
      if (fuzzy) imod = imod * fuzzy_factor(fzs, k, h.hs.x, h.hs.y, h.hs.z);
    } else if constexpr (kStreams)
      apply_physics<kPlates, kExt>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, &br,
                                   kd.dispm);
    else
      apply_physics<kPlates, kExt>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, nullptr,
                                   kd.dispm);
    const bool active = h.valid && inten > 0.0f;
    const float t = h.t;
    // kField: the incoming |E|^2 weighs a sensor row's moments; an active
    // row transports the field here, where a stack's amplitudes die
    float pw = 1.0f;
    if constexpr (kField) {
      pw = fpower(fe);
      if (active) fe = field_transport(field_row<kExt>(r, kd, d, nd, nw, imod, pl.wl, fst), fe);
    }

    // ---- sensor moments and grid of the incoming intensity ----
    if (kd.sensor) {
      float w = active ? inten : 0.0f;
      if constexpr (kField) w = w * pw;
      const float x = h.hs.x, y = h.hs.y;
      const float terms[kMoments] = {w,         w * x,     w * y, w * x * x,
                                     w * y * y, w * x * y, w > 0.0f ? 1.0f : 0.0f};
      // the sizes enter here, at a sensor row: the empty asm keeps the
      // compiler from computing what depends on them before the row loop
      // and holding it in registers across it
      int nb = n_bundles, nm = n_mom;
      asm volatile("" : "+r"(nb), "+r"(nm));
      float* dst = warp_mom + warp * nm + kd.slot * nb * kMoments;
      const int e = (lane >> 2) & 7;
      for (int b = 0; b < nb; ++b) {
        float v[8];
#pragma unroll
        for (int m = 0; m < kMoments; ++m) v[m] = rid == b ? terms[m] : 0.0f;
        v[7] = 0.0f;
        const float s = warp_sums8(v, lane);
        if ((lane & 3) == 0 && e < kMoments) dst[b * kMoments + e] += s;
      }
      if (grid != nullptr) {
        int gh = grid_h, gw = grid_w;
        float ge = grid_e;
        asm volatile("" : "+r"(gh), "+r"(gw), "+f"(ge));
        grid_add(grid, kd.slot, x, y, w, gh, gw, ge);
      }
    }

    if constexpr (kStreams) {
      if (active) {
        opl = opl + n_cur * t;
        n_cur = medium_after<kExt, kFresnel, kDiff>(r, kd, br.from_in, br.tir, pl.wl, n_cur,
                                                    br.reflect);
      }
    }
    if (active) {
      p = fma3(p, t, d);
      d = nd;
      inten = inten * imod;
    } else if (kFresnel && kd.ph == REFLECT_W) {
      inten = 0.0f;  // a ray that misses a ghost's reflection leaves its path
    }
    if constexpr (kStreams) {
      if (live && so.paths != nullptr) {
        float* dst = so.paths + 3 * (k + 1) * n + i;
        dst[0] = p.x;
        dst[n] = p.y;
        dst[2 * n] = p.z;
      }
      if (live && so.hits != nullptr) {
        float* dst = so.hits + 3 * k * n + i;
        dst[0] = h.hs.x;
        dst[n] = h.hs.y;
        dst[2 * n] = h.hs.z;
        so.hit_w[k * n + i] = active ? inten : 0.0f;
      }
    }
  }

  if (live) {
    opx[i] = p.x;
    opy[i] = p.y;
    opz[i] = p.z;
    odx[i] = d.x;
    ody[i] = d.y;
    odz[i] = d.z;
    ointensity[i] = inten;
    if constexpr (kStreams) {
      if (so.opl != nullptr) {
        so.opl[i] = opl;
        so.n_final[i] = n_cur;
      }
    }
    if constexpr (kField) {
      const float v[6] = {fe.r.x, fe.r.y, fe.r.z, fe.i.x, fe.i.y, fe.i.z};
#pragma unroll
      for (int j = 0; j < 6; ++j) fio.out[j * n + i] = v[j];
    }
  }

  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_mom;
  for (int j = tid; j < n_mom; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_mom[w * n_mom + j];
    out[j] = s;
  }
}

#define RTT_SEQ_FWD_PARAMS                                                                      \
  const float *__restrict__ table, const int32_t *__restrict__ kinds, int n_rows,               \
      const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,  \
      const float *__restrict__ dx, const float *__restrict__ dy, const float *__restrict__ dz,  \
      const float *__restrict__ intensity, const int32_t *__restrict__ ray_id,                  \
      float *__restrict__ opx, float *__restrict__ opy, float *__restrict__ opz,                \
      float *__restrict__ odx, float *__restrict__ ody, float *__restrict__ odz,                \
      float *__restrict__ ointensity, float *__restrict__ partials, int n_slots, int n_bundles, \
      float *__restrict__ grid, int grid_h, int grid_w, float grid_e,                           \
      const float *__restrict__ maps, const int32_t *__restrict__ map_desc,                     \
      const float *__restrict__ wavelength, long long n
#define RTT_SEQ_FWD_ARGS                                                                        \
  table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx, ody, odz, \
      ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps, map_desc,   \
      wavelength, n

// The kernel without the streams: with or without plate code, with or
// without the extended kinds.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS) {
  seq_fwd<kPlates, kExt, false>(RTT_SEQ_FWD_ARGS, StreamOut{});
}

// The kernel with the streams (plate code, the extended kinds, dispersion).
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so) {
  static_assert(kPlates && kExt, "the streams run with the extended kinds");
  seq_fwd<kPlates, kExt, true>(RTT_SEQ_FWD_ARGS, so);
}

// The family instantiation (kFams = kFamAll; kFamGrin for GRIN rods alone):
// the streams and the families of kFams, which the table has reading
// fs.fam.
template <bool kPlates, bool kExt, uint32_t kFams = kFamAll>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, FamSide fs) {
  static_assert(kPlates && kExt, "the families run with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  seq_fwd<kPlates, kExt, true, kF, kC, kD, kZ, kFF, false,
          fam_has(kFams, kFamGrin)>(RTT_SEQ_FWD_ARGS, so, fs);
}

// The field's instantiation: the streams, the families of kFams (every
// family but GRIN rods) and the field.
template <bool kPlates, bool kExt, uint32_t kFams = kFamField>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, FamSide fs, FieldIO fio) {
  static_assert(kPlates && kExt, "the field runs with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  seq_fwd<kPlates, kExt, true, kF, kC, kD, kZ, kFF, true>(RTT_SEQ_FWD_ARGS, so, fs, fio);
}

// The types of the five kernels.
using FwdKernel = void (*)(RTT_SEQ_FWD_PARAMS);
using FwdStreamKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut);
using FwdFamKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, FamSide);
using FwdFieldKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, FamSide, FieldIO);

#undef RTT_SEQ_FWD_PARAMS
#undef RTT_SEQ_FWD_ARGS

// The kernel of an instantiation: without the streams (kPlates, kExt), with
// them (kStreams), the family instantiation of the families kFams or the
// field's (kField).
template <bool kPlates, bool kExt, bool kStreams = false, uint32_t kFams = 0u,
          bool kField = false>
const void* kernel_fn() {
  if constexpr (kField)
    return reinterpret_cast<const void*>(
        static_cast<FwdFieldKernel>(trace_seq_fwd_kernel<true, true, kFams>));
  else if constexpr (kFams != 0u)
    return reinterpret_cast<const void*>(
        static_cast<FwdFamKernel>(trace_seq_fwd_kernel<true, true, kFams>));
  else if constexpr (kStreams)
    return reinterpret_cast<const void*>(
        static_cast<FwdStreamKernel>(trace_seq_fwd_kernel<true, true>));
  else
    return reinterpret_cast<const void*>(
        static_cast<FwdKernel>(trace_seq_fwd_kernel<kPlates, kExt>));
}

// Allow the instantiation its shared memory (beyond 48 KB only on request).
template <bool kPlates, bool kExt, bool kStreams = false, uint32_t kFams = 0u,
          bool kField = false>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_fn<kPlates, kExt, kStreams, kFams, kField>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kPlates, bool kExt>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           float* const* outs, float* partials, int n_slots, int n_bundles, float* grid,
           int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
           const float* wavelength, long long n) {
  const cudaError_t e = prepare<kPlates, kExt>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trace_seq_fwd_kernel<kPlates, kExt><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
      ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials, n_slots,
      n_bundles, grid, grid_h, grid_w, grid_e, maps, map_desc, wavelength, n);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of `code` (0 without plate code, 1 with it, 2 or 3 with
// it and the extended kinds, 4 the one with the streams, 5 the family
// instantiation for the families `fam`, 6 the field's), its shared memory
// allowed.
const void* kernel_of(int code, uint32_t fam, size_t smem, cudaError_t* e) {
  if (code == 6) {
    *e = prepare<true, true, true, kFamField, true>(smem);
    return kernel_fn<true, true, true, kFamField, true>();
  }
  if (code == 5)
    return with_fam_link(fam, [&](auto fams) {
      constexpr uint32_t kFams = decltype(fams)::value;
      *e = prepare<true, true, true, kFams>(smem);
      return kernel_fn<true, true, true, kFams>();
    });
  if (code == 4) {
    *e = prepare<true, true, true>(smem);
    return kernel_fn<true, true, true>();
  }
  if (code >= 2) {
    *e = prepare<true, true>(smem);
    return kernel_fn<true, true, false>();
  }
  if (code == 1) {
    *e = prepare<true, false>(smem);
    return kernel_fn<true, false, false>();
  }
  *e = prepare<false, false>(smem);
  return kernel_fn<false, false, false>();
}

// The side data of a family or field launch from its C arguments, checked:
// -> cudaSuccess or cudaErrorInvalidValue.  Each buffer is given exactly
// when its family's bit is set (the uniforms also with no FRESNEL row that
// draws: null with n_draws 0), the programs with n_rows to kFuzzyMaxWords
// words.
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

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer: 7 outputs of n floats, a partials buffer of
// ceil(n / 256) * n_slots * n_bundles * 7 floats, and the zeroed
// [n_slots, grid_h, grid_w] grid over [-grid_e, grid_e]^2, or null for no
// grid.  With phase plates, `maps` holds their maps one after the other,
// `map_desc` (offset, h, w) per map, and `wavelength` the n rays'
// wavelengths.  All three null selects the instantiation without plate code,
// which the caller must not give a PHASE_GRID row or a RECT bound.  `ext`
// nonzero selects the instantiation with the extended kinds, which the
// caller must give (for its plate code) `maps` and the rest, a PHASE_GRID
// row or not; with `ext` zero the caller must not give it an extended kind.
extern "C" int rtt_trace_seq_fwd(const float* table, const int32_t* kinds, int n_rows,
                                 const float* px, const float* py, const float* pz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* intensity, const int32_t* ray_id, float* opx,
                                 float* opy, float* opz, float* odx, float* ody, float* odz,
                                 float* ointensity, float* partials, int n_slots, int n_bundles,
                                 float* grid, int grid_h, int grid_w, float grid_e,
                                 const float* maps, const int32_t* map_desc,
                                 const float* wavelength, int ext, long long n, void* stream) {
  if (n <= 0) return 0;
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ext && maps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  float* outs[7] = {opx, opy, opz, odx, ody, odz, ointensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ext)
    return launch<true, true>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                              partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps,
                              map_desc, wavelength, n);
  if (maps != nullptr)
    return launch<true, false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                               partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps,
                               map_desc, wavelength, n);
  return launch<false, false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                              partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, nullptr,
                              nullptr, nullptr, n);
}

// Launches the instantiation with the streams on `stream`: the arguments of
// rtt_trace_seq_fwd (its `ext` implied: `maps`, `map_desc` and `wavelength`
// must be given, a PHASE_GRID row or not), then the stream outputs, each
// null when not wanted: `opl` and `n_final` (n floats each), `paths`
// ((n_rows + 1) * 3 * n floats), `hits` (n_rows * 3 * n) and `hit_w`
// (n_rows * n, given with `hits`), then the families: `fam` nonzero (kFam*
// bits, the families the table has) selects the family instantiation,
// which reads `uniforms`, the FRESNEL rows' n_draws * n floats ([F][n], one
// stream per FRESNEL row in row order; null with n_draws 0 when no row
// draws), `coat_side`, the n_rows * 20 floats of ops/fused_trace.py::
// coat_side (with kFamCoat), `fuzzy`, the programs' `fuzzy_words` int32
// words (n_rows to kFuzzyMaxWords; fuzzy.cuh; with kFamFuzzy), and
// `ff_side`, the rows' n_rows * kFfSide int32 words of exponent pairs
// (freeform.cuh; with kFamFreeform), each null where its family's bit is
// clear.  A GRIN row's RK4 step count (1..kMaxGrinSteps) is its kinds
// row's last column.  Returns a cudaError_t.
extern "C" int rtt_trace_seq_fwd_streams(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, float* opx, float* opy, float* opz, float* odx, float* ody,
    float* odz, float* ointensity, float* partials, int n_slots, int n_bundles, float* grid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* opl, float* n_final, float* paths, float* hits,
    float* hit_w, const float* uniforms, int n_draws, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam, long long n,
    void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(uniforms, n_draws, coat_side, fuzzy, fuzzy_words, ff_side, fam,
                           n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opl == nullptr) != (n_final == nullptr) || (hits == nullptr) != (hit_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, fs);
  const StreamOut so = {opl, n_final, paths, hits, hit_w, nullptr};
  const unsigned g = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fam == 0) {
    e = prepare<true, true, true>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    trace_seq_fwd_kernel<true, true><<<g, kThreads, smem, s>>>(
        table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx, ody,
        odz, ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps,
        map_desc, wavelength, n, so);
  } else {
    // the instantiation of the families' set (fam_link)
    e = with_fam_link(fam, [&](auto fams) {
      constexpr uint32_t kFams = decltype(fams)::value;
      const cudaError_t e2 = prepare<true, true, true, kFams>(smem);
      if (e2 != cudaSuccess) return e2;
      trace_seq_fwd_kernel<true, true, kFams><<<g, kThreads, smem, s>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx,
          ody, odz, ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps,
          map_desc, wavelength, n, so, fs);
      return cudaSuccess;
    });
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the instantiation with the field on `stream`: the arguments of
// rtt_trace_seq_fwd_streams (whose `fam` must not hold kFamGrin), then
// `field_in`, the launch field, and `field_out`, the final field (6 * n
// floats each, [6][n]: Er x, y, z, then Ei x, y, z).  Returns a
// cudaError_t.
extern "C" int rtt_trace_seq_fwd_field(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, float* opx, float* opy, float* opz, float* odx, float* ody,
    float* odz, float* ointensity, float* partials, int n_slots, int n_bundles, float* grid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* opl, float* n_final, float* paths, float* hits,
    float* hit_w, const float* uniforms, int n_draws, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam,
    const float* field_in, float* field_out, long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  cudaError_t e = fam_side(uniforms, n_draws, coat_side, fuzzy, fuzzy_words, ff_side, fam,
                           n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((fam & kFamGrin) || field_in == nullptr || field_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opl == nullptr) != (n_final == nullptr) || (hits == nullptr) != (hit_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, fs);
  e = prepare<true, true, true, kFamField, true>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trace_seq_fwd_kernel<true, true, kFamField>
      <<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx,
          ody, odz, ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps,
          map_desc, wavelength, n, StreamOut{opl, n_final, paths, hits, hit_w, nullptr}, fs,
          FieldIO{field_in, field_out});
  return static_cast<int>(cudaGetLastError());
}

// The resident blocks per SM of the instantiation that a launch with these
// sizes runs (K1 has no bounces: the argument keeps the other kernels'
// signature), at its dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  `code`: 0 without plate
// code, 1 with it, 2 (or 3, as K2's code for a table with a dispersive row)
// with it and the extended kinds, 4 the instantiation with the streams, 5
// the family instantiation, 6 the field's, these two with the families
// `fam` (kFam* bits) and programs of `fuzzy_words` words.  Returns a
// cudaError_t.
extern "C" int rtt_trace_seq_fwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                           int n_bounces, int code, int fuzzy_words,
                                           unsigned fam, int* blocks) {
  (void)n_bounces;
  const FamSide fs = {nullptr, 0, PhiloxKey{0u, 0u}, nullptr, nullptr, fuzzy_words, nullptr,
                      code >= 5 ? fam : 0u};
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, fs);
  cudaError_t e;
  const void* fn = kernel_of(code, fs.fam, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}
