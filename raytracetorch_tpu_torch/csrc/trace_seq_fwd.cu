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
// :1623-1625) and freeform surfaces (its intersect :1567), with every other
// optional stream off (field, scatter draws).  Its plain
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
// The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W; trace_seq_common.cuh::
// fresnel_physics) run in one more instantiation, kFresnel, an overload
// with one more argument (SeqDraws), built on the one with the streams
// (which it takes too), so every other instantiation keeps its code.  A
// FRESNEL row reads the ray's uniform from its stream of the [F][N] draws
// the wrapper pre-draws from the caller's generator (the TPU kernel's
// pre-drawn u_vals, one stream per FRESNEL row in row order): 4 B a ray and
// FRESNEL row more to read.  A REFLECT_W row that a ray misses kills it
// (intensity 0), as core/trace.py::_surface_step does; the TPU kernel's
// chain omits the kill (ROADMAP Queue 3), and this one follows the eager
// chain, so a ghost table (utils/ghosts.py) runs here too.
//
// Thin-film coatings and metal mirrors (coated FRESNEL, FRESNEL_W and
// REFLECT_W rows, metal REFLECT rows; trace_seq_common.cuh, thin_film.cuh)
// run in one more instantiation, kCoat, an overload with one more argument
// (CoatSide, the [K][20] side buffer of the rows' static coating data,
// copied into shared memory after the moment partials), built on the one
// with the Fresnel kinds, so every other instantiation keeps its code.  Per
// coated row and ray it evaluates the stack twice (s and p): per layer a
// sin, a cos and ~30 flops (an absorbing layer adds a complex square root,
// two complex divisions and two exp).
//
// The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA rows, the
// ELLIPSE bound; trace_seq_common.cuh, diffractive.cuh) run in one more
// instantiation, kDiff, an overload with one more argument (DiffKinds),
// built on the one with the coatings (which it takes too, with its side
// buffer), so every other instantiation keeps its code.  Each block writes
// an ELLIPSE row's rotation's cosine and sine into its shared table once
// (ellipse_rows); a DOE row's coefficients are read from the shared table,
// its radial sum a loop of at most 8 terms.
//
// Fuzzy apodization runs in one more instantiation, kFuzzy, an overload
// with one more argument (FuzzyProgs: the traced programs' int32 buffer,
// ops/fuzzy_program.py::pack), built on the one with the diffractive kinds,
// so every other instantiation keeps its code.  Each block copies the
// buffer into shared memory after the side buffer; a row with a program
// multiplies its factor by the program's value at the surface-frame hit
// after its physics (fuzzy.cuh's interpreter: one dispatch an operation,
// its register file in local memory), as _chain_pure multiplies imod by the
// callable's value.
//
// Freeform surfaces (FreeformLens and ZernikeLens faces) run in one more
// instantiation, kFreeform, an overload with one more argument (FfSide: the
// rows' exponent pairs, ops/fused_trace.py::ff_side), built on the one with
// the fuzzy programs, so every other instantiation keeps its code.  Each
// block copies the side buffer into shared memory after the programs; a
// freeform row refines both base-conic roots onto its sag by 8 Newton steps
// and takes its normal from the sag's gradient (freeform.cuh), as
// _chain_pure's intersect (:1567) does through raytracetorch_tpu/core/
// intersect.py:69-79 and :149-156.
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
// aligned after it), the per-warp moment partials, with `coat` (the
// instantiation with the coatings) the side buffer, with the fuzzy
// programs their `fuzzy_words` words, and with `freeform` the rows'
// exponent pairs.
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, bool coat = false,
                    int fuzzy_words = 0, bool freeform = false) {
  return sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                          static_cast<size_t>(kWarps) * n_slots * n_bundles * kMoments +
                          (coat ? static_cast<size_t>(n_rows) * kCoatSide : 0) +
                          static_cast<size_t>(fuzzy_words) +
                          (freeform ? static_cast<size_t>(n_rows) * kFfSide : 0));
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

// The FRESNEL rows' uniforms (kFresnel): n_draws streams of n floats, one
// per FRESNEL row in row order.
struct SeqDraws {
  const float* u;
  int n_draws;
};

// The coated rows' side buffer (kCoat): [K][kCoatSide] floats, the layers'
// extinction and a dispersive metal's knots (ops/fused_trace.py::coat_side).
struct CoatSide {
  const float* side;
};

// The instantiation with the diffractive kinds (kDiff): its overload's tag
// (its rows' data ride the table and the kinds).
struct DiffKinds {
  int unused;
};

// The fuzzy programs (kFuzzy): n_words int32 words (fuzzy.cuh's layout).
struct FuzzyProgs {
  const int32_t* words;
  int n_words;
};

// The freeform rows' exponent pairs (kFreeform): [K][kFfSide] int32 words
// (freeform.cuh's layout).
struct FfSide {
  const int32_t* pw;
};

// The kernel's body, shared by its instantiations (the kernels below).  With
// kStreams (the instantiation with the streams: plate code, the extended
// kinds and dispersion) it also accumulates the optical path length n_cur t
// of each active row and the medium after it (medium_after), and writes the
// streams of `so` that are not null: the position after each row, and each
// row's raw surface-frame hit (every ray's, active or not) with the
// intensity after the row as its weight where the row is active (0 else).
// With kFresnel (which has kStreams) it also runs the Fresnel kinds, a
// FRESNEL row reading the ray's uniform from the next stream of `dr`, and a
// REFLECT_W row kills the rays it does not hold.  With kCoat (which has
// kFresnel) coated and metal rows weigh by their stacks, reading their rows
// of `cs`, copied into shared memory.  With kDiff (which has kCoat) the
// diffractive and ideal kinds and the ELLIPSE bound.  With kFuzzy (which has
// kDiff) the rows with a program in `fp` (copied into shared memory after
// the side buffer) multiply their factor by its value at the hit.  With
// kFreeform (which has kFuzzy) the freeform rows of `ff` (copied into shared
// memory after the programs) refine their roots onto their sags.
template <bool kPlates, bool kExt, bool kStreams, bool kFresnel = false, bool kCoat = false,
          bool kDiff = false, bool kFuzzy = false, bool kFreeform = false>
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
    const float* __restrict__ wavelength, long long n, StreamOut so,
    SeqDraws dr = {nullptr, 0}, CoatSide cs = {nullptr}, FuzzyProgs fp = {nullptr, 0},
    FfSide ff = {nullptr}) {
  static_assert(kStreams || !kFresnel, "the Fresnel kinds run with the streams");
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  int32_t* knd = reinterpret_cast<int32_t*>(tab + n_rows * kRowWidth);
  const int4* knd4 = reinterpret_cast<const int4*>(knd);
  float* warp_mom = tab + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* cside = warp_mom + kWarps * n_mom;  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? n_rows * kCoatSide : 0));
  int32_t* ffs = fzs + (kFuzzy ? fp.n_words : 0);  // kFreeform: the pairs
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
    for (int j = tid; j < n_rows * kCoatSide; j += kThreads) cside[j] = cs.side[j];
  }
  if constexpr (kFuzzy) {
    for (int j = tid; j < fp.n_words; j += kThreads) fzs[j] = fp.words[j];
  }
  if constexpr (kFreeform) {
    for (int j = tid; j < n_rows * kFfSide; j += kThreads) ffs[j] = ff.pw[j];
  }
  __syncthreads();
  if constexpr (kDiff) {
    ellipse_rows(tab, knd, n_rows, tid, kThreads);
    __syncthreads();
  }

  int f = 0;  // kFresnel: the next FRESNEL row's stream
  for (int k = 0; k < n_rows; ++k) {
    const float* r = tab + k * kRowWidth;
    const RowKinds kd = read_row_kinds4<kExt, kCoat>(knd4 + 2 * k);
    const int32_t* ffp = kFreeform ? ff_row_of(ffs, k) : nullptr;
    const RowHit h = intersect_row<kPlates, kExt, kDiff, kFreeform>(r, kd, p, d, ffp);
    const V3 nw = world_normal<kExt, kFreeform>(r, kd.plane, h.hs, nullptr, kd.asph, ffp);
    V3 nd;
    float imod;
    PhysBranch br = {};
    if constexpr (kFresnel) {
      float u = 0.0f;
      if (kd.ph == FRESNEL) {  // warp-uniform
        if (live && f < dr.n_draws) u = dr.u[static_cast<long long>(f) * n + i];
        ++f;
      }
      apply_physics<kPlates, kExt, kExt, true, kCoat, kDiff>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs,
                                                             pl, nd, imod, &br, kd.dispm, u,
                                                             kd.coat, cside + k * kCoatSide);
      if constexpr (kFuzzy) imod = imod * fuzzy_factor(fzs, k, h.hs.x, h.hs.y, h.hs.z);
    } else if constexpr (kStreams)
      apply_physics<kPlates, kExt>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, &br,
                                   kd.dispm);
    else
      apply_physics<kPlates, kExt>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod, nullptr,
                                   kd.dispm);
    const bool active = h.valid && inten > 0.0f;
    const float t = h.t;

    // ---- sensor moments and grid of the incoming intensity ----
    if (kd.sensor) {
      const float w = active ? inten : 0.0f;
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

// The kernel with the streams and the Fresnel kinds.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, SeqDraws dr) {
  static_assert(kPlates && kExt, "the Fresnel kinds run with the extended kinds");
  seq_fwd<kPlates, kExt, true, true>(RTT_SEQ_FWD_ARGS, so, dr);
}

// The kernel with the streams, the Fresnel kinds and the coatings.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, SeqDraws dr, CoatSide cs) {
  static_assert(kPlates && kExt, "the coatings run with the extended kinds");
  seq_fwd<kPlates, kExt, true, true, true>(RTT_SEQ_FWD_ARGS, so, dr, cs);
}

// The kernel with the streams, the Fresnel kinds, the coatings and the
// diffractive kinds.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, SeqDraws dr, CoatSide cs, DiffKinds) {
  static_assert(kPlates && kExt, "the diffractive kinds run with the extended kinds");
  seq_fwd<kPlates, kExt, true, true, true, true>(RTT_SEQ_FWD_ARGS, so, dr, cs);
}

// The kernel with the streams, the Fresnel kinds, the coatings, the
// diffractive kinds and the fuzzy programs.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, SeqDraws dr, CoatSide cs, DiffKinds,
                     FuzzyProgs fp) {
  static_assert(kPlates && kExt, "the fuzzy programs run with the extended kinds");
  seq_fwd<kPlates, kExt, true, true, true, true, true>(RTT_SEQ_FWD_ARGS, so, dr, cs, fp);
}

// The kernel with the streams, the Fresnel kinds, the coatings, the
// diffractive kinds, the fuzzy programs and the freeform surfaces.
template <bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, seq_fwd_min_blocks<kPlates, kExt>())
trace_seq_fwd_kernel(RTT_SEQ_FWD_PARAMS, StreamOut so, SeqDraws dr, CoatSide cs, DiffKinds,
                     FuzzyProgs fp, FfSide ff) {
  static_assert(kPlates && kExt, "the freeform surfaces run with the extended kinds");
  seq_fwd<kPlates, kExt, true, true, true, true, true, true>(RTT_SEQ_FWD_ARGS, so, dr, cs, fp,
                                                             ff);
}

// The types of the seven kernels.
using FwdKernel = void (*)(RTT_SEQ_FWD_PARAMS);
using FwdStreamKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut);
using FwdFresnelKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, SeqDraws);
using FwdCoatKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, SeqDraws, CoatSide);
using FwdDiffKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, SeqDraws, CoatSide, DiffKinds);
using FwdFuzzyKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, SeqDraws, CoatSide, DiffKinds,
                                FuzzyProgs);
using FwdFreeformKernel = void (*)(RTT_SEQ_FWD_PARAMS, StreamOut, SeqDraws, CoatSide, DiffKinds,
                                   FuzzyProgs, FfSide);

#undef RTT_SEQ_FWD_PARAMS
#undef RTT_SEQ_FWD_ARGS

// The kernel of an instantiation.
template <bool kPlates, bool kExt, bool kStreams, bool kFresnel = false, bool kCoat = false,
          bool kDiff = false, bool kFuzzy = false, bool kFreeform = false>
const void* kernel_fn() {
  if constexpr (kFreeform)
    return reinterpret_cast<const void*>(
        static_cast<FwdFreeformKernel>(trace_seq_fwd_kernel<true, true>));
  else if constexpr (kFuzzy)
    return reinterpret_cast<const void*>(
        static_cast<FwdFuzzyKernel>(trace_seq_fwd_kernel<true, true>));
  else if constexpr (kDiff)
    return reinterpret_cast<const void*>(
        static_cast<FwdDiffKernel>(trace_seq_fwd_kernel<true, true>));
  else if constexpr (kCoat)
    return reinterpret_cast<const void*>(
        static_cast<FwdCoatKernel>(trace_seq_fwd_kernel<true, true>));
  else if constexpr (kFresnel)
    return reinterpret_cast<const void*>(
        static_cast<FwdFresnelKernel>(trace_seq_fwd_kernel<true, true>));
  else if constexpr (kStreams)
    return reinterpret_cast<const void*>(
        static_cast<FwdStreamKernel>(trace_seq_fwd_kernel<true, true>));
  else
    return reinterpret_cast<const void*>(
        static_cast<FwdKernel>(trace_seq_fwd_kernel<kPlates, kExt>));
}

// Allow the instantiation its shared memory (beyond 48 KB only on request).
template <bool kPlates, bool kExt, bool kStreams = false, bool kFresnel = false,
          bool kCoat = false, bool kDiff = false, bool kFuzzy = false, bool kFreeform = false>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_fn<kPlates, kExt, kStreams, kFresnel, kCoat, kDiff, kFuzzy,
                                        kFreeform>(),
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
// it and the extended kinds, 4 the one with the streams, 5 the one with the
// Fresnel kinds, 6 the one with the coatings, 7 the one with the diffractive
// kinds, 8 the one with the fuzzy programs, 9 the one with the freeform
// surfaces), its shared memory allowed.
const void* kernel_of(int code, size_t smem, cudaError_t* e) {
  if (code == 9) {
    *e = prepare<true, true, true, true, true, true, true, true>(smem);
    return kernel_fn<true, true, true, true, true, true, true, true>();
  }
  if (code == 8) {
    *e = prepare<true, true, true, true, true, true, true>(smem);
    return kernel_fn<true, true, true, true, true, true, true>();
  }
  if (code == 7) {
    *e = prepare<true, true, true, true, true, true>(smem);
    return kernel_fn<true, true, true, true, true, true>();
  }
  if (code == 6) {
    *e = prepare<true, true, true, true, true>(smem);
    return kernel_fn<true, true, true, true, true>();
  }
  if (code == 5) {
    *e = prepare<true, true, true, true>(smem);
    return kernel_fn<true, true, true, true>();
  }
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
// (n_rows * n, given with `hits`).  `fresnel` nonzero selects the
// instantiation with the Fresnel kinds, which reads `uniforms`, the FRESNEL
// rows' n_draws * n floats ([F][n], one stream per FRESNEL row in row order;
// null with n_draws 0 when no row draws); without it both are ignored.
// `coat_side`, when not null, selects the instantiation with the coatings
// (which also takes the Fresnel kinds and reads `uniforms` so): the
// n_rows * 20 floats of ops/fused_trace.py::coat_side; with it, `diff`
// nonzero selects the one with the diffractive kinds, and with that `fuzzy`,
// when not null, the one with the fuzzy programs: its `fuzzy_words` int32
// words (n_rows to kFuzzyMaxWords; fuzzy.cuh); with that `ff_side`, when not
// null, the one with the freeform surfaces: the rows' n_rows * kFfSide
// int32 words of exponent pairs (freeform.cuh).  Returns a cudaError_t.
extern "C" int rtt_trace_seq_fwd_streams(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, float* opx, float* opy, float* opz, float* odx, float* ody,
    float* odz, float* ointensity, float* partials, int n_slots, int n_bundles, float* grid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* opl, float* n_final, float* paths, float* hits,
    float* hit_w, const float* uniforms, int n_draws, int fresnel, const float* coat_side,
    int diff, const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, long long n,
    void* stream) {
  if (n <= 0) return 0;
  if (diff && coat_side == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (ff_side != nullptr && fuzzy == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (fuzzy != nullptr && (!diff || fuzzy_words < n_rows || fuzzy_words > kFuzzyMaxWords))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fuzzy == nullptr) fuzzy_words = 0;
  if (coat_side != nullptr) fresnel = 1;
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opl == nullptr) != (n_final == nullptr) || (hits == nullptr) != (hit_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fresnel && (n_draws < 0 || (n_draws > 0 && uniforms == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, coat_side != nullptr,
                                  fuzzy_words, ff_side != nullptr);
  const StreamOut so = {opl, n_final, paths, hits, hit_w, nullptr};
  // one launch for the six instantiations: the Fresnel kernel's overload
  // takes the draws as its last argument, the coated one the draws and the
  // side buffer, the diffractive one those and its tag, the fuzzy one those
  // and the programs, the freeform one those and the exponent pairs
  auto go = [&](auto... draws) {
    const cudaError_t e =
        prepare<true, true, true, sizeof...(draws) != 0, sizeof...(draws) >= 2,
                sizeof...(draws) >= 3, sizeof...(draws) >= 4, sizeof...(draws) == 5>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    trace_seq_fwd_kernel<true, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx,
            ody, odz, ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
            maps, map_desc, wavelength, n, so, draws...);
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
// sizes runs (K1 has no bounces: the argument keeps the other kernels'
// signature), at its dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  `code`: 0 without plate
// code, 1 with it, 2 (or 3, as K2's code for a table with a dispersive row)
// with it and the extended kinds, 4 the instantiation with the streams, 5
// the one with the Fresnel kinds, 6 the one with the coatings, 7 the one
// with the diffractive kinds, 8 the one with the fuzzy programs (of
// `fuzzy_words` words), 9 the one with the freeform surfaces (and programs
// of `fuzzy_words` words).  Returns a cudaError_t.
extern "C" int rtt_trace_seq_fwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                           int n_bounces, int code, int fuzzy_words,
                                           int* blocks) {
  (void)n_bounces;
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, code >= 6,
                                   code >= 8 ? fuzzy_words : 0, code == 9);
  cudaError_t e;
  const void* fn = kernel_of(code, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}
