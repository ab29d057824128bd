// Fused non-sequential forward trace for Hopper (sm_90a): kernel K5, the
// whole bounce loop per ray.
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_nonseq (launched by trace_nonseq_pallas, bounce body
// _nonseq_bounce_core) for the main-path kinds, the ideal spherical mirror
// (HEMI_APER bound), pixelated phase plates, the extended kinds of the
// mixed-surface and asphere scenes and dispersive media, with every other
// optional stream off but the deterministic ones (the optical path length,
// path and hit recording, in an instantiation of their own, below), the
// Fresnel kinds with their draws (one more instantiation), thin-film
// coatings and metal mirrors (one more), the diffractive and ideal elements
// (one more), component-style fuzzy apodization (one more;
// _nonseq_bounce_core :967-968) and freeform surfaces (one more; its
// intersect :879 and normal_world :942); a convex solid's HALFSPACES bound
// (the TPU kernel's scalar plane reads, :821, :1249) and a single cone's
// CONE_NAPPE bound run in the extended kinds' instantiation and every one
// built on it, the polarized field (one more) and GRIN rods (one more;
// _nonseq_bounce_core's GRIN winner :881-945): no scatter draws.
// Its plain PyTorch version is ops/fused_nonseq.py::trace_nonseq_fused_plain
// (the eager bounce loop of core/trace.py over the flat rows), and the
// wrapper that launches it is ops/fused_nonseq.py::trace_nonseq_fwd_cuda.
//
// What it computes, per ray and bounce (core/trace.py::bounce_step): every
// table row is intersected (plane fast path or the quadric solver, surface
// bound per root, minimum positive root above the world-scale epsilon,
// volume bound), and the nearest valid row wins with a strict t < best_t,
// so the first of equal rows wins.  Only then are the winner's normal and
// physics evaluated and the ray moved: p += t d, d = the new direction,
// I *= the winner's factor.  A PHASE_GRID winner reads the four corners of
// its [H, W] map at the hit (kernel K4's device functions, grid_corners.cuh;
// the TPU kernel's cond-guarded _grid_corners_mxu) and the ray's wavelength;
// the maps stay in device memory, read through L2.  A winner that is a
// sensor records the ray's INCOMING intensity at its sensor-local hit: the 7
// moment terms into (slot, bundle), and the intensity into the slot's grid
// cell (kernel K3's device function, grid_bin.cuh).  A nearer non-sensor
// winner leaves no record, as the merge in bounce_step zeroes an earlier
// sensor crossing.
//
// The TPU kernel evaluates every row's physics for a whole tile and merges
// with where, because its lanes cannot branch, and exits per tile when no
// ray of the tile moved (keep_going).  A thread can branch, so it evaluates
// the physics of the winner alone, and it leaves its loop at the first
// bounce in which no row wins or its intensity is 0: a ray that wins no row
// keeps its state and can win none later, so the result equals the full
// budget's, and a budget of 100 bounces costs what the scene needs.
//
// Design: one thread per ray, 256 threads per block.  Each block copies
// the flat [K, 160] table and the int32 [K, 8] kinds into shared memory and
// builds from them a packed scan record per row (trace_seq_common.cuh):
// the fields the intersection reads, 16-byte aligned, read with 128-bit
// loads, and the kinds it branches on as plain ints.  The row scan is
// warp-uniform; the winner's physics (from the flat row) and the exit
// diverge.  Moments vary per ray and bounce (slot and bundle of each hit),
// so each thread keeps its own S*B*7 sums: a template bucket of 1 (one
// sensor, one bundle, the main path) keeps them in shared memory,
// [moment][thread], so that no register holds them across the bounce
// loop; the bucket of 64 keeps them in local memory.  At the end: warp
// shuffles, one partial per warp in shared memory, a fixed-order sum over
// warps into a [blocks, S, B, 7] buffer that the wrapper sums.  No atomics:
// the moments are deterministic.  The grid takes one atomicAdd per sensor
// hit.  The instantiations of bucket 1 run 5 blocks an SM
// (kFwdMinBlocks, 48 registers, no spill).
//
// What bounds it: like K1 it reads 8 streams and writes 7 (60 B per ray, 60
// MB at 1M rays, ~18 us at 3.35 TB/s), but it runs the row scan once per
// live bounce: the bench scene traced non-sequentially intersects its 5
// rows on each of about 5 bounces, against K1's one pass over 5 rows.
// Measured on an H100 (PERF.md), neither its float nor its integer
// pipe binds it, nor its shared loads (extra instructions of either kind
// cost nothing; fewer loads gained nothing): each warp waits on the
// dependent chain of a row (loads, two IEEE divisions and a square root,
// compares that feed branches), so it gains from more warps an SM and from
// fewer branches on that chain, not from fewer instructions.
//
// Limits (checked by the wrapper): 1..64 rows, <= 8 sensor slots, 1..18
// bundles and slots x bundles <= 64, any bounce budget >= 0.  It reads the wavelength only with plate
// code; a scene with neither a plate nor a RECT bound runs the
// instantiation without plate code (kPlates = false).  A scene with the
// extended kinds (the caller's `ext`) runs the instantiation with plate code
// and kExt, whose scan reads the flat rows and their kinds rows instead of
// the packed records (which hold neither an asphere's terms nor all 8 words
// of a volume bound), and builds no records; its winner's physics reads a
// dispersive row's indices at the ray's wavelength.  So a scene whose only
// extended kind is a dispersive glass (a doublet) scans the flat rows too.
//
// The streams (the caller's track_opl, record_paths, record_hits; the TPU
// kernel's :1020-1023, :1123-1132, :1202-1215) run in an instantiation of
// their own, built on the extended one (it takes every scene), with a copy
// of the kernel's body (nonseq_fwd_streams), so the others keep their code.
// Per bounce it adds n_cur t and takes the winner's medium
// (medium_after), and writes the position and the bounce's sensor record
// ([B][3][N] planar, the hit weights and slots [B][N]); the bounces after a
// ray left its loop are written settled (the position, zero records), as
// the JAX loop's dead branch records them.  The records are bytes: 32 B a
// ray and bounce, 256 B at the naive scene's 8-bounce budget, against the
// 72 B of the rest.
//
// The families of kinds run in one more instantiation of the streams' body,
// the family instantiation (an overload with one more argument, FamSide:
// the families' side data and the runtime word `fam` of the families the
// table has, trace_seq_common.cuh), so every other instantiation keeps its
// code.  It compiles every family together, so a scene may mix them (a
// GRIN rod beside a coated window and a grating, as the TPU kernel's bounce
// core runs them); a family the table lacks skips its block setup and
// passes a null buffer (a table that one of the chain's links took runs
// that link's instantiation, trace_seq_common.cuh::fam_link, as K1 does,
// but for GRIN rods alone, which run the family instantiation).  Per
// family:
//
// - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W).  The TPU kernel
//   draws with the TPU's own generator, reseeded per tile and bounce
//   (_kernel_nonseq :1102-1114), which cannot be reproduced off the TPU.
//   Here a FRESNEL winner draws philox_uniform (trace_seq_common.cuh) of the
//   counter (ray, bounce, row) under FamSide::key: a pure function, so the
//   draw of the winning row alone equals the eager loop's draw of every row
//   then the winner's, K6 replays it by its counter with nothing stored,
//   and the plain version (rays/draws.py) draws the same values.  Ten
//   Philox rounds cost ~100 integer operations a FRESNEL winner, against
//   the ~400 of a bounce's row scan on the naive scene.
// - Thin-film coatings and metal mirrors: the rows' [K][20] side buffer is
//   copied into shared memory after the kinds.  Only the winner's physics
//   reads it: the stack runs once per coated winner and bounce (twice: s
//   and p).
// - The diffractive and ideal elements (LINEAR, GRATING, DOE and MLA rows,
//   the ELLIPSE bound): the scan tests the ELLIPSE bound with its
//   rotation's cosine and sine, written once per row and block into the
//   shared table (ellipse_rows), and only the winner evaluates its map.
// - Fuzzy apodization: the traced programs' int32 buffer is copied into
//   shared memory after the side buffer; a winner with a program multiplies
//   its factor by the program's value at its surface-frame hit (fuzzy.cuh's
//   interpreter, in nonseq_bounce, which K6's replay runs too).
// - Freeform surfaces: the rows' exponent pairs are copied into shared
//   memory after the programs; the scan refines a freeform row's
//   base-conic roots onto its sag by 8 Newton steps, and a freeform winner
//   takes its sag's normal (freeform.cuh, in nonseq_bounce), as
//   _nonseq_bounce_core's intersect (:879) and normal_world (:942) do.
// - GRIN rods (grin.cuh): the scan lets a rod's entry face win only a ray
//   travelling +z in its frame (grin.cuh::grin_fwd, a few multiply-adds on
//   the rod's rows alone), and the winner runs the whole rod once
//   (grin_rod, out of line, so that K6's replay reaches this state bit for
//   bit), where the TPU kernel runs it for every candidate row (:888-908).
//   The path length adds the winner's in-medium path after n_cur t and the
//   medium becomes the rod's ambient index; a nearer winner leaves no stale
//   path, each bounce's being its winner's alone (:940, :1022).
//
// The polarized field (track_field; the TPU kernel's field refs :1035 and
// :1047, _nonseq_bounce_core's power_in :861 and transport :971-975) runs
// in one more instantiation, kField, of the streams' body (an overload with
// one more argument after the side data: FieldIO, the launch field and the
// final field, [6][N] planar), which compiles every family but GRIN rods
// (the field through a rod is not in the kernels yet: the wrapper refuses
// it, ROADMAP Queue 1 position 4b), so every other instantiation keeps its
// code; a table without the diffractive, fuzzy or freeform kinds runs it
// instantiated for the Fresnel kinds and coatings alone (kFamFieldCoat, the
// earlier field instantiation, whose rounding section 19 holds).  Each
// thread carries its ray's six field floats through the bounces: the
// winner's physics sees the field at the bounce's start (the Fresnel kinds,
// bare or coated, draw and weigh with its polarized reflectance, a metal
// mirror weighs by its polarized R, the diffractive kinds redirect it:
// trace_seq_common.cuh::field_physics), its fuzzy program apodizes it, the
// winner transports it (field.cuh::field_transport, inside nonseq_bounce's
// out-of-line field_winner, so K6's replay reaches the same field), and a
// sensor winner records w = I |E|^2 of the field at the bounce's start (the
// TPU kernel's weights :1131-1168; its count only where w > 0).  It reads
// and writes 48 B a ray more than the family instantiation.
//
// Numerics: fp32 throughout, built without --use_fast_math, as K1, with the
// same intersection, normal and physics (trace_seq_common.cuh).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

using namespace rtt;

namespace {

// Resident blocks of kThreads per SM that the instantiations of bucket 1
// (the main path's, with and without plate code) are capped for
// (__launch_bounds__): the most at which ptxas keeps them free of spills
// and of a stack frame (PERF.md).  The bucket of 64 keeps its sums in a
// local array: it stays uncapped, and so do the instantiations with the
// extended kinds (77-80 registers, 3 blocks an SM).
constexpr int kFwdMinBlocks = 5;

template <int kMomBucket, bool kExt>
__host__ __device__ constexpr int fwd_min_blocks() {
  return kMomBucket == 1 && !kExt ? kFwdMinBlocks : 1;
}

// The dynamic shared memory of a launch: the packed scan records (not with
// the extended kinds), the flat table, its kinds, in the family and field
// instantiations the side data of the families `fs` has (the side buffer,
// the fuzzy programs' words, the rows' exponent pairs), the per-warp moment
// partials and bucket 1's per-thread moment sums.
size_t shared_bytes(int n_rows, int n_slots, int n_bundles, bool ext, const FamSide& fs = {}) {
  return sizeof(float) * (static_cast<size_t>(n_rows) *
                              ((ext ? 0 : kRecWords) + kRowWidth + kKindWidth) +
                          static_cast<size_t>(fam_coat_words(fs, n_rows)) +
                          static_cast<size_t>(fam_fuzzy_words(fs)) +
                          static_cast<size_t>(fam_ff_words(fs, n_rows)) +
                          static_cast<size_t>(kWarps) * n_slots * n_bundles * kMoments +
                          static_cast<size_t>(kMoments) * kThreads);
}

// The field (kField): the launch field `in` and the final field `out`,
// [6][n] floats each (Er x, y, z, then Ei x, y, z).
struct FieldIO {
  const float* in;
  float* out;
};

template <int kMomBucket, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<kMomBucket, kExt>())
trace_nonseq_fwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
                        int n_rows, const float* __restrict__ px, const float* __restrict__ py,
                        const float* __restrict__ pz, const float* __restrict__ dx,
                        const float* __restrict__ dy, const float* __restrict__ dz,
                        const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
                        float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
                        float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
                        float* __restrict__ ointensity, float* __restrict__ partials,
                        int n_slots, int n_bundles, float* __restrict__ grid, int grid_h,
                        int grid_w, float grid_e, const float* __restrict__ maps,
                        const int32_t* __restrict__ map_desc,
                        const float* __restrict__ wavelength, int n_bounces, long long n) {
  extern __shared__ float4 smem4[];
  // the packed scan records (none with kExt, whose scan reads the flat rows)
  constexpr int kRecs = kExt ? 0 : kRec4;
  const float4* recs = smem4;
  float* tab = reinterpret_cast<float*>(smem4 + n_rows * kRecs);
  int32_t* knd = reinterpret_cast<int32_t*>(tab + n_rows * kRowWidth);
  float* warp_mom = tab + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (!kExt)
    build_scan_records(reinterpret_cast<float*>(smem4), table, kinds, n_rows, tid, kThreads);
  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  // Threads past the ragged edge hold a zero ray of zero intensity: they
  // leave the loop at once and add nothing.
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
  const bool counted = rid >= 0 && rid < n_bundles;

  // The moment sums: bucket 1 keeps its 7 in shared memory, [moment]
  // [thread] (a warp's access is 32 consecutive words, no bank conflict),
  // so no register holds them across the bounce loop; the bucket of 64
  // keeps them in a local array.  Each thread adds its hits in bounce order
  // either way.
  constexpr int kStride = kMomBucket == 1 ? kThreads : 1;
  float acc_local[kMomBucket == 1 ? 1 : kMomBucket * kMoments];
  float* const acc = kMomBucket == 1 ? warp_mom + kWarps * n_mom + tid : acc_local;
#pragma unroll(kMomBucket == 1 ? kMoments : 1)
  for (int j = 0; j < kMomBucket * kMoments; ++j) acc[j * kStride] = 0.0f;

  for (int b = 0; b < n_bounces; ++b) {
    if (!(inten > 0.0f)) break;
    // ---- nearest valid row, its physics and the move ----
    const float w = inten;
    RowHit hw = {};
    RowKinds kd = {};
    const int k_win =
        nonseq_bounce<kPlates, kExt>(recs, tab, knd, n_rows, pl, p, d, inten, hw, kd);
    if (k_win < 0) break;

    // ---- a sensor winner records the incoming intensity at its hit ----
    if (kd.sensor) {
      const float x = hw.hs.x, y = hw.hs.y;
      if (counted) {
        // bucket 1 holds one (slot, bundle): its index is 0 at compile time
        float* a = acc + (kMomBucket == 1 ? 0 : (kd.slot * n_bundles + rid) * kMoments);
        a[0] += w;
        a[kStride] += w * x;
        a[2 * kStride] += w * y;
        a[3 * kStride] += w * x * x;
        a[4 * kStride] += w * y * y;
        a[5 * kStride] += w * x * y;
        a[6 * kStride] += 1.0f;
      }
      if (grid != nullptr) {
        // the grid's sizes enter here, once a ray: the empty asm keeps the
        // compiler from computing their conversions before the bounce loop
        // and holding them in registers across it
        int gh = grid_h, gw = grid_w;
        float ge = grid_e;
        asm volatile("" : "+r"(gh), "+r"(gw), "+f"(ge));
        grid_add(grid, kd.slot, x, y, w, gh, gw, ge);
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
  }

  // ---- moments: warp sums, per-warp partials, fixed-order block sum ----
#pragma unroll(kMomBucket == 1 ? kMoments : 1)
  for (int j = 0; j < kMomBucket * kMoments; ++j) {
    if (j < n_mom) {  // uniform across the block
      const float s = warp_sum(acc[j * kStride]);
      if (lane == 0) warp_mom[warp * n_mom + j] = s;
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

// The body of the instantiation with the streams (plate code, the extended
// kinds and dispersion): the kernel's above, in a copy of its own, so that
// the kernel keeps its text and so its code in every other instantiation
// (the bucket of 64's registers moved when the two shared one body).  It
// also accumulates the optical path length n_cur t of each bounce and the
// winner's medium (medium_after), and writes the
// streams of `so` that are not null: after each bounce the position, the
// bounce's sensor record (the local hit and slot of the last sensor row that
// was the nearest when the scan met it, and the incoming intensity where a
// sensor won, 0 where a nearer row did), and from the bounce at which the
// ray leaves its loop to the budget the settled ones: the position
// unchanged, zero hits, weights and slots.  The family flags compile a
// family of kinds in, and the runtime word fs.fam says which of them the
// table has: with kFresnel a FRESNEL winner draws Philox under fs.key;
// with kCoat the coated and metal winners weigh by their stacks, reading
// their rows of fs.coat; with kDiff the diffractive kinds and the ELLIPSE
// bound; with kFuzzy the winners with a program in fs.fuzzy (copied into
// shared memory after the side buffer) weigh by it; with kFreeform the
// freeform rows of fs.ff (copied into shared memory after the programs)
// are freeform surfaces; with kGrin a GRIN winner runs its rod and adds its
// in-medium path.  With kField (which has every family flag but kGrin)
// each ray carries its field from `fio.in` (the winner's field_physics and
// transport, the |E|^2 weights) to `fio.out`.
template <int kMomBucket, bool kFresnel = false, bool kCoat = false, bool kDiff = false,
          bool kFuzzy = false, bool kFreeform = false, bool kField = false, bool kGrin = false>
__device__ __forceinline__ void nonseq_fwd_streams(
    const float* __restrict__ table, const int32_t* __restrict__ kinds, int n_rows,
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
    float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
    float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
    float* __restrict__ ointensity, float* __restrict__ partials, int n_slots, int n_bundles,
    float* __restrict__ grid, int grid_h, int grid_w, float grid_e,
    const float* __restrict__ maps, const int32_t* __restrict__ map_desc,
    const float* __restrict__ wavelength, int n_bounces, long long n, StreamOut so,
    FamSide fs = {}, FieldIO fio = {nullptr, nullptr}) {
  static_assert(kFresnel || !kCoat, "the coatings run with the Fresnel kinds");
  static_assert(kCoat || !kDiff, "the diffractive kinds run with the coatings");
  static_assert(kDiff || !kFuzzy, "the fuzzy programs run with the diffractive kinds");
  static_assert(kFuzzy || !kFreeform, "the freeform surfaces run with the fuzzy programs");
  static_assert(kCoat || !kField, "the field runs with the coatings");
  static_assert(!(kGrin && kField), "the field through a GRIN rod is not in the kernels");
  constexpr bool kPlates = true, kExt = true;
  extern __shared__ float4 smem4[];
  // the packed scan records (none with kExt, whose scan reads the flat rows)
  constexpr int kRecs = kExt ? 0 : kRec4;
  const float4* recs = smem4;
  float* tab = reinterpret_cast<float*>(smem4 + n_rows * kRecs);
  int32_t* knd = reinterpret_cast<int32_t*>(tab + n_rows * kRowWidth);
  float* cside = tab + n_rows * (kRowWidth + kKindWidth);  // kCoat: the side buffer
  // kFuzzy: the programs, after the side buffer
  int32_t* fzs = reinterpret_cast<int32_t*>(cside + (kCoat ? fam_coat_words(fs, n_rows) : 0));
  int32_t* ffs = fzs + (kFuzzy ? fam_fuzzy_words(fs) : 0);  // kFreeform: the pairs
  float* warp_mom =
      reinterpret_cast<float*>(ffs) + (kFreeform ? fam_ff_words(fs, n_rows) : 0);
  const int n_mom = n_slots * n_bundles * kMoments;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (!kExt)
    build_scan_records(reinterpret_cast<float*>(smem4), table, kinds, n_rows, tid, kThreads);
  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
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
  // the programs and the pairs, null where the table lacks their family
  const int32_t* progs = kFuzzy && (fs.fam & kFamFuzzy) ? fzs : nullptr;
  const int32_t* pairs = kFreeform && (fs.fam & kFamFreeform) ? ffs : nullptr;

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  // Threads past the ragged edge hold a zero ray of zero intensity: they
  // leave the loop at once and add nothing.
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
  const bool counted = rid >= 0 && rid < n_bundles;
  // the streams: the path length, the medium (index 1 at launch)
  float opl = 0.0f, n_cur = 1.0f;
  // kField: the ray's field (zero past the ragged edge)
  Fld fe = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if constexpr (kField) {
    if (live) {
      fe.r = {fio.in[i], fio.in[n + i], fio.in[2 * n + i]};
      fe.i = {fio.in[3 * n + i], fio.in[4 * n + i], fio.in[5 * n + i]};
    }
  }

  // The moment sums: bucket 1 keeps its 7 in shared memory, [moment]
  // [thread] (a warp's access is 32 consecutive words, no bank conflict),
  // so no register holds them across the bounce loop; the bucket of 64
  // keeps them in a local array.  Each thread adds its hits in bounce order
  // either way.
  constexpr int kStride = kMomBucket == 1 ? kThreads : 1;
  float acc_local[kMomBucket == 1 ? 1 : kMomBucket * kMoments];
  float* const acc = kMomBucket == 1 ? warp_mom + kWarps * n_mom + tid : acc_local;
#pragma unroll(kMomBucket == 1 ? kMoments : 1)
  for (int j = 0; j < kMomBucket * kMoments; ++j) acc[j * kStride] = 0.0f;

  // leaves b_end at the bounce at which the ray left its loop
  int b_end = n_bounces;
  for (int b = 0; b < n_bounces; ++b) {
    if (!(inten > 0.0f)) {
      b_end = b;
      break;
    }
    // kField: the incoming |E|^2 weighs a sensor winner's record
    float w = inten;
    if constexpr (kField) w = w * fpower(fe);
    RowHit hw = {};
    RowKinds kd = {};
    PhysBranch br = {};
    SensorRec rec;
    const RayDraw rd = {fs.key, static_cast<uint32_t>(i), static_cast<uint32_t>(b)};
    GrinExit ge;  // kGrin: a GRIN winner's exit
    const int k_win =
        nonseq_bounce<kPlates, kExt, kExt, true, kFresnel, kCoat, kDiff, kFuzzy, kFreeform,
                      kField, kGrin>(recs, tab, knd, n_rows, pl, p, d, inten, hw, kd, nullptr,
                                     &br, &rec, &rd, cside, progs, pairs, kField ? &fe : nullptr,
                                     kGrin ? &ge : nullptr);
    if (k_win < 0) {
      b_end = b;
      break;
    }
    opl = opl + n_cur * hw.t;
    if constexpr (kGrin) {
      if (kd.ph == GRIN) {  // the rod's in-medium path; it exits into n_ambient
        opl = opl + ge.seg;
        n_cur = tab[k_win * kRowWidth + kPh];
      } else {
        n_cur = medium_after<kExt, kFresnel, kDiff>(tab + k_win * kRowWidth, kd, br.from_in,
                                                    br.tir, pl.wl, n_cur, br.reflect);
      }
    } else {
      n_cur = medium_after<kExt, kFresnel, kDiff>(tab + k_win * kRowWidth, kd, br.from_in, br.tir,
                                                  pl.wl, n_cur, br.reflect);
    }
    if (live && so.paths != nullptr) {
      float* dst = so.paths + 3 * b * n + i;
      dst[0] = p.x;
      dst[n] = p.y;
      dst[2 * n] = p.z;
    }
    if (live && so.hits != nullptr) {
      float* dst = so.hits + 3 * b * n + i;
      dst[0] = rec.hs.x;
      dst[n] = rec.hs.y;
      dst[2 * n] = rec.hs.z;
      so.hit_w[b * n + i] = kd.sensor ? w : 0.0f;
      so.hit_slot[b * n + i] = rec.slot;
    }
    if (kd.sensor) {  // as in the kernel above
      const float x = hw.hs.x, y = hw.hs.y;
      if (counted) {
        float* a = acc + (kMomBucket == 1 ? 0 : (kd.slot * n_bundles + rid) * kMoments);
        a[0] += w;
        a[kStride] += w * x;
        a[2 * kStride] += w * y;
        a[3 * kStride] += w * x * x;
        a[4 * kStride] += w * y * y;
        a[5 * kStride] += w * x * y;
        a[6 * kStride] += kField ? (w > 0.0f ? 1.0f : 0.0f) : 1.0f;
      }
      if (grid != nullptr) {
        int gh = grid_h, gw = grid_w;
        float ge = grid_e;
        asm volatile("" : "+r"(gh), "+r"(gw), "+f"(ge));
        grid_add(grid, kd.slot, x, y, w, gh, gw, ge);
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
    if (so.opl != nullptr) {
      so.opl[i] = opl;
      so.n_final[i] = n_cur;
    }
    if constexpr (kField) {
      const float v[6] = {fe.r.x, fe.r.y, fe.r.z, fe.i.x, fe.i.y, fe.i.z};
#pragma unroll
      for (int j = 0; j < 6; ++j) fio.out[j * n + i] = v[j];
    }
    // the settled bounces, from the one at which the ray left its loop
    for (int s = b_end; s < n_bounces; ++s) {
      if (so.paths != nullptr) {
        float* dst = so.paths + 3 * s * n + i;
        dst[0] = p.x;
        dst[n] = p.y;
        dst[2 * n] = p.z;
      }
      if (so.hits != nullptr) {
        float* dst = so.hits + 3 * s * n + i;
        dst[0] = 0.0f;
        dst[n] = 0.0f;
        dst[2 * n] = 0.0f;
        so.hit_w[s * n + i] = 0.0f;
        so.hit_slot[s * n + i] = 0;
      }
    }
  }

  // ---- moments: warp sums, per-warp partials, fixed-order block sum ----
#pragma unroll(kMomBucket == 1 ? kMoments : 1)
  for (int j = 0; j < kMomBucket * kMoments; ++j) {
    if (j < n_mom) {  // uniform across the block
      const float s = warp_sum(acc[j * kStride]);
      if (lane == 0) warp_mom[warp * n_mom + j] = s;
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

#define RTT_NONSEQ_FWD_PARAMS                                                                   \
  const float *__restrict__ table, const int32_t *__restrict__ kinds, int n_rows,               \
      const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,  \
      const float *__restrict__ dx, const float *__restrict__ dy, const float *__restrict__ dz,  \
      const float *__restrict__ intensity, const int32_t *__restrict__ ray_id,                  \
      float *__restrict__ opx, float *__restrict__ opy, float *__restrict__ opz,                \
      float *__restrict__ odx, float *__restrict__ ody, float *__restrict__ odz,                \
      float *__restrict__ ointensity, float *__restrict__ partials, int n_slots, int n_bundles, \
      float *__restrict__ grid, int grid_h, int grid_w, float grid_e,                           \
      const float *__restrict__ maps, const int32_t *__restrict__ map_desc,                     \
      const float *__restrict__ wavelength, int n_bounces, long long n
#define RTT_NONSEQ_FWD_ARGS                                                                     \
  table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx, ody, odz, \
      ointensity, partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps, map_desc,   \
      wavelength, n_bounces, n

// The kernel with the streams (plate code, the extended kinds, dispersion).
template <int kMomBucket, bool kPlates, bool kExt>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<kMomBucket, kExt>())
trace_nonseq_fwd_kernel(RTT_NONSEQ_FWD_PARAMS, StreamOut so) {
  static_assert(kPlates && kExt, "the streams run with the extended kinds");
  nonseq_fwd_streams<kMomBucket>(RTT_NONSEQ_FWD_ARGS, so);
}

// The family instantiation (kFams = kFamAll; kFamGrin for GRIN rods alone):
// the streams and the families of kFams, which the table has reading
// fs.fam.
template <int kMomBucket, bool kPlates, bool kExt, uint32_t kFams = kFamAll>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<kMomBucket, kExt>())
trace_nonseq_fwd_kernel(RTT_NONSEQ_FWD_PARAMS, StreamOut so, FamSide fs) {
  static_assert(kPlates && kExt, "the families run with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  nonseq_fwd_streams<kMomBucket, kF, kC, kD, kZ, kFF, false,
                     fam_has(kFams, kFamGrin)>(RTT_NONSEQ_FWD_ARGS, so, fs);
}

// The field's instantiation: the streams, the families of kFams (every
// family but GRIN rods; kFamFieldCoat for tables without the diffractive,
// fuzzy or freeform kinds) and the field.
template <int kMomBucket, bool kPlates, bool kExt, uint32_t kFams = kFamField>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<kMomBucket, kExt>())
trace_nonseq_fwd_kernel(RTT_NONSEQ_FWD_PARAMS, StreamOut so, FamSide fs, FieldIO fio) {
  static_assert(kPlates && kExt, "the field runs with the extended kinds");
  constexpr bool kF = fam_has(kFams, kFamFresnel), kC = fam_has(kFams, kFamCoat);
  constexpr bool kD = fam_has(kFams, kFamDiff), kZ = fam_has(kFams, kFamFuzzy);
  constexpr bool kFF = fam_has(kFams, kFamFreeform);
  nonseq_fwd_streams<kMomBucket, kF, kC, kD, kZ, kFF, true>(
      RTT_NONSEQ_FWD_ARGS, so, fs, fio);
}

// Philox4x32-10 of n counters under n keys (4 and 2 words each, laid out
// one after the other), into 4 n words: the device generator's known-answer
// check (tests/test_torch_cuda.py, chip_smoke.py).
__global__ void philox_kernel(const uint32_t* __restrict__ ctr, const uint32_t* __restrict__ key,
                              uint32_t* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t c[4] = {ctr[4 * j], ctr[4 * j + 1], ctr[4 * j + 2], ctr[4 * j + 3]};
  philox4x32(c, PhiloxKey{key[2 * j], key[2 * j + 1]});
  for (int w = 0; w < 4; ++w) out[4 * j + w] = c[w];
}

// The types of the kernels.
using FwdKernel = void (*)(RTT_NONSEQ_FWD_PARAMS);
using FwdStreamKernel = void (*)(RTT_NONSEQ_FWD_PARAMS, StreamOut);
using FwdFamKernel = void (*)(RTT_NONSEQ_FWD_PARAMS, StreamOut, FamSide);
using FwdFieldKernel = void (*)(RTT_NONSEQ_FWD_PARAMS, StreamOut, FamSide, FieldIO);

#undef RTT_NONSEQ_FWD_PARAMS
#undef RTT_NONSEQ_FWD_ARGS

// The kernel of an instantiation: without the streams (kPlates, kExt),
// with them (kStreams), the family instantiation (kFam) or the field's
// (kField).
template <int kMomBucket, bool kPlates, bool kExt, bool kStreams = false, uint32_t kFams = 0u,
          bool kField = false>
const void* kernel_fn() {
  if constexpr (kField)
    return reinterpret_cast<const void*>(
        static_cast<FwdFieldKernel>(trace_nonseq_fwd_kernel<kMomBucket, true, true, kFams>));
  else if constexpr (kFams != 0u)
    return reinterpret_cast<const void*>(
        static_cast<FwdFamKernel>(trace_nonseq_fwd_kernel<kMomBucket, true, true, kFams>));
  else if constexpr (kStreams)
    return reinterpret_cast<const void*>(
        static_cast<FwdStreamKernel>(trace_nonseq_fwd_kernel<kMomBucket, true, true>));
  else
    return reinterpret_cast<const void*>(
        static_cast<FwdKernel>(trace_nonseq_fwd_kernel<kMomBucket, kPlates, kExt>));
}

// The plate arguments of a launch: the maps, their descriptors and the
// rays' wavelengths (all null without a plate).
struct PlateArgs {
  const float* maps;
  const int32_t* desc;
  const float* wavelength;
};

// Allow the kernel its shared memory (beyond 48 KB only on request).
template <int kMomBucket, bool kPlates, bool kExt, bool kStreams = false, uint32_t kFams = 0u,
          bool kField = false>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_fn<kMomBucket, kPlates, kExt, kStreams, kFams, kField>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kMomBucket, bool kPlates, bool kExt>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           float* const* outs, float* partials, int n_slots, int n_bundles, float* grid,
           int grid_h, int grid_w, float grid_e, const PlateArgs& pa, int n_bounces,
           long long n) {
  const cudaError_t e = prepare<kMomBucket, kPlates, kExt>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trace_nonseq_fwd_kernel<kMomBucket, kPlates, kExt>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
          ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials,
          n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa.maps, pa.desc, pa.wavelength,
          n_bounces, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlates, bool kExt>
int launch_bucket(size_t smem, long long blocks, cudaStream_t stream, const float* table,
                  const int32_t* kinds, int n_rows, const float* const* rays,
                  const int32_t* ray_id, float* const* outs, float* partials, int n_slots,
                  int n_bundles, float* grid, int grid_h, int grid_w, float grid_e,
                  const PlateArgs& pa, int n_bounces, long long n) {
  if (n_slots * n_bundles == 1)
    return launch<1, kPlates, kExt>(smem, blocks, stream, table, kinds, n_rows, rays, ray_id,
                                    outs, partials, n_slots, n_bundles, grid, grid_h, grid_w,
                                    grid_e, pa, n_bounces, n);
  return launch<64, kPlates, kExt>(smem, blocks, stream, table, kinds, n_rows, rays, ray_id,
                                   outs, partials, n_slots, n_bundles, grid, grid_h, grid_w,
                                   grid_e, pa, n_bounces, n);
}

// The instantiation of `code` (0 without plate code, 1 with it, 2 or 3 with
// it and the extended kinds, 4 the one with the streams, 5 the family
// instantiation, 6 the field's) and moment bucket, its shared memory
// allowed.
template <int kMomBucket>
const void* kernel_of(int code, uint32_t fam, size_t smem, cudaError_t* e) {
  if (code == 6 && field_coat_alone(fam)) {
    *e = prepare<kMomBucket, true, true, true, kFamFieldCoat, true>(smem);
    return kernel_fn<kMomBucket, true, true, true, kFamFieldCoat, true>();
  }
  if (code == 6) {
    *e = prepare<kMomBucket, true, true, true, kFamField, true>(smem);
    return kernel_fn<kMomBucket, true, true, true, kFamField, true>();
  }
  if (code == 5)
    return with_fam_link<false>(fam, [&](auto fams) {
      constexpr uint32_t kFams = decltype(fams)::value;
      *e = prepare<kMomBucket, true, true, true, kFams>(smem);
      return kernel_fn<kMomBucket, true, true, true, kFams>();
    });
  if (code == 4) {
    *e = prepare<kMomBucket, true, true, true>(smem);
    return kernel_fn<kMomBucket, true, true, true>();
  }
  if (code >= 2) {
    *e = prepare<kMomBucket, true, true>(smem);
    return kernel_fn<kMomBucket, true, true>();
  }
  if (code == 1) {
    *e = prepare<kMomBucket, true, false>(smem);
    return kernel_fn<kMomBucket, true, false>();
  }
  *e = prepare<kMomBucket, false, false>(smem);
  return kernel_fn<kMomBucket, false, false>();
}

// The instantiation with the streams (kFams 0, no `side`), or with `side`
// (the families' side data) the family instantiation of the families
// kFams, or with `side` and the field the field's: their overloads take
// the side data and the field last.
template <int kMomBucket, uint32_t kFams = 0u, class... Side>
int launch_streams(size_t smem, long long blocks, cudaStream_t stream, const float* table,
                   const int32_t* kinds, int n_rows, const float* const* rays,
                   const int32_t* ray_id, float* const* outs, float* partials, int n_slots,
                   int n_bundles, float* grid, int grid_h, int grid_w, float grid_e,
                   const PlateArgs& pa, int n_bounces, long long n, const StreamOut& so,
                   Side... side) {
  const cudaError_t e =
      prepare<kMomBucket, true, true, true, kFams, sizeof...(Side) == 2>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kFams == 0u)
    trace_nonseq_fwd_kernel<kMomBucket, true, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
            ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials,
            n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa.maps, pa.desc, pa.wavelength,
            n_bounces, n, so);
  else
    trace_nonseq_fwd_kernel<kMomBucket, true, true, kFams>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
            ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials,
            n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa.maps, pa.desc, pa.wavelength,
            n_bounces, n, so, side...);
  return static_cast<int>(cudaGetLastError());
}

// The side data of a family or field launch from its C arguments, checked:
// -> cudaSuccess or cudaErrorInvalidValue.  Each buffer is given exactly
// when its family's bit is set, the programs with n_rows to kFuzzyMaxWords
// words; the key is read with kFamFresnel.
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

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer: 7 outputs of n floats, a partials buffer of
// ceil(n / 256) * n_slots * n_bundles * 7 floats, and the zeroed
// [n_slots, grid_h, grid_w] grid over [-grid_e, grid_e]^2, or null for no
// grid.  With phase plates, `maps` holds their maps one after the other,
// `map_desc` (offset, h, w) per map, and `wavelength` the n rays'
// wavelengths.  All three null selects the instantiation without plate code,
// which the caller must not give a PHASE_GRID row or a RECT bound.  `ext`
// as for rtt_trace_seq_fwd.
extern "C" int rtt_trace_nonseq_fwd(const float* table, const int32_t* kinds, int n_rows,
                                    const float* px, const float* py, const float* pz,
                                    const float* dx, const float* dy, const float* dz,
                                    const float* intensity, const int32_t* ray_id, float* opx,
                                    float* opy, float* opz, float* odx, float* ody, float* odz,
                                    float* ointensity, float* partials, int n_slots,
                                    int n_bundles, float* grid, int grid_h, int grid_w,
                                    float grid_e, const float* maps, const int32_t* map_desc,
                                    const float* wavelength, int ext, int n_bounces,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ext && maps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, ext != 0);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  float* outs[7] = {opx, opy, opz, odx, ody, odz, ointensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlateArgs pa = {maps, map_desc, wavelength};
  if (ext)
    return launch_bucket<true, true>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                     partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                     pa, n_bounces, n);
  if (maps != nullptr)
    return launch_bucket<true, false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                      partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                      pa, n_bounces, n);
  return launch_bucket<false, false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                     partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                     PlateArgs{nullptr, nullptr, nullptr}, n_bounces, n);
}

// Launches the instantiation with the streams on `stream`: the arguments of
// rtt_trace_nonseq_fwd (its `ext` implied: `maps`, `map_desc` and
// `wavelength` must be given, a PHASE_GRID row or not), then the stream
// outputs, each null when not wanted: `opl` and `n_final` (n floats each),
// `paths` (n_bounces * 3 * n floats), `hits` (n_bounces * 3 * n), `hit_w`
// (n_bounces * n floats) and `hit_slot` (n_bounces * n int32, both given
// with `hits`), then the families: `fam` nonzero (kFam* bits, the families
// the table has) selects the family instantiation, whose FRESNEL rows draw
// under the Philox key (key0, key1) and which reads `coat_side`, the n_rows
// * 20 floats of ops/fused_trace.py::coat_side (with kFamCoat), `fuzzy`,
// the programs' `fuzzy_words` int32 words (n_rows to kFuzzyMaxWords;
// fuzzy.cuh; with kFamFuzzy), and `ff_side`, the rows' n_rows * kFfSide
// int32 words of exponent pairs (freeform.cuh; with kFamFreeform), each
// null where its family's bit is clear.  A GRIN row's RK4 step count
// (1..kMaxGrinSteps) is its kinds row's last column.  Returns a
// cudaError_t.
extern "C" int rtt_trace_nonseq_fwd_streams(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, float* opx, float* opy, float* opz, float* odx, float* ody,
    float* odz, float* ointensity, float* partials, int n_slots, int n_bundles, float* grid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* opl, float* n_final, float* paths, float* hits,
    float* hit_w, int32_t* hit_slot, uint32_t key0, uint32_t key1, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam, int n_bounces,
    long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  const cudaError_t e =
      fam_side(key0, key1, coat_side, fuzzy, fuzzy_words, ff_side, fam, n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opl == nullptr) != (n_final == nullptr) || (hits == nullptr) != (hit_w == nullptr) ||
      (hits == nullptr) != (hit_slot == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, true, fs);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  float* outs[7] = {opx, opy, opz, odx, ody, odz, ointensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlateArgs pa = {maps, map_desc, wavelength};
  const StreamOut so = {opl, n_final, paths, hits, hit_w, hit_slot};
  auto go = [&](auto fams, auto... side) {
    constexpr uint32_t kFams = decltype(fams)::value;
    if (n_slots * n_bundles == 1)
      return launch_streams<1, kFams>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                      partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                      pa, n_bounces, n, so, side...);
    return launch_streams<64, kFams>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                     partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                     pa, n_bounces, n, so, side...);
  };
  if (fam == 0) return go(std::integral_constant<uint32_t, 0u>{});
  return with_fam_link<false>(fam, [&](auto fams) { return go(fams, fs); });
}

// Launches the instantiation with the field on `stream`: the arguments of
// rtt_trace_nonseq_fwd_streams (whose `fam` must not hold kFamGrin) up to
// `fam`, then the launch field `field_in` and the final field `field_out`
// ([6][n] floats each: Er x, y, z, then Ei x, y, z).  Returns a
// cudaError_t.
extern "C" int rtt_trace_nonseq_fwd_field(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, float* opx, float* opy, float* opz, float* odx, float* ody,
    float* odz, float* ointensity, float* partials, int n_slots, int n_bundles, float* grid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* opl, float* n_final, float* paths, float* hits,
    float* hit_w, int32_t* hit_slot, uint32_t key0, uint32_t key1, const float* coat_side,
    const int32_t* fuzzy, int fuzzy_words, const int32_t* ff_side, unsigned fam,
    const float* field_in, float* field_out, int n_bounces, long long n, void* stream) {
  if (n <= 0) return 0;
  FamSide fs;
  const cudaError_t e =
      fam_side(key0, key1, coat_side, fuzzy, fuzzy_words, ff_side, fam, n_rows, &fs);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((fam & kFamGrin) || field_in == nullptr || field_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps == nullptr || map_desc == nullptr || wavelength == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opl == nullptr) != (n_final == nullptr) || (hits == nullptr) != (hit_w == nullptr) ||
      (hits == nullptr) != (hit_slot == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, true, fs);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  float* outs[7] = {opx, opy, opz, odx, ody, odz, ointensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlateArgs pa = {maps, map_desc, wavelength};
  const StreamOut so = {opl, n_final, paths, hits, hit_w, hit_slot};
  const FieldIO fio = {field_in, field_out};
  auto go = [&](auto fams) {
    constexpr uint32_t kFams = decltype(fams)::value;
    if (n_slots * n_bundles == 1)
      return launch_streams<1, kFams>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                      partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                      pa, n_bounces, n, so, fs, fio);
    return launch_streams<64, kFams>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                                     partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                                     pa, n_bounces, n, so, fs, fio);
  };
  return field_coat_alone(fam) ? go(std::integral_constant<uint32_t, kFamFieldCoat>{})
                               : go(std::integral_constant<uint32_t, kFamField>{});
}

// Philox4x32-10 of n counters (4 n words) under n keys (2 n words) into out
// (4 n words), on `stream`: the known-answer check of the device generator.
// Returns a cudaError_t.
extern "C" int rtt_philox4x32(const uint32_t* ctr, const uint32_t* key, uint32_t* out, int n,
                              void* stream) {
  if (n <= 0) return 0;
  philox_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ctr, key, out, n);
  return static_cast<int>(cudaGetLastError());
}

// The resident blocks per SM of the instantiation that a launch with these
// sizes runs (the bounce budget does not change it), at its dynamic shared
// memory, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// `code`: 0 without plate code, 1 with it, 2 (or 3, as K2's and K6's code
// for a table with a dispersive row) with it and the extended kinds, 4 the
// instantiation with the streams, 5 the family instantiation, 6 the
// field's, these two with the families `fam` (kFam* bits) and programs of
// `fuzzy_words` words.  Returns a cudaError_t.
extern "C" int rtt_trace_nonseq_fwd_occupancy(int n_rows, int n_slots, int n_bundles,
                                              int n_bounces, int code, int fuzzy_words,
                                              unsigned fam, int* blocks) {
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FamSide fs = {nullptr, 0, PhiloxKey{0u, 0u}, nullptr, nullptr, fuzzy_words, nullptr,
                      code >= 5 ? fam : 0u};
  const size_t smem = shared_bytes(n_rows, n_slots, n_bundles, code >= 2, fs);
  cudaError_t e;
  const void* fn = n_slots * n_bundles == 1 ? kernel_of<1>(code, fs.fam, smem, &e)
                                            : kernel_of<64>(code, fs.fam, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}
