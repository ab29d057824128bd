// Fused non-sequential forward trace for Hopper (sm_90a): kernel K5, the
// whole bounce loop per ray.
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_nonseq (launched by trace_nonseq_pallas, bounce body
// _nonseq_bounce_core) for the main-path kinds and the ideal spherical
// mirror (HEMI_APER bound) and pixelated phase plates, with every other
// optional stream off: no random draws, field, opl, recording, fuzzy
// apodization, GRIN or HALFSPACES rows.
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
// Design: one thread per ray, 256 threads per block.  The flat [K, 160]
// table and the int32 [K, 8] kinds sit in shared memory, loaded once per
// block.  The row scan is warp-uniform; the winner's physics and the exit
// diverge.  Moments vary per ray and bounce (slot and bundle of each hit),
// so each thread keeps its own S*B*7 sums: a template bucket of 1 (one
// sensor, one bundle, the main path) keeps them in 7 registers; the bucket
// of 64 keeps them in local memory.  At the end: warp shuffles, one partial
// per warp in shared memory, a fixed-order sum over warps into a
// [blocks, S, B, 7] buffer that the wrapper sums.  No atomics: the moments
// are deterministic.  The grid takes one atomicAdd per sensor hit.
//
// What bounds it: like K1 it reads 8 streams and writes 7 (60 B per ray, 60
// MB at 1M rays, ~18 us at 3.35 TB/s), but it runs the row scan once per
// live bounce: the bench scene traced non-sequentially intersects its 5
// rows on each of about 5 bounces, against K1's one pass over 5 rows.  The
// per-ray arithmetic (IEEE division and sqrt in each intersection) should
// bound it, as it does K1; the atomics of a focused grid add contention.
// This is an estimate by count; PERF.md holds the measured time.
//
// Limits (checked by the wrapper): 1..64 rows, <= 8 sensor slots, 1..8
// bundles, any bounce budget >= 0.  It reads the wavelength only with a
// plate; a scene with neither a plate nor a RECT bound runs the
// instantiation without plate code (kPlates = false).
//
// Numerics: fp32 throughout, built without --use_fast_math, as K1, with the
// same intersection, normal and physics (trace_seq_common.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "grid_bin.cuh"
#include "trace_seq_common.cuh"

using namespace rtt;

namespace {

template <int kMomBucket, bool kPlates>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* warp_mom = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

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

  // loops over acc unroll fully for bucket 1 (registers), not for 64
  float acc[kMomBucket * kMoments];
#pragma unroll(kMomBucket == 1 ? kMoments : 1)
  for (int j = 0; j < kMomBucket * kMoments; ++j) acc[j] = 0.0f;

  for (int b = 0; b < n_bounces; ++b) {
    if (!(inten > 0.0f)) break;
    // ---- nearest valid row, its physics and the move ----
    const float w = inten;
    RowHit hw = {};
    const int k_win = nonseq_bounce<kPlates>(tab, knd, n_rows, pl, p, d, inten, hw);
    if (k_win < 0) break;

    // ---- a sensor winner records the incoming intensity at its hit ----
    const RowKinds kd = read_row_kinds(knd + k_win * kKindWidth);
    if (kd.sensor) {
      const float x = hw.hs.x, y = hw.hs.y;
      if (counted) {
        // bucket 1 holds one (slot, bundle): its index is 0 at compile time
        float* a = acc + (kMomBucket == 1 ? 0 : (kd.slot * n_bundles + rid) * kMoments);
        a[0] += w;
        a[1] += w * x;
        a[2] += w * y;
        a[3] += w * x * x;
        a[4] += w * y * y;
        a[5] += w * x * y;
        a[6] += 1.0f;
      }
      if (grid != nullptr) grid_add(grid, kd.slot, x, y, w, grid_h, grid_w, grid_e);
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
      const float s = warp_sum(acc[j]);
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

// The plate arguments of a launch: the maps, their descriptors and the
// rays' wavelengths (all null without a plate).
struct PlateArgs {
  const float* maps;
  const int32_t* desc;
  const float* wavelength;
};

template <int kMomBucket, bool kPlates>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           float* const* outs, float* partials, int n_slots, int n_bundles, float* grid,
           int grid_h, int grid_w, float grid_e, const PlateArgs& pa, int n_bounces,
           long long n) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(trace_nonseq_fwd_kernel<kMomBucket, kPlates>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_nonseq_fwd_kernel<kMomBucket, kPlates>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
          ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials,
          n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa.maps, pa.desc, pa.wavelength,
          n_bounces, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlates>
int launch_bucket(size_t smem, long long blocks, cudaStream_t stream, const float* table,
                  const int32_t* kinds, int n_rows, const float* const* rays,
                  const int32_t* ray_id, float* const* outs, float* partials, int n_slots,
                  int n_bundles, float* grid, int grid_h, int grid_w, float grid_e,
                  const PlateArgs& pa, int n_bounces, long long n) {
  if (n_slots * n_bundles == 1)
    return launch<1, kPlates>(smem, blocks, stream, table, kinds, n_rows, rays, ray_id, outs,
                              partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa,
                              n_bounces, n);
  return launch<64, kPlates>(smem, blocks, stream, table, kinds, n_rows, rays, ray_id, outs,
                             partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e, pa,
                             n_bounces, n);
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer: 7 outputs of n floats, a partials buffer of
// ceil(n / 256) * n_slots * n_bundles * 7 floats, and the zeroed
// [n_slots, grid_h, grid_w] grid over [-grid_e, grid_e]^2, or null for no
// grid.  With phase plates, `maps` holds their maps one after the other,
// `map_desc` (offset, h, w) per map, and `wavelength` the n rays'
// wavelengths.  All three null selects the instantiation without plate code,
// which the caller must not give a PHASE_GRID row or a RECT bound.
extern "C" int rtt_trace_nonseq_fwd(const float* table, const int32_t* kinds, int n_rows,
                                    const float* px, const float* py, const float* pz,
                                    const float* dx, const float* dy, const float* dz,
                                    const float* intensity, const int32_t* ray_id, float* opx,
                                    float* opy, float* opz, float* odx, float* ody, float* odz,
                                    float* ointensity, float* partials, int n_slots,
                                    int n_bundles, float* grid, int grid_h, int grid_w,
                                    float grid_e, const float* maps, const int32_t* map_desc,
                                    const float* wavelength, int n_bounces, long long n,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                       static_cast<size_t>(kWarps) * n_slots * n_bundles * kMoments);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  float* outs[7] = {opx, opy, opz, odx, ody, odz, ointensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps != nullptr)
    return launch_bucket<true>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                               partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                               PlateArgs{maps, map_desc, wavelength}, n_bounces, n);
  return launch_bucket<false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs,
                              partials, n_slots, n_bundles, grid, grid_h, grid_w, grid_e,
                              PlateArgs{nullptr, nullptr, nullptr}, n_bounces, n);
}
