// Fused sequential forward trace for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::_kernel_v2
// (launched by trace_sequential_pallas_v2, chain body _chain_pure) for the
// main-path kinds and pixelated phase plates, with every other optional
// stream off.  Its plain PyTorch version is ops/fused_trace.py::
// trace_sequential_fused_plain, and the wrapper that launches it is
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
// with i < n (no padding copy).  The flat [K, 160] table and the int32
// [K, 8] kinds sit in shared memory, loaded once per block; every thread
// visits the same row at the same time, so the switch on a row's kinds is
// warp-uniform and costs no divergence.  Moments: warp shuffles, then one
// partial per warp in shared memory, then one per block summed in fixed warp
// order into a [blocks, S, B, 7] buffer that the wrapper sums.  No atomics:
// the moments are deterministic.  The grid takes one atomicAdd per sensor
// hit into the [S, H, W] grid in device memory (grid_bin.cu says what that
// costs); with no grid the pointer is null and nothing else changes.  The
// phase maps stay in device memory, concatenated, read through L2 (a 256 x
// 256 map is 256 KB); with no plate (and no RECT bound, which is plate
// code too: trace_seq_common.cuh) their pointer is null and the kernel
// instantiated without plate code (kPlates = false) runs, so such a scene
// runs the instructions it ran before plates existed.
//
// What bounds it: per ray it reads 8 streams (32 B; the wavelength stream,
// 4 B more, only with a plate) and writes 7 (28 B), and does
// some hundreds of fp32 operations over the 5 rows of the main path.  At 1M
// rays that is 60 MB, ~18 us at the H100's 3.35 TB/s, so the kernel should
// be bound by bandwidth and launch overhead.  This is an estimate by count;
// PERF.md holds the measured time.
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

template <bool kPlates>
__global__ void __launch_bounds__(kThreads)
trace_seq_fwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
                     int n_rows, const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ pz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
                     float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
                     float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
                     float* __restrict__ ointensity, float* __restrict__ partials, int n_slots,
                     int n_bundles, float* __restrict__ grid, int grid_h, int grid_w,
                     float grid_e, const float* __restrict__ maps,
                     const int32_t* __restrict__ map_desc, const float* __restrict__ wavelength,
                     long long n) {
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* warp_mom = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < kWarps * n_mom; j += kThreads) warp_mom[j] = 0.0f;
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  // Threads past the ragged edge trace a zero ray of zero intensity: every
  // step stays finite, and they contribute nothing to the moments.
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

  for (int k = 0; k < n_rows; ++k) {
    const float* r = tab + k * kRowWidth;
    const RowKinds kd = read_row_kinds(knd + k * kKindWidth);
    const RowHit h = intersect_row<kPlates>(r, kd, p, d);
    const V3 nw = world_normal(r, kd.plane, h.hs);
    V3 nd;
    float imod;
    apply_physics<kPlates>(r, kd.ph, kd.sb, kd.map, d, nw, h.hs, pl, nd, imod);
    const bool active = h.valid && inten > 0.0f;
    const float t = h.t;

    // ---- sensor moments and grid of the incoming intensity ----
    if (kd.sensor) {
      const float w = active ? inten : 0.0f;
      const float x = h.hs.x, y = h.hs.y;
      const float terms[kMoments] = {w,         w * x,     w * y, w * x * x,
                                     w * y * y, w * x * y, w > 0.0f ? 1.0f : 0.0f};
      float* dst = warp_mom + warp * n_mom + kd.slot * n_bundles * kMoments;
      for (int b = 0; b < n_bundles; ++b) {
#pragma unroll
        for (int m = 0; m < kMoments; ++m) {
          const float s = warp_sum(rid == b ? terms[m] : 0.0f);
          if (lane == 0) dst[b * kMoments + m] += s;
        }
      }
      if (grid != nullptr) grid_add(grid, kd.slot, x, y, w, grid_h, grid_w, grid_e);
    }

    if (active) {
      p = fma3(p, t, d);
      d = nd;
      inten = inten * imod;
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

  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_mom;
  for (int j = tid; j < n_mom; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_mom[w * n_mom + j];
    out[j] = s;
  }
}

template <bool kPlates>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           float* const* outs, float* partials, int n_slots, int n_bundles, float* grid,
           int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
           const float* wavelength, long long n) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(trace_seq_fwd_kernel<kPlates>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_seq_fwd_kernel<kPlates><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
      ray_id, outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], outs[6], partials, n_slots,
      n_bundles, grid, grid_h, grid_w, grid_e, maps, map_desc, wavelength, n);
  return static_cast<int>(cudaGetLastError());
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
extern "C" int rtt_trace_seq_fwd(const float* table, const int32_t* kinds, int n_rows,
                                 const float* px, const float* py, const float* pz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* intensity, const int32_t* ray_id, float* opx,
                                 float* opy, float* opz, float* odx, float* ody, float* odz,
                                 float* ointensity, float* partials, int n_slots, int n_bundles,
                                 float* grid, int grid_h, int grid_w, float grid_e,
                                 const float* maps, const int32_t* map_desc,
                                 const float* wavelength, long long n, void* stream) {
  if (n <= 0) return 0;
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
    return launch<true>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs, partials,
                        n_slots, n_bundles, grid, grid_h, grid_w, grid_e, maps, map_desc,
                        wavelength, n);
  return launch<false>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, outs, partials,
                       n_slots, n_bundles, grid, grid_h, grid_w, grid_e, nullptr, nullptr,
                       nullptr, n);
}
