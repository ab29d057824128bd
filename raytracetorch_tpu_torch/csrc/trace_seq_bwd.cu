// Fused sequential backward trace for Hopper (sm_90a): kernel K2, the
// hand-written adjoint of K1 (trace_seq_fwd.cu).
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_v2_bwd (launched by trace_sequential_pallas_v2_bwd, joined to the
// forward by the custom_vjp fused_trace_grad) for the main-path kinds with
// every optional stream off.  Its plain PyTorch version is
// ops/fused_trace.py::trace_seq_bwd_plain (autograd of the eager chain), and
// the wrapper that launches it is ops/fused_trace.py::trace_seq_bwd_cuda.
//
// What it computes: the vector-Jacobian product of the fused forward.  Given
// the table, the input rays, the cotangents of the 7 output ray streams, of
// the [S, B, 7] moments and (when K1 binned a grid) of the [S, H, W] grid,
// it returns the cotangents of the 7 input ray streams and of the table.
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
//   from a re-rounded state.  The saved state is a per-thread array sized by
//   the template bucket kMaxRows: with 8 the loops unroll and it stays in
//   registers (the main path has 5 rows); with 64 it lives in local memory.
// - Reverse sweep, row K-1 down to 0: the adjoint of the masked update
//   where(active, new, old), of the sensor moment terms, of the physics
//   (REFLECT, SNELL with the from_in and TIR branches, APERTURE with its mask
//   constant, BLOCK), of the normal (zero for a degenerate one) and of the
//   intersection (plane formula or the quadric root taken), then of the
//   world->surface frame.  An inactive row passes every cotangent through.
// - Table cotangent: the world-scale epsilon, the bound columns (sb, vb, Rs,
//   ts) and n_sign enter the chain only through comparisons and selects, so
//   their cotangent is zero.  A row's cotangent is nonzero only in q[0:5],
//   Rw[0:9], tw[0:3] and ph[0:2]: 19 of 160 columns.  Those are reduced over
//   the block (warp shuffles, one slot per warp and row in shared memory, a
//   fixed-order sum over warps) into a [blocks, K, 19] buffer that the
//   wrapper sums and scatters into [K, 160].  No atomics: deterministic.
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
// adjoint about twice the size of the forward), plus 19 warp reductions per
// row.  At 1M rays that is 88 MB, ~26 us at the H100's 3.35 TB/s; K1 measured
// far above its bandwidth bound, so K2 should be bound by its arithmetic and
// the per-row reductions.  This is an estimate by count; PERF.md holds the
// measured time.
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

template <int kMaxRows>
__global__ void __launch_bounds__(kThreads)
trace_seq_bwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
                     int n_rows, const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ pz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
                     const float* __restrict__ gpx, const float* __restrict__ gpy,
                     const float* __restrict__ gpz, const float* __restrict__ gdx,
                     const float* __restrict__ gdy, const float* __restrict__ gdz,
                     const float* __restrict__ gintensity, const float* __restrict__ gmom,
                     float* __restrict__ cpx, float* __restrict__ cpy, float* __restrict__ cpz,
                     float* __restrict__ cdx, float* __restrict__ cdy, float* __restrict__ cdz,
                     float* __restrict__ cintensity, float* __restrict__ partials,
                     int n_slots, int n_bundles, GridCt gg, long long n) {
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* gm = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* warp_tab = gm + n_mom;  // [kWarps, n_rows, kGradCols]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < n_mom; j += kThreads) gm[j] = gmom[j];
  for (int j = tid; j < kWarps * n_rows * kGradCols; j += kThreads) warp_tab[j] = 0.0f;
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = i < n;
  V3 p = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  float inten = 0.0f;
  int rid = -1;
  if (live) {
    p = {px[i], py[i], pz[i]};
    d = {dx[i], dy[i], dz[i]};
    inten = intensity[i];
    rid = ray_id[i];
  }

  // ---- forward sweep: save each row's input state and branch bits ----
  float saved[kMaxRows][7];
  uint32_t bits[kMaxRows];
#pragma unroll (kMaxRows <= 8 ? kMaxRows : 1)
  for (int k = 0; k < kMaxRows; ++k) {
    if (k < n_rows) {
      saved[k][0] = p.x;
      saved[k][1] = p.y;
      saved[k][2] = p.z;
      saved[k][3] = d.x;
      saved[k][4] = d.y;
      saved[k][5] = d.z;
      saved[k][6] = inten;
      bits[k] = row_forward(tab + k * kRowWidth, read_row_kinds(knd + k * kKindWidth), p, d, inten);
    }
  }

  // ---- reverse sweep ----
  V3 gp = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  float gi = 0.0f;
  if (live) {
    gp = {gpx ? gpx[i] : 0.0f, gpy ? gpy[i] : 0.0f, gpz ? gpz[i] : 0.0f};
    gd = {gdx ? gdx[i] : 0.0f, gdy ? gdy[i] : 0.0f, gdz ? gdz[i] : 0.0f};
    gi = gintensity ? gintensity[i] : 0.0f;
  }
#pragma unroll (kMaxRows <= 8 ? kMaxRows : 1)
  for (int kk = kMaxRows - 1; kk >= 0; --kk) {
    if (kk < n_rows) {
      const RowKinds kd = read_row_kinds(knd + kk * kKindWidth);
      float tg[kGradCols];
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) tg[c] = 0.0f;
      const V3 sp = {saved[kk][0], saved[kk][1], saved[kk][2]};
      const V3 sd = {saved[kk][3], saved[kk][4], saved[kk][5]};
      row_backward(tab + kk * kRowWidth, kd, sp, sd, saved[kk][6], bits[kk], rid, gm,
                   n_bundles, gg, gp, gd, gi, tg);
      if (partials != nullptr && __any_sync(0xffffffffu, bits[kk] & kActive))
        reduce_row(kd, tg, warp_tab + (warp * n_rows + kk) * kGradCols, lane);
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

  if (partials == nullptr) return;
  __syncthreads();
  const int n_tab = n_rows * kGradCols;
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_tab;
  for (int j = tid; j < n_tab; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_tab[w * n_tab + j];
    out[j] = s;
  }
}

template <int kMaxRows>
int launch(size_t smem, long long blocks, cudaStream_t stream, const float* table,
           const int32_t* kinds, int n_rows, const float* const* rays, const int32_t* ray_id,
           const float* const* g_rays, const float* gmom, float* const* c_rays, float* partials,
           int n_slots, int n_bundles, GridCt gg, long long n) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(trace_seq_bwd_kernel<kMaxRows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_seq_bwd_kernel<kMaxRows><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
      ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6], gmom,
      c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6], partials,
      n_slots, n_bundles, gg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer.  Each of the 7 output-ray cotangents
// g* may be null (a zero cotangent); the 7 input-ray cotangents c* are all
// given or all null (not wanted), and so is the partials buffer of
// ceil(n / 256) * n_rows * 19 floats (the table cotangent).  gmom holds
// n_slots * n_bundles * 7 floats; ggrid, the grid's cotangent, holds
// n_slots * grid_h * grid_w floats over [-grid_e, grid_e]^2, or is null.
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
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                       static_cast<size_t>(n_slots) * n_bundles * kMoments +
                       static_cast<size_t>(kWarps) * n_rows * kGradCols);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  const float* g_rays[7] = {gpx, gpy, gpz, gdx, gdy, gdz, gintensity};
  float* c_rays[7] = {cpx, cpy, cpz, cdx, cdy, cdz, cintensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  if (n_rows <= 8)
    return launch<8>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                     partials, n_slots, n_bundles, gg, n);
  return launch<64>(smem, blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                    partials, n_slots, n_bundles, gg, n);
}
