// Fused non-sequential backward trace for Hopper (sm_90a): kernel K6, the
// hand-written adjoint of the bounce loop K5 (trace_nonseq_fwd.cu).
//
// Replaces the TPU kernels raytracetorch_tpu/ops/pallas_trace.py::
// _kernel_nonseq_bwd_scan (mode='scan', the default) and _kernel_nonseq_bwd
// (mode='unrolled'), both launched by trace_nonseq_pallas_bwd and joined to
// the forward by the custom_vjp fused_nonseq_grad.  The two compute the same
// vector-Jacobian product (tests/test_pallas.py::
// test_nonseq_bwd_scan_matches_unrolled holds them equal), so this one kernel
// is the counterpart of both, for K5's kinds (pixelated phase plates
// included) with every other optional stream off.
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
//   trace_seq_common.cuh), so it reaches K5's state bit for bit and picks
//   K5's winners; each live bounce keeps its
//   input state (7 floats), its winner row and the winner's branch bits,
//   which come from the very calls that moved the ray (the optional outputs
//   of intersect_row, world_normal and apply_physics).  The wrapper can ask
//   for the state the replay ends at; chip_smoke.py holds it to K5's output.
// - Checkpoints: the TPU kernel keeps every bounce's state in VMEM scratch
//   sized by the budget.  A thread here keeps kCkpt = 8 bounces in an array
//   that the unrolled loops index at compile time, so it lives in registers;
//   nothing of size budget x N is allocated (7 floats x 100 bounces x 1M rays
//   would be 2.8 GB).  8 covers the naive scene (4 winning bounces) and the
//   mirror fold (2).  A ray that lives longer (the two-mirror cavity, 25) is
//   reversed in segments of 8 bounces, the last first: the first replay
//   leaves the last segment in the array; for each earlier segment the
//   thread replays from its start to the segment's first bounce and saves
//   the segment.  The replay runs the same code on the same inputs, so it
//   reaches the same states bit for bit.  The cost is a replay of
//   L^2 / (2 * 8) bounces for a ray that lives L bounces.
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
//   zeros), and per bounce the warp reduces, by shuffles, one row at a time
//   for each distinct winner among its lanes (a ballot picks them), into a
//   [K, 19] slot in shared memory that only this warp writes.  At the end a
//   fixed-order sum over the warps writes a [blocks, K, 19] buffer that the
//   wrapper sums and scatters into [K, 160].  No atomics: deterministic.
//   The cotangent is nonzero only in K2's 19 columns (q, Rw, tw, ph), 23
//   with phase plates.  A scene with neither a plate nor a RECT bound runs
//   the instantiation without plate code (kPlates = false).
//
// What bounds it: per ray it reads 8 input streams and up to 7 cotangents
// (60 B) and writes 7 cotangents (28 B): 88 MB at 1M rays, ~26 us at the
// H100's 3.35 TB/s.  Its arithmetic is K5's (the replay scans every row on
// every bounce) plus, per live bounce, about 3x the winner's own
// intersection and physics (the winner's recompute in row_backward, then an
// adjoint about twice its size; the rows that lose the argmin have a zero
// adjoint), plus the segment replays of long-lived rays and a warp
// reduction per bounce and winner.  On the naive scene that is ~1.6x K5's
// operations, so like K2 and K5 it should be bound by its arithmetic.  This
// is an estimate by count (chip_smoke.py computes the bound from a run's
// rays); PERF.md holds the measured time.
//
// Limits (checked by the wrapper): 1..64 rows, <= 8 sensor slots, 1..8
// bundles, any bounce budget >= 0.  Shared memory is 4 * (168 K + 7 S B +
// 8 * 19 K) bytes: 82 KB at 64 rows, so the launcher raises the block's
// dynamic shared-memory limit above 48 KB.
//
// Numerics: fp32 throughout, built without --use_fast_math, as K2, with K2's
// derivative conventions (trace_seq_bwd.cu).

#include <cstdint>

#include <cuda_runtime.h>

#include "trace_seq_adjoint.cuh"

using namespace rtt;

namespace {

constexpr int kCkpt = 8;  // checkpointed bounces per thread
constexpr unsigned kFull = 0xffffffffu;

// One bounce of K5 (nonseq_bounce, the very function K5 runs).  Returns the
// winner row, or -1 when no row wins (nothing moves); `bits` receives the
// winner's branch bits.
template <bool kPlates>
__device__ __forceinline__ int bounce(const float* tab, const int32_t* knd, int n_rows,
                                      const Plates& pl, V3& p, V3& d, float& inten,
                                      uint32_t& bits) {
  RowHit hw = {};
  bool degen = false;
  PhysBranch br = {};
  const int k = nonseq_bounce<kPlates>(tab, knd, n_rows, pl, p, d, inten, hw, &degen, &br);
  if (k >= 0) bits = branch_bits(hw, degen, br) | kActive;
  return k;
}

// Add the table cotangents tg of a warp's lanes into the warp's [K, 19 or
// 23] slots: one reduction per distinct winner row k among the lanes (k < 0:
// the lane applied no row).  Every lane of the warp calls it.
template <bool kPlates>
__device__ __forceinline__ void reduce_winners(const int32_t* knd, int k, const float* tg,
                                               float* slots, int lane) {
  constexpr int kCols = grad_cols<kPlates>();
  unsigned pending = __ballot_sync(kFull, k >= 0);
  while (pending != 0u) {
    const int row = __shfl_sync(kFull, k, __ffs(pending) - 1);
    const bool mine = k == row;
    pending &= ~__ballot_sync(kFull, mine);
    float m[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) m[c] = mine ? tg[c] : 0.0f;
    reduce_row<kPlates>(read_row_kinds(knd + row * kKindWidth), m, slots + row * kCols, lane);
  }
}

template <bool kPlates>
__global__ void __launch_bounds__(kThreads)
trace_nonseq_bwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
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
                        float* __restrict__ rpx, float* __restrict__ rpy, float* __restrict__ rpz,
                        float* __restrict__ rdx, float* __restrict__ rdy, float* __restrict__ rdz,
                        float* __restrict__ rintensity, int n_slots, int n_bundles, GridCt gg,
                        const float* __restrict__ maps, const int32_t* __restrict__ map_desc,
                        const float* __restrict__ wavelength, float* __restrict__ gmaps,
                        int n_bounces, long long n) {
  constexpr int kCols = grad_cols<kPlates>();
  extern __shared__ float smem[];
  float* tab = smem;
  int32_t* knd = reinterpret_cast<int32_t*>(smem + n_rows * kRowWidth);
  float* gm = smem + n_rows * (kRowWidth + kKindWidth);
  const int n_mom = n_slots * n_bundles * kMoments;
  float* warp_tab = gm + n_mom;  // [kWarps, n_rows, kCols]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n_rows * kRowWidth; j += kThreads) tab[j] = table[j];
  for (int j = tid; j < n_rows * kKindWidth; j += kThreads) knd[j] = kinds[j];
  for (int j = tid; j < n_mom; j += kThreads) gm[j] = gmom[j];
  for (int j = tid; j < kWarps * n_rows * kCols; j += kThreads) warp_tab[j] = 0.0f;
  __syncthreads();

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
  // last segment of them in the checkpoints ----
  float ck[kCkpt][7];  // each bounce's input state p, d, intensity
  uint32_t ckw[kCkpt];  // its winner row << 16 | the winner's bits
  V3 p = p0, d = d0;
  float inten = i0;
  int n_live = 0;
  bool going = true;
  for (int s = 0; going; s += kCkpt) {
#pragma unroll
    for (int j = 0; j < kCkpt; ++j) {
      if (going && (s + j >= n_bounces || !(inten > 0.0f))) going = false;
      if (going) {
        // a bounce that no row wins leaves slot j alone: it may hold bounce
        // s + j - kCkpt of the last segment, which the reverse sweep needs
        const V3 pb = p, db = d;
        const float ib = inten;
        uint32_t bits = 0;
        const int k = bounce<kPlates>(tab, knd, n_rows, pl, p, d, inten, bits);
        if (k < 0) {
          going = false;
        } else {
          ck[j][0] = pb.x;
          ck[j][1] = pb.y;
          ck[j][2] = pb.z;
          ck[j][3] = db.x;
          ck[j][4] = db.y;
          ck[j][5] = db.z;
          ck[j][6] = ib;
          ckw[j] = (static_cast<uint32_t>(k) << 16) | bits;
          n_live = s + j + 1;
        }
      }
    }
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

  // ---- reverse sweep, in segments of kCkpt bounces, the last first ----
  V3 gp = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  float gi = 0.0f;
  if (live) {
    gp = {gpx ? gpx[i] : 0.0f, gpy ? gpy[i] : 0.0f, gpz ? gpz[i] : 0.0f};
    gd = {gdx ? gdx[i] : 0.0f, gdy ? gdy[i] : 0.0f, gdz ? gdz[i] : 0.0f};
    gi = gintensity ? gintensity[i] : 0.0f;
  }
  const int warp_live = __reduce_max_sync(kFull, n_live);
  const int s_last = warp_live > 0 ? (warp_live - 1) / kCkpt * kCkpt : -1;
  float* slots = warp_tab + warp * n_rows * kCols;
  for (int s = s_last; s >= 0; s -= kCkpt) {  // warp-uniform
    if (s != s_last && s < n_live) {
      // replay from the ray's start to bounce s, then save [s, s + kCkpt)
      p = p0;
      d = d0;
      inten = i0;
      uint32_t bits = 0;
      for (int b = 0; b < s; ++b) bounce<kPlates>(tab, knd, n_rows, pl, p, d, inten, bits);
#pragma unroll
      for (int j = 0; j < kCkpt; ++j) {
        if (s + j < n_live) {
          ck[j][0] = p.x;
          ck[j][1] = p.y;
          ck[j][2] = p.z;
          ck[j][3] = d.x;
          ck[j][4] = d.y;
          ck[j][5] = d.z;
          ck[j][6] = inten;
          const int k = bounce<kPlates>(tab, knd, n_rows, pl, p, d, inten, bits);
          ckw[j] = (static_cast<uint32_t>(k) << 16) | bits;
        }
      }
    }
#pragma unroll
    for (int j = kCkpt - 1; j >= 0; --j) {
      if (s + j < warp_live) {  // warp-uniform
        const bool act = s + j < n_live;
        const int k = act ? static_cast<int>(ckw[j] >> 16) : -1;
        float tg[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) tg[c] = 0.0f;
        if (act) {
          const V3 sp = {ck[j][0], ck[j][1], ck[j][2]};
          const V3 sd = {ck[j][3], ck[j][4], ck[j][5]};
          row_backward<kPlates>(tab + k * kRowWidth, read_row_kinds(knd + k * kKindWidth), sp,
                                sd, ck[j][6], ckw[j] & 0xffffu, rid, gm, n_bundles, gg, pl,
                                gmaps, gp, gd, gi, tg);
        }
        if (partials != nullptr) reduce_winners<kPlates>(knd, k, tg, slots, lane);
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

  if (partials == nullptr) return;
  __syncthreads();
  const int n_tab = n_rows * kCols;
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_tab;
  for (int j = tid; j < n_tab; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_tab[w * n_tab + j];
    out[j] = s;
  }
}

template <bool kPlates>
int launch(long long blocks, cudaStream_t stream, const float* table, const int32_t* kinds,
           int n_rows, const float* const* rays, const int32_t* ray_id,
           const float* const* g_rays, const float* gmom, float* const* c_rays, float* partials,
           float* const* r_rays, int n_slots, int n_bundles, GridCt gg, const float* maps,
           const int32_t* map_desc, const float* wavelength, float* gmaps, int n_bounces,
           long long n) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                       static_cast<size_t>(n_slots) * n_bundles * kMoments +
                       static_cast<size_t>(kWarps) * n_rows * grad_cols<kPlates>());
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(trace_nonseq_bwd_kernel<kPlates>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_nonseq_bwd_kernel<kPlates><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      table, kinds, n_rows, rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
      ray_id, g_rays[0], g_rays[1], g_rays[2], g_rays[3], g_rays[4], g_rays[5], g_rays[6], gmom,
      c_rays[0], c_rays[1], c_rays[2], c_rays[3], c_rays[4], c_rays[5], c_rays[6], partials,
      r_rays[0], r_rays[1], r_rays[2], r_rays[3], r_rays[4], r_rays[5], r_rays[6], n_slots,
      n_bundles, gg, maps, map_desc, wavelength, gmaps, n_bounces, n);
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
// four are null.
extern "C" int rtt_trace_nonseq_bwd(
    const float* table, const int32_t* kinds, int n_rows, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz, const float* intensity,
    const int32_t* ray_id, const float* gpx, const float* gpy, const float* gpz,
    const float* gdx, const float* gdy, const float* gdz, const float* gintensity,
    const float* gmom, float* cpx, float* cpy, float* cpz, float* cdx, float* cdy, float* cdz,
    float* cintensity, float* partials, float* rpx, float* rpy, float* rpz, float* rdx,
    float* rdy, float* rdz, float* rintensity, int n_slots, int n_bundles, const float* ggrid,
    int grid_h, int grid_w, float grid_e, const float* maps, const int32_t* map_desc,
    const float* wavelength, float* gmaps, int n_bounces, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0 || n_rows > 64 || n_slots * n_bundles > 64 || n_bounces < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr && (map_desc == nullptr || wavelength == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* rays[7] = {px, py, pz, dx, dy, dz, intensity};
  const float* g_rays[7] = {gpx, gpy, gpz, gdx, gdy, gdz, gintensity};
  float* c_rays[7] = {cpx, cpy, cpz, cdx, cdy, cdz, cintensity};
  float* r_rays[7] = {rpx, rpy, rpz, rdx, rdy, rdz, rintensity};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GridCt gg = {ggrid, grid_h, grid_w, grid_e};
  if (maps != nullptr)
    return launch<true>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                        partials, r_rays, n_slots, n_bundles, gg, maps, map_desc, wavelength,
                        gmaps, n_bounces, n);
  return launch<false>(blocks, s, table, kinds, n_rows, rays, ray_id, g_rays, gmom, c_rays,
                       partials, r_rays, n_slots, n_bundles, gg, nullptr, nullptr, nullptr,
                       nullptr, n_bounces, n);
}
