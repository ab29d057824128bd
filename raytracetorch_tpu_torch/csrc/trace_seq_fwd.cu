// Fused sequential forward trace for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel raytracetorch_tpu/ops/pallas_trace.py::_kernel_v2
// (launched by trace_sequential_pallas_v2, chain body _chain_pure) for the
// main-path kinds, with every optional stream off.  Its plain PyTorch
// version is ops/fused_trace.py::trace_sequential_fused_plain, and the
// wrapper that launches it is ops/fused_trace.py::trace_seq_fwd_cuda.
//
// What it computes, per ray, for each of the K table rows in order:
// intersect (plane fast path or the quadric solver), surface-local bound per
// root, the minimum positive root above the world-scale epsilon, volume
// bound, normal, physics, and the masked update where(active, new, old) with
// active = valid & intensity > 0.  On sensor rows it adds the 7 moment terms
// (w, wx, wy, wx^2, wy^2, wxy, w>0) of the masked INCOMING intensity into
// (slot, bundle).
//
// Design: one thread per ray, 256 threads per block, the ragged edge masked
// with i < n (no padding copy).  The flat [K, 160] table and the int32
// [K, 8] kinds sit in shared memory, loaded once per block; every thread
// visits the same row at the same time, so the switch on a row's kinds is
// warp-uniform and costs no divergence.  Moments: warp shuffles, then one
// partial per warp in shared memory, then one per block summed in fixed warp
// order into a [blocks, S, B, 7] buffer that the wrapper sums.  No atomics:
// the result is deterministic.
//
// What bounds it: per ray it reads 8 streams (32 B; the wavelength stream is
// not read, no supported row is dispersive) and writes 7 (28 B), and does
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWidth = 160;
constexpr int kKindWidth = 8;
constexpr int kMoments = 7;

// Offsets of the float columns in a flat row (core/table.py ROW_FIELDS).
constexpr int kQ = 0, kNSign = 5, kRw = 6, kTw = 15, kRs = 18, kTs = 27;
constexpr int kSb = 30, kVb = 34, kPh = 42;

// Columns of a kinds row (ops/fused_trace.py::kind_rows).
constexpr int kPhCol = 0, kSbCol = 1, kVbCol = 2, kPlaneCol = 3;
constexpr int kSensorCol = 4, kSlotCol = 5, kInvertCol = 6;

// constants.py and geom/surfaces.py
constexpr float kBig = 1e30f;
constexpr float kIntersectEps = 1e-6f;
constexpr float kSolverEps = 1e-6f;
constexpr float kNormalEps = 1e-8f;
constexpr float kRelEps = 1e-5f;

enum PhysKind { TRANSMIT = 0, BLOCK = 1, REFLECT = 2, SNELL = 3, APERTURE = 6 };
enum SBKind { SB_NONE = 0, SB_DISK = 1, SB_HEMI = 4 };
enum VBKind { VB_NONE = 0, VB_APER_R2 = 1, VB_Z_BETWEEN = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// u + s * v
__device__ __forceinline__ V3 fma3(V3 u, float s, V3 v) {
  return {u.x + s * v.x, u.y + s * v.y, u.z + s * v.z};
}

// v @ R with R a row-major 3x3
__device__ __forceinline__ V3 rot(V3 v, const float* R) {
  return {v.x * R[0] + v.y * R[3] + v.z * R[6],
          v.x * R[1] + v.y * R[4] + v.z * R[7],
          v.x * R[2] + v.y * R[5] + v.z * R[8]};
}

// v @ R.T
__device__ __forceinline__ V3 rot_t(V3 v, const float* R) {
  return {v.x * R[0] + v.y * R[1] + v.z * R[2],
          v.x * R[3] + v.y * R[4] + v.z * R[5],
          v.x * R[6] + v.y * R[7] + v.z * R[8]};
}

__device__ __forceinline__ bool sb_check(int kind, const float* sb, V3 h) {
  if (kind == SB_DISK) {
    const float a = h.x - sb[1], b = h.y - sb[2];
    return a * a + b * b <= sb[0];
  }
  if (kind == SB_HEMI) return fabsf(h.z * sb[0]) < 1.0f + kIntersectEps;
  return true;
}

__device__ __forceinline__ bool vb_check(int kind, const float* vb, V3 h) {
  if (kind == VB_APER_R2) return h.x * h.x + h.y * h.y <= vb[0];
  if (kind == VB_Z_BETWEEN) return h.z >= vb[0] && h.z <= vb[1];
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
trace_seq_fwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ kinds,
                     int n_rows, const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ pz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ intensity, const int32_t* __restrict__ ray_id,
                     float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
                     float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
                     float* __restrict__ ointensity, float* __restrict__ partials, int n_slots,
                     int n_bundles, long long n) {
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
  if (live) {
    p = {px[i], py[i], pz[i]};
    d = {dx[i], dy[i], dz[i]};
    inten = intensity[i];
    rid = ray_id[i];
  }

  for (int k = 0; k < n_rows; ++k) {
    const float* r = tab + k * kRowWidth;
    const int32_t* kd = knd + k * kKindWidth;
    const int ph = kd[kPhCol], sbk = kd[kSbCol], vbk = kd[kVbCol];
    const bool plane = kd[kPlaneCol] != 0, invert = kd[kInvertCol] != 0;
    const float* q = r + kQ;
    const float* Rw = r + kRw;

    // ---- intersect (core/intersect.py) ----
    const V3 o = rot(V3{p.x - r[kTw], p.y - r[kTw + 1], p.z - r[kTw + 2]}, Rw);
    const V3 ds = rot(d, Rw);
    float t1, t2;
    bool v1, v2;
    if (plane) {
      // q = (0,0,0,-2,0): the solver's linear branch, t = 2 oz / B_safe
      const float B = -2.0f * ds.z;
      const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
      t1 = (2.0f * o.z) / B_safe;
      v1 = fabsf(B) >= kSolverEps;
      t2 = t1;
      v2 = false;
    } else {
      // geom/surfaces.py::solve_roots
      const float A = q[0] * ds.x * ds.x + q[1] * ds.y * ds.y + q[2] * ds.z * ds.z;
      const float B =
          2.0f * (q[0] * o.x * ds.x + q[1] * o.y * ds.y + q[2] * o.z * ds.z) + q[3] * ds.z;
      const float C = q[0] * o.x * o.x + q[1] * o.y * o.y + q[2] * o.z * o.z + q[3] * o.z + q[4];
      const float disc = B * B - 4.0f * A * C;
      const bool hit = disc >= 0.0f;
      const float sq = sqrtf((hit ? disc : 1.0f) + 1e-24f);
      const bool linear = fabsf(A) < kSolverEps;
      const float A_safe = linear ? 1.0f : A;
      const float B_safe = fabsf(B) < kSolverEps ? kSolverEps : B;
      const float t_lin = -C / B_safe;
      t1 = linear ? t_lin : (-B - sq) / (2.0f * A_safe);
      t2 = linear ? t_lin : (-B + sq) / (2.0f * A_safe);
      v1 = (linear && fabsf(B) >= kSolverEps) || (!linear && hit);
      v2 = v1;
    }
    if (sbk != SB_NONE) {
      bool keep1 = sb_check(sbk, r + kSb, fma3(o, t1, ds));
      bool keep2 = sb_check(sbk, r + kSb, fma3(o, t2, ds));
      if (invert) {
        keep1 = !keep1;
        keep2 = !keep2;
      }
      v1 = v1 && keep1;
      v2 = v2 && keep2;
    }
    // geom/surfaces.py::min_positive with the world-scale epsilon
    const float scale = sqrtf(dot3(o, o) + dot3(p, p) + 1e-12f);
    const float eps = kIntersectEps + kRelEps * scale;
    const float tm1 = (v1 && t1 > eps) ? t1 : kBig;
    const float tm2 = (v2 && t2 > eps) ? t2 : kBig;
    const float t_best = fminf(tm1, tm2);
    bool valid = t_best < kBig * 0.5f;
    const float t = valid ? t_best : 0.0f;
    const V3 hs = fma3(o, t, ds);
    if (vbk != VB_NONE) {
      const V3 e = rot_t(hs, r + kRs);
      const V3 he = {e.x + r[kTs], e.y + r[kTs + 1], e.z + r[kTs + 2]};
      valid = valid && vb_check(vbk, r + kVb, he);
    }

    // ---- world normal (core/intersect.py::normal_world) ----
    V3 nw;
    if (plane) {
      nw = {Rw[2], Rw[5], Rw[8]};
    } else {
      const float gx = 2.0f * q[0] * hs.x;
      const float gy = 2.0f * q[1] * hs.y;
      const float gz = 2.0f * q[2] * hs.z + q[3];
      const float g2 = gx * gx + gy * gy + gz * gz;
      const bool degen = g2 < kNormalEps * kNormalEps;
      const float inv =
          (r[kNSign] < 0.0f ? -1.0f : 1.0f) / (sqrtf(degen ? 1.0f : g2) + kNormalEps);
      const V3 nl = degen ? V3{0.0f, 0.0f, 1.0f} : V3{gx * inv, gy * inv, gz * inv};
      nw = rot_t(nl, Rw);
    }

    // ---- physics (core/static_dispatch.py::apply_physics_one) ----
    V3 nd = d;
    float imod = 1.0f;
    if (ph == BLOCK) {
      nd = {0.0f, 0.0f, 0.0f};
      imod = 0.0f;
    } else if (ph == REFLECT) {
      nd = fma3(d, -2.0f * dot3(d, nw), nw);
    } else if (ph == SNELL) {
      const float dn = dot3(d, nw);
      const bool from_in = dn < 0.0f;
      const float eff_sign = from_in ? 1.0f : -1.0f;
      const float cos_i = fabsf(dn);
      const float n1 = from_in ? r[kPh] : r[kPh + 1];
      const float n2 = from_in ? r[kPh + 1] : r[kPh];
      const float mu = n1 / (fabsf(n2) < 1e-12f ? 1e-12f : n2);
      const float sin2_t = mu * mu * (1.0f - cos_i * cos_i);
      if (sin2_t > 1.0f) {  // total internal reflection
        nd = fma3(d, -2.0f * dn, nw);
      } else {
        const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        const float coef = (mu * cos_i - cos_t) * eff_sign;
        nd = fma3(V3{d.x * mu, d.y * mu, d.z * mu}, coef, nw);
      }
    } else if (ph == APERTURE) {
      // the filter re-checks its own RAW (non-inverted) bound
      const float mod = sb_check(sbk, r + kSb, hs) ? 1.0f : 0.0f;
      nd = {d.x * mod, d.y * mod, d.z * mod};
      imod = mod;
    }

    const bool active = valid && inten > 0.0f;

    // ---- sensor moments of the incoming intensity ----
    if (kd[kSensorCol] != 0) {
      const float w = active ? inten : 0.0f;
      const float x = hs.x, y = hs.y;
      const float terms[kMoments] = {w,         w * x,     w * y, w * x * x,
                                     w * y * y, w * x * y, w > 0.0f ? 1.0f : 0.0f};
      float* dst = warp_mom + warp * n_mom + kd[kSlotCol] * n_bundles * kMoments;
      for (int b = 0; b < n_bundles; ++b) {
#pragma unroll
        for (int m = 0; m < kMoments; ++m) {
          const float s = warp_sum(rid == b ? terms[m] : 0.0f);
          if (lane == 0) dst[b * kMoments + m] += s;
        }
      }
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

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0 on success).
// The caller owns every buffer: 7 outputs of n floats and a partials buffer
// of ceil(n / 256) * n_slots * n_bundles * 7 floats.
extern "C" int rtt_trace_seq_fwd(const float* table, const int32_t* kinds, int n_rows,
                                 const float* px, const float* py, const float* pz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* intensity, const int32_t* ray_id, float* opx,
                                 float* opy, float* opz, float* odx, float* ody, float* odz,
                                 float* ointensity, float* partials, int n_slots, int n_bundles,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_rows) * (kRowWidth + kKindWidth) +
                       static_cast<size_t>(kWarps) * n_slots * n_bundles * kMoments);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_seq_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_seq_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      table, kinds, n_rows, px, py, pz, dx, dy, dz, intensity, ray_id, opx, opy, opz, odx, ody,
      odz, ointensity, partials, n_slots, n_bundles, n);
  return static_cast<int>(cudaGetLastError());
}
