// Fuzzy apodization programs for the fused kernels' instantiation with them
// (kFuzzy): the interpreter of a traced component-style callable w(x, y, z)
// and, for the adjoints, its forward-mode partials dw/d(x, y, z).
//
// The TPU kernels run the callable itself (Mosaic traces the Python function
// into their bodies: raytracetorch_tpu/ops/pallas_trace.py::_chain_pure
// :1623, _nonseq_bounce_core :967, and through jax.vjp their adjoints).  A
// kernel built once from the repository's sources cannot, so the host traces
// the callable once into a straight-line program (ops/fuzzy_program.py) and
// the kernels interpret it per ray.  Its plain version is
// ops/fuzzy_program.py::evaluate, which follows this file operation by
// operation.
//
// The buffer (ops/fuzzy_program.py::pack), int32 words copied into each
// block's shared memory: a word per table row, the offset of the row's
// program in the buffer or -1; then each distinct program: its operation
// count and result register, then two words an operation, `code | dst << 8
// | a << 16 | b << 24` and the third operand (where's second branch) or a
// constant's float32 bits.  The registers 0, 1 and 2 start with x, y and z.
//
// Numerics: every product, sum and quotient is rounded on its own (no
// contraction into an FMA), as torch's elementwise operations round the
// plain version's; exp is expf (not the fast __expf); masks are 0 or 1.  The
// partials follow autograd's rules: a comparison, a mask operation and a
// mask's cast have none, where selects its branch's, abs takes sign(a) (0
// at 0), sqrt da / (2 sqrt(a)).
//
// Cost: one dispatch (a shared-memory load and a switch) an operation, plus
// its arithmetic; the register file (16 floats, 64 with the partials) is
// indexed at run time, so it lives in local memory (L1).  The telescope
// pupil's mask is 85 operations.
//
// The functions are __host__ __device__ and use no CUDA type, so the same
// source compiles as plain C++ for a host check against the plain version.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define RTT_FZ_HD __host__ __device__ __forceinline__
#else
#define RTT_FZ_HD inline
#endif

namespace rtt {

// The limits of a program (ops/fuzzy_program.py::MAX_OPS, MAX_REGS) and of a
// table's buffer (MAX_WORDS).
constexpr int kFuzzyMaxOps = 128;
constexpr int kFuzzyMaxRegs = 16;
constexpr int kFuzzyMaxWords = 2048;

// The operations (ops/fuzzy_program.py::OPS, in this order).
enum FuzzyOp : int {
  kFzConst = 0,
  kFzAdd = 1,
  kFzSub = 2,
  kFzMul = 3,
  kFzDiv = 4,
  kFzNeg = 5,
  kFzAbs = 6,
  kFzExp = 7,
  kFzSqrt = 8,
  kFzLt = 9,
  kFzLe = 10,
  kFzGt = 11,
  kFzGe = 12,
  kFzAnd = 13,
  kFzOr = 14,
  kFzNot = 15,
  kFzWhere = 16,
  kFzCast = 17,
};

#ifdef __CUDA_ARCH__
RTT_FZ_HD float fz_mul(float a, float b) { return __fmul_rn(a, b); }
RTT_FZ_HD float fz_add(float a, float b) { return __fadd_rn(a, b); }
RTT_FZ_HD float fz_sub(float a, float b) { return __fsub_rn(a, b); }
RTT_FZ_HD float fz_div(float a, float b) { return __fdiv_rn(a, b); }
RTT_FZ_HD float fz_sqrt(float a) { return __fsqrt_rn(a); }
RTT_FZ_HD float fz_bits(int32_t w) { return __int_as_float(w); }
#else
RTT_FZ_HD float fz_mul(float a, float b) { return a * b; }
RTT_FZ_HD float fz_add(float a, float b) { return a + b; }
RTT_FZ_HD float fz_sub(float a, float b) { return a - b; }
RTT_FZ_HD float fz_div(float a, float b) { return a / b; }
RTT_FZ_HD float fz_sqrt(float a) { return std::sqrt(a); }
RTT_FZ_HD float fz_bits(int32_t w) {
  float f;
  std::memcpy(&f, &w, sizeof f);
  return f;
}
#endif

// A program's value and, for the adjoints, its partials at the hit.
struct FuzzyDual {
  float w, gx, gy, gz;
};

// Runs the program at `prog` (its first word, the operation count) at the
// surface-local hit (x, y, z).  With kPartials the registers carry the
// forward-mode partials beside each value.
template <bool kPartials>
RTT_FZ_HD FuzzyDual fuzzy_eval(const int32_t* prog, float x, float y, float z) {
  float v[kFuzzyMaxRegs];
  float g[kPartials ? kFuzzyMaxRegs : 1][3];
  v[0] = x;
  v[1] = y;
  v[2] = z;
  if constexpr (kPartials) {
    for (int r = 0; r < 3; ++r)
      for (int j = 0; j < 3; ++j) g[r][j] = r == j ? 1.0f : 0.0f;
  }
  const int n_ops = prog[0];
  const int32_t* op = prog + 2;
#pragma unroll 1
  for (int k = 0; k < n_ops; ++k, op += 2) {
    const int32_t w0 = op[0], w1 = op[1];
    const int code = w0 & 0xff;
    const int dst = (w0 >> 8) & 0xff, a = (w0 >> 16) & 0xff, b = (w0 >> 24) & 0xff;
    const float va = v[a], vb = v[b];
    float r;
    float ga[3] = {0.0f, 0.0f, 0.0f}, gb[3] = {0.0f, 0.0f, 0.0f}, gr[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kPartials) {
      for (int j = 0; j < 3; ++j) {
        ga[j] = g[a][j];
        gb[j] = g[b][j];
      }
    }
    switch (code) {
      case kFzConst:
        r = fz_bits(w1);
        break;
      case kFzAdd:
        r = fz_add(va, vb);
        for (int j = 0; j < 3; ++j) gr[j] = fz_add(ga[j], gb[j]);
        break;
      case kFzSub:
        r = fz_sub(va, vb);
        for (int j = 0; j < 3; ++j) gr[j] = fz_sub(ga[j], gb[j]);
        break;
      case kFzMul:
        r = fz_mul(va, vb);
        for (int j = 0; j < 3; ++j) gr[j] = fz_add(fz_mul(ga[j], vb), fz_mul(va, gb[j]));
        break;
      case kFzDiv:
        r = fz_div(va, vb);
        for (int j = 0; j < 3; ++j) gr[j] = fz_div(fz_sub(ga[j], fz_mul(r, gb[j])), vb);
        break;
      case kFzNeg:
        r = -va;
        for (int j = 0; j < 3; ++j) gr[j] = -ga[j];
        break;
      case kFzAbs:
        r = fabsf(va);
        for (int j = 0; j < 3; ++j) gr[j] = va > 0.0f ? ga[j] : (va < 0.0f ? -ga[j] : 0.0f);
        break;
      case kFzExp:
        r = expf(va);
        for (int j = 0; j < 3; ++j) gr[j] = fz_mul(r, ga[j]);
        break;
      case kFzSqrt:
        r = fz_sqrt(va);
        for (int j = 0; j < 3; ++j) gr[j] = fz_div(ga[j], fz_add(r, r));
        break;
      case kFzLt:
        r = va < vb ? 1.0f : 0.0f;
        break;
      case kFzLe:
        r = va <= vb ? 1.0f : 0.0f;
        break;
      case kFzGt:
        r = va > vb ? 1.0f : 0.0f;
        break;
      case kFzGe:
        r = va >= vb ? 1.0f : 0.0f;
        break;
      case kFzAnd:
        r = va != 0.0f && vb != 0.0f ? 1.0f : 0.0f;
        break;
      case kFzOr:
        r = va != 0.0f || vb != 0.0f ? 1.0f : 0.0f;
        break;
      case kFzNot:
        r = va == 0.0f ? 1.0f : 0.0f;
        break;
      case kFzWhere: {
        const bool c = va != 0.0f;
        r = c ? vb : v[w1];
        if constexpr (kPartials) {
          for (int j = 0; j < 3; ++j) gr[j] = c ? gb[j] : g[w1][j];
        }
        break;
      }
      default:  // kFzCast: a mask's 0 or 1
        r = va;
        break;
    }
    v[dst] = r;
    if constexpr (kPartials) {
      for (int j = 0; j < 3; ++j) g[dst][j] = gr[j];
    }
  }
  const int out = prog[1];
  if constexpr (kPartials) return {v[out], g[out][0], g[out][1], g[out][2]};
  return {v[out], 0.0f, 0.0f, 0.0f};
}

// The factor of table row `row` at the hit (1 for a row without a
// program), from the buffer `fz` (its header word per row).
RTT_FZ_HD float fuzzy_factor(const int32_t* fz, int row, float x, float y, float z) {
  const int o = fz[row];
  return o < 0 ? 1.0f : fuzzy_eval<false>(fz + o, x, y, z).w;
}

}  // namespace rtt
