// LUQ-FP4 stochastic rounding of one float32 element, shared by every
// kernel that quantizes (luq_quant.cu, luq_matmul.cu) so their bits cannot
// drift apart: the counterpart of `luq_stochastic_round` in the JAX
// package (src/repro/kernels/luq_quant.py), which plays the same role for
// the TPU kernels.
//
// Grid {0} U {alpha * 2^-k, k = 0..6}, stochastic rounding between
// adjacent levels against the uniform `u`, stochastic underflow below
// 2^-6.  The result is that of the plain version's float32 operations
// (repro_torch.quant.formats.luq_fp4) bit for bit on the card: the level
// is floor(log2f(max(y, 2^-6))) (taken from the exponent bits where that
// is provably the same, see luq_prep), divisions are IEEE or exact
// products by powers of two, comparisons strict (u < p).  Sources that
// include this header must not be built with --use_fast_math.
//
// The rounding is split in two, as formats.luq_fp4_prep / luq_fp4_level
// are in the plain version: `luq_prep` is the part that does not depend on
// the uniform (y, sign, the level, low / high, p_up, the underflow
// threshold), `luq_level` the part that does (two compares and selects).
// A kernel that rounds one element against several uniforms (luq_matmul's
// per-row draws) prepares it once.  `luq_round` and `luq_code` are their
// compositions, so every caller rounds with the same operations.
#pragma once

#include <stdint.h>

namespace repro_luq {

constexpr int kLevels = 7;                   // LUQ_EXP_LEVELS
constexpr float kMinLevel = 0.015625f;       // 2^-(kLevels - 1)

struct Prep {
  float thr;      // y / 2^-6: u below it underflows to 2^-6, else to 0
  float p_up;     // probability of rounding up to `high`
  float low, high;
  float sign;     // -1, 0 or 1
  float scale;    // sign * alpha, 0 when alpha <= 0
  bool small;     // y < 2^-6: stochastic underflow
};

__device__ __forceinline__ Prep luq_prep(float x, float alpha) {
  Prep p;
  const float safe_alpha = alpha > 0.f ? alpha : 1.f;
  p.sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float y = fabsf(x) / safe_alpha;
  p.thr = y * 64.f;                          // y / 2^-6, exact
  // The level k = clamp(floor(log2f(max(y, 2^-6))), -6, 0).  For v =
  // max(y, 2^-6) >= 2^-6 (normal, positive) floor(log2f(v)) is v's binary
  // exponent, except within 2^-15 (relative) below a power of two, where
  // log2f may round up to the next integer: only there is log2f called,
  // so the level is log2f's bit for bit at a fraction of its cost (held
  // over every finite float32 by tests/test_torch_cuda_kernels.py).
  const float v = fmaxf(y, kMinLevel);
  const int bits = __float_as_int(v);
  int e;
  if ((bits & 0x7fffff) >= 0x7fff00) {
    e = (int)floorf(log2f(v));
  } else {
    e = (bits >> 23) - 127;
  }
  const int k = min(max(e, -(kLevels - 1)), 0);
  // exp2f(k), exp2f(k + 1) of the integer k in [-6, 0]: exact powers of two
  p.low = __int_as_float((127 + k) << 23);
  p.high = fminf(__int_as_float((128 + k) << 23), 1.f);
  // (y - low) / max(high - low, 1e-30): for k < 0, high - low = 2^k and the
  // division is the exact product by 2^-k; for k = 0, low = high = 1 and
  // luq_level picks 1 whatever p_up is
  p.p_up = k < 0 ? (y - p.low) * __int_as_float((127 - k) << 23) : 0.f;
  p.small = y < kMinLevel;
  p.scale = alpha > 0.f ? p.sign * safe_alpha : 0.f;
  return p;
}

// The unsigned level q in {0, 2^-6, ..., 1} that `u` picks.
__device__ __forceinline__ float luq_level(const Prep& p, float u) {
  const float under = (u < p.thr) ? kMinLevel : 0.f;
  const float rounded = (u < p.p_up) ? p.high : p.low;
  return p.small ? under : rounded;
}

// A uniform drawn as u = m 2^-24 (m = a Philox word >> 8, philox.cuh)
// compares with a probability p as the integer m with ceil(p 2^24):
// u < p  <=>  m < ceil(p 2^24), clamped to [0, 2^24] (p 2^24 is exact, and
// NaN gives 0).  So an element rounded against many drawn words (one per
// row of luq_matmul) is prepared once into a `Pick`: Q = m < t ? hi : lo,
// with t the threshold of the one compare luq_level makes for it (p_up, or
// the underflow threshold when y < 2^-6) and hi / lo its two outcomes
// already times sign * alpha (a power of two or 0 times sign * alpha: the
// same single rounding as luq_value's).  No uniform is converted to float.
struct Pick {
  uint32_t t;
  float hi, lo;
};

__device__ __forceinline__ uint32_t threshold24(float p) {
  return __float2uint_ru(fminf(fmaxf(p * 16777216.f, 0.f), 16777216.f));
}

__device__ __forceinline__ Pick luq_pick(const Prep& p) {
  Pick k;
  k.t = threshold24(p.small ? p.thr : p.p_up);
  k.hi = (p.small ? kMinLevel : p.high) * p.scale;
  k.lo = (p.small ? 0.f : p.low) * p.scale;
  return k;
}

// luq_value(p, m * 2^-24), bit for bit.
__device__ __forceinline__ float luq_value_m(const Pick& k, uint32_t m) {
  return m < k.t ? k.hi : k.lo;
}

// Q(x) = sign * q * alpha.  q is a power of two or 0 and sign * alpha is
// exact, so q * (sign * alpha) is the same single rounding as the plain
// version's (sign * q) * alpha, signed zeros included.
__device__ __forceinline__ float luq_value(const Prep& p, float u) {
  return luq_level(p, u) * p.scale;
}

__device__ __forceinline__ float luq_round(float x, float u, float alpha) {
  return luq_value(luq_prep(x, alpha), u);
}

// The code Q(x) / alpha = sign * 2^-k (or 0): exact in bf16, and code *
// alpha is luq_round's value bit for bit.  0 when alpha <= 0.
__device__ __forceinline__ float luq_code(float x, float u, float alpha) {
  const Prep p = luq_prep(x, alpha);
  return alpha > 0.f ? p.sign * luq_level(p, u) : 0.f;
}

}  // namespace repro_luq
