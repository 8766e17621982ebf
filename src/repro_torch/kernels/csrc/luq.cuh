// LUQ-FP4 stochastic rounding of one float32 element, shared by every
// kernel that quantizes (luq_quant.cu, luq_matmul.cu) so their bits cannot
// drift apart: the counterpart of `luq_stochastic_round` in the JAX
// package (src/repro/kernels/luq_quant.py), which plays the same role for
// the TPU kernels.
//
// Grid {0} U {alpha * 2^-k, k = 0..6}, stochastic rounding between
// adjacent levels against the uniform `u`, stochastic underflow below
// 2^-6.  The float32 operations are those of the plain version
// (repro_torch.quant.formats.luq_fp4): the level is
// floor(log2f(max(y, 2^-6))), divisions are IEEE and comparisons strict
// (u < p), so the result agrees bitwise with it on the card.  Sources that
// include this header must not be built with --use_fast_math.
#pragma once

namespace repro_luq {

constexpr int kLevels = 7;                   // LUQ_EXP_LEVELS

__device__ __forceinline__ float luq_round(float x, float u, float alpha) {
  const float safe_alpha = alpha > 0.f ? alpha : 1.f;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float y = fabsf(x) / safe_alpha;
  const float min_level = 0.015625f;  // 2^-(kLevels - 1)
  const float under = (u < y / min_level) ? min_level : 0.f;
  const float ylog = log2f(fmaxf(y, min_level));
  const float k = fminf(fmaxf(floorf(ylog), -(float)(kLevels - 1)), 0.f);
  const float low = exp2f(k);
  const float high = fminf(exp2f(k + 1.f), 1.f);
  const float p_up = (y - low) / fmaxf(high - low, 1e-30f);
  const float rounded = (u < p_up) ? high : low;
  const float q = (y < min_level) ? under : rounded;
  return alpha > 0.f ? sign * q * safe_alpha : 0.f;
}

}  // namespace repro_luq
