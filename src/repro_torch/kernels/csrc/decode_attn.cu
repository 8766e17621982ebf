// Fused one-token GQA attention over the quantized slot-pool KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attn_call` (src/repro/kernels/
// decode_attn.py, `_decode_attn_kernel`).  For slot b and kv head h the g
// query rows of that head attend to cache rows s <= pos[b]: decode the
// codes, fold the K scale into the score (score * (k_scale * scale)),
// softmax, fold the V scale into the probability, and sum the value rows.
//
// Bound on this card: bytes.  A decode tick reads every live cache row of
// every slot once (codes plus a bf16 scale for K and V) and does ~4 g
// FLOPs per stored element.
//
// Design: one block per (slot, kv head), so the g query rows that share a
// kv head share every K/V read (the TPU kernel's grid step).  Each warp
// takes every kWarps-th cache row; a row is read by the whole warp at once
// (lane i decodes elements 4i..4i+3, one 4-byte int8 or 2-byte fp4 load),
// so loads are coalesced.  The dot products are warp-shuffle reductions.
// A warp keeps an online softmax (running max, sum, and g output rows in
// registers), and the warps are merged through shared memory in a fixed
// order at the end, so results are deterministic.  Only rows s <= pos[b]
// are read: masked rows have probability exactly zero in the reference, so
// skipping them changes nothing and saves their bytes.  The TPU padding of
// g to 8 and head_dim to 128 is gone.
//
// Limits: head_dim a multiple of 4 and at most 128; g at most 8 (yi-6b:
// g = 8, head_dim = 128).  The wrapper checks them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kMaxHd = 128;
constexpr unsigned kFull = 0xffffffffu;

// 2^(m - 7) for m in 1..7 is exact: biased exponent m + 120.
__device__ __forceinline__ float fp4_unit(unsigned c) {
  const unsigned m = c & 7u;
  const float mag = m ? __int_as_float((int)((m + 120u) << 23)) : 0.f;
  return (c & 8u) ? -mag : mag;
}

// Unscaled values of elements e0..e0+3 of one stored row.
template <bool kFp4>
__device__ __forceinline__ void load_unit(const uint8_t* row, int e0,
                                          float v[4]) {
  if (kFp4) {
    const uint16_t two = *reinterpret_cast<const uint16_t*>(row + e0 / 2);
    v[0] = fp4_unit(two & 0xfu);
    v[1] = fp4_unit((two >> 4) & 0xfu);
    v[2] = fp4_unit((two >> 8) & 0xfu);
    v[3] = fp4_unit((two >> 12) & 0xfu);
  } else {
    const char4 c = *reinterpret_cast<const char4*>(row + e0);
    v[0] = (float)c.x;
    v[1] = (float)c.y;
    v[2] = (float)c.z;
    v[3] = (float)c.w;
  }
}

template <bool kFp4>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q,
                   const uint8_t* __restrict__ k_codes,
                   const uint8_t* __restrict__ v_codes,
                   const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale,
                   const int32_t* __restrict__ pos, float* __restrict__ out,
                   int n_kv, int g, int S, int hd, float scale) {
  __shared__ float s_max[kWarps][kMaxG];
  __shared__ float s_sum[kWarps][kMaxG];
  __shared__ float s_acc[kWarps][kMaxG][kMaxHd];

  const int bk = blockIdx.x;          // slot * n_kv + kv head
  const int slot = bk / n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int e0 = lane * 4;
  const bool lane_on = e0 < hd;
  const int row_bytes = kFp4 ? hd / 2 : hd;

  float qr[kMaxG][4];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j][e] = (j < g && lane_on)
          ? q[((size_t)bk * g + j) * hd + e0 + e] : 0.f;
    }
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][4];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  const int last = min(pos[slot], S - 1);
  const size_t row0 = (size_t)bk * S;
  for (int s = warp; s <= last; s += kWarps) {
    float kv[4] = {0.f, 0.f, 0.f, 0.f};
    float vv[4] = {0.f, 0.f, 0.f, 0.f};
    if (lane_on) {
      load_unit<kFp4>(k_codes + (row0 + s) * row_bytes, e0, kv);
      load_unit<kFp4>(v_codes + (row0 + s) * row_bytes, e0, vv);
    }
    const float ks = __bfloat162float(k_scale[row0 + s]) * scale;
    const float vs = __bfloat162float(v_scale[row0 + s]);
    float sc[kMaxG];
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      sc[j] = qr[j][0] * kv[0] + qr[j][1] * kv[1] + qr[j][2] * kv[2]
            + qr[j][3] * kv[3];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        sc[j] += __shfl_xor_sync(kFull, sc[j], off);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      if (j < g) {
        const float score = sc[j] * ks;
        const float m_new = fmaxf(m[j], score);
        const float corr = expf(m[j] - m_new);
        const float p = expf(score - m_new);
        l[j] = l[j] * corr + p;
        const float pv = p * vs;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * corr + pv * vv[e];
        m[j] = m_new;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      s_max[warp][j] = m[j];
      s_sum[warp][j] = l[j];
    }
  }
  if (lane_on) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[warp][j][e0 + e] = acc[j][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < g * hd; idx += kThreads) {
    const int j = idx / hd;
    const int e = idx - j * hd;
    float mf = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mf = fmaxf(mf, s_max[w][j]);
    float lf = 0.f, af = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no row has max -inf and contributes exp(-inf) = 0
      const float c = expf(s_max[w][j] - mf);
      lf += s_sum[w][j] * c;
      af += s_acc[w][j][e] * c;
    }
    out[((size_t)bk * g + j) * hd + e] = af / lf;
  }
}

}  // namespace

extern "C" int repro_decode_attn_limits(int* max_g, int* max_hd) {
  *max_g = kMaxG;
  *max_hd = kMaxHd;
  return 0;
}

// q: (B, n_kv, g, hd) float32; k_codes/v_codes: (B, n_kv, S, hd) int8
// (fmt 0) or (B, n_kv, S, hd / 2) packed uint8 (fmt 1); k_scale/v_scale:
// (B, n_kv, S) bfloat16; pos: (B,) int32 with 0 <= pos; out: (B, n_kv, g,
// hd) float32.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attn(const void* q, const void* k_codes,
                                 const void* v_codes, const void* k_scale,
                                 const void* v_scale, const void* pos,
                                 void* out, int B, int n_kv, int g, int S,
                                 int hd, float scale, int fmt, void* stream) {
  if (B < 1 || n_kv < 1 || g < 1 || g > kMaxG || S < 1 || hd < 4 ||
      hd > kMaxHd || hd % 4 || fmt < 0 || fmt > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B * n_kv);
  if (fmt == 0) {
    decode_attn_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const uint8_t*)k_codes, (const uint8_t*)v_codes,
        (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
        (const int32_t*)pos, (float*)out, n_kv, g, S, hd, scale);
  } else {
    decode_attn_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const uint8_t*)k_codes, (const uint8_t*)v_codes,
        (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
        (const int32_t*)pos, (float*)out, n_kv, g, S, hd, scale);
  }
  return (int)cudaGetLastError();
}
