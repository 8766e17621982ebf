// KV-cache row quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kv_rowquant_2d` (src/repro/kernels/
// decode_attn.py, `_kv_rowquant_kernel`) and the nibble packing its JAX
// wrapper did afterwards (`ops.kv_quant_rows`).  Per row of head_dim
// values: amax, the bf16-rounded scale, then int8 codes, or luq_fp4 codes
// packed two per byte (even index = low nibble).
//
// Bound on this card: bytes (read 4 B per element, write 1 or 0.5 B plus
// 2 B per row; a handful of float operations per element).
//
// Design: one warp per row.  The row is read once for the amax (a warp
// shuffle reduction) and once more to encode; the second read hits L1/L2.
// Lanes own neighbouring elements, so both reads are coalesced, and the
// codes are written with no intermediate in device memory (the TPU path
// wrote unpacked codes and packed them in a second XLA pass).
//
// Numerics: the scale is __float2bfloat16_rn(amax / 127) (IEEE division,
// round to nearest even) and the encoders divide by the rounded scale; the
// int8 code is rintf (half to even, as jnp.round); the fp4 level is
// floor(log2f(max(y, 2^-7))).  These are the float32 operations of the
// plain version, one for one, so codes and scales agree bitwise.  Must not
// be built with --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_amax(const float* row, int hd, int lane) {
  float amax = 0.f;
  for (int i = lane; i < hd; i += 32) amax = fmaxf(amax, fabsf(row[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  return amax;
}

__device__ __forceinline__ unsigned fp4_code(float x, float safe) {
  const float y = fabsf(x) / safe;
  const float tiny = 0.0078125f;  // 2^-7
  const float k = fminf(fmaxf(floorf(log2f(fmaxf(y, tiny))), -6.f), 0.f);
  const float low = exp2f(k);
  const float high = fminf(2.f * low, 1.f);
  float m = k + 7.f + (((y - low) >= (high - y)) ? 1.f : 0.f);
  m = (y < tiny) ? 0.f : fminf(fmaxf(m, 1.f), 7.f);
  const float code = m + 8.f * ((x < 0.f && m > 0.f) ? 1.f : 0.f);
  return (unsigned)code;
}

__global__ void __launch_bounds__(kThreads)
kv_quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                     __nv_bfloat16* __restrict__ scales, long rows, int hd) {
  const long r = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps leave together
  const float* row = x + r * hd;
  const float amax = warp_amax(row, hd, lane);
  const __nv_bfloat16 sb = __float2bfloat16_rn(amax / 127.f);
  const float scale = __bfloat162float(sb);
  const float safe = scale > 0.f ? scale : 1.f;
  int8_t* out = codes + r * hd;
  for (int i = lane; i < hd; i += 32) {
    const float c = fminf(fmaxf(rintf(row[i] / safe), -127.f), 127.f);
    out[i] = (int8_t)c;
  }
  if (lane == 0) scales[r] = sb;
}

__global__ void __launch_bounds__(kThreads)
kv_quant_fp4_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                    __nv_bfloat16* __restrict__ scales, long rows, int hd) {
  const long r = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* row = x + r * hd;
  const float amax = warp_amax(row, hd, lane);
  const __nv_bfloat16 sb = __float2bfloat16_rn(amax);
  const float scale = __bfloat162float(sb);
  const float safe = scale > 0.f ? scale : 1.f;
  uint8_t* out = packed + r * (hd / 2);
  for (int j = lane; j < hd / 2; j += 32) {
    const unsigned lo = fp4_code(row[2 * j], safe);
    const unsigned hi = fp4_code(row[2 * j + 1], safe);
    out[j] = (uint8_t)(lo | (hi << 4));
  }
  if (lane == 0) scales[r] = sb;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (rows, hd) float32; codes: (rows, hd) int8 (fmt 0) or (rows, hd / 2)
// uint8 (fmt 1, hd even); scales: (rows,) bfloat16.  Returns the
// cudaError_t of the launch.
extern "C" int repro_kv_quant_rows(const void* x, void* codes, void* scales,
                                   long rows, int hd, int fmt, void* stream) {
  if (rows < 1 || hd < 1 || (fmt == 1 && hd % 2) || fmt < 0 || fmt > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  if (fmt == 0) {
    kv_quant_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)codes, (__nv_bfloat16*)scales, rows, hd);
  } else {
    kv_quant_fp4_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (uint8_t*)codes, (__nv_bfloat16*)scales, rows, hd);
  }
  return (int)cudaGetLastError();
}
