// LUQ-FP4 stochastic quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `luq_quant_2d` (src/repro/kernels/
// luq_quant.py, `_luq_kernel`).  out[r, n] = luq_round(x[r, n], u, alpha[r])
// with u = u[n] when the uniforms are shared by every row (the per-example
// rows of a microbatch under vmap, which the JAX package quantizes with one
// unbatched key) or u[r, n] when each row has its own.  alpha[r] = max|x[r]|
// is computed by the caller with a torch reduction, as the JAX wrapper
// computes it outside the Pallas kernel (`ops.luq_quantize`).
//
// Bound on this card: bytes.  Per element it reads x and u and writes the
// result (12 bytes when u is per row, 8 plus a share of u when shared),
// against ~24 float32 operations: at 3.35 TB/s and 67 TFLOP/s the bytes
// take about ten times as long as the arithmetic.
//
// Design: elementwise, one pass.  The TPU kernel tiles a padded 2-d view
// into (256, 256) VMEM blocks; here block (bx, by) owns kItems * kThreads
// consecutive columns of row by (rows beyond gridDim.y loop), each thread
// kItems of them strided by the block width so every load is coalesced,
// and as float4 when N % 4 == 0 and the pointers are 16-byte aligned (the
// wrapper checks and passes `vec`).  The shared u is re-read by every row
// and stays in L2.  The rounding is `luq_round` of luq.cuh, the same
// function luq_matmul.cu uses, so the codes agree bitwise with the plain
// version (this file must not be built with --use_fast_math).
//
// Code output (`codes` = 1): instead of the float32 value the kernel writes
// the bf16 code Q(x) / alpha = sign * 2^-k (`luq_code` of luq.cuh, the same
// rounding), which bf16 holds exactly, at half the bytes.  The fused ghost
// norm (ghost_norm.cu) quantizes its operands this way and multiplies the
// codes on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "luq.cuh"

namespace {

using repro_luq::luq_code;
using repro_luq::luq_round;

// One element's output: the float32 value, or its bf16 code.
template <bool kCodes>
struct Out;
template <>
struct Out<false> {
  using T = float;
  static __device__ __forceinline__ float make(float x, float u, float a) {
    return luq_round(x, u, a);
  }
};
template <>
struct Out<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ __nv_bfloat16 make(float x, float u,
                                                       float a) {
    return __float2bfloat16_rn(luq_code(x, u, a));
  }
};

constexpr int kThreads = 256;
constexpr int kItems = 4;                    // units per thread
constexpr int kMaxGridY = 65535;

template <bool kVec, bool kCodes>
__global__ void __launch_bounds__(kThreads)
luq_quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
                 const float* __restrict__ alpha,
                 typename Out<kCodes>::T* __restrict__ out, int rows,
                 long long n, int u_per_row) {
  using O = Out<kCodes>;
  using T = typename O::T;
  // a "unit" is a float4 in the vector kernel, a float otherwise
  const long long units = kVec ? n / 4 : n;
  const long long base =
      (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float a = alpha[r];
    const long long row_off = (long long)r * n;
    const float* xr = x + row_off;
    const float* ur = u + (u_per_row ? row_off : 0);
    T* outr = out + row_off;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = base + (long long)i * kThreads;
      if (j >= units) break;
      if (kVec) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xr) + j);
        const float4 uv = __ldg(reinterpret_cast<const float4*>(ur) + j);
        struct alignas(4 * sizeof(T)) Four { T v[4]; } q;
        q.v[0] = O::make(xv.x, uv.x, a);
        q.v[1] = O::make(xv.y, uv.y, a);
        q.v[2] = O::make(xv.z, uv.z, a);
        q.v[3] = O::make(xv.w, uv.w, a);
        reinterpret_cast<Four*>(outr)[j] = q;
      } else {
        outr[j] = O::make(__ldg(xr + j), __ldg(ur + j), a);
      }
    }
  }
}

template <bool kCodes>
void launch(dim3 grid, cudaStream_t s, const void* x, const void* u,
            const void* alpha, void* out, int rows, long long n,
            int u_per_row, int vec) {
  using T = typename Out<kCodes>::T;
  if (vec) {
    luq_quant_kernel<true, kCodes><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)u, (const float*)alpha, (T*)out, rows,
        n, u_per_row);
  } else {
    luq_quant_kernel<false, kCodes><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)u, (const float*)alpha, (T*)out, rows,
        n, u_per_row);
  }
}

}  // namespace

// x, out: (rows, n); u: (n,) shared by the rows (u_per_row = 0) or
// (rows, n) (u_per_row = 1); alpha: (rows,).  x, u, alpha float32; out
// float32 values (codes = 0) or bf16 codes (codes = 1).  All contiguous, on
// the device.  vec = 1 takes float4 loads (and 4-wide stores): n % 4 == 0
// and every pointer 16-byte aligned (out 8-byte aligned for codes).
// Returns the cudaError_t of the launch.
extern "C" int repro_luq_quant(const void* x, const void* u, const void* alpha,
                               void* out, int rows, long long n,
                               int u_per_row, int vec, int codes,
                               void* stream) {
  if (rows < 1 || n < 1 || (vec && n % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long units = vec ? n / 4 : n;
  const long long per_block = (long long)kThreads * kItems;
  const long long gx = (units + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, rows < kMaxGridY ? rows : kMaxGridY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (codes) {
    launch<true>(grid, s, x, u, alpha, out, rows, n, u_per_row, vec);
  } else {
    launch<false>(grid, s, x, u, alpha, out, rows, n, u_per_row, vec);
  }
  return (int)cudaGetLastError();
}
