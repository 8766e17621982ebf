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
#include <cuda_runtime.h>
#include <stdint.h>

#include "luq.cuh"

namespace {

using repro_luq::luq_round;

constexpr int kThreads = 256;
constexpr int kItems = 4;                    // units per thread
constexpr int kMaxGridY = 65535;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
luq_quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
                 const float* __restrict__ alpha, float* __restrict__ out,
                 int rows, long long n, int u_per_row) {
  // a "unit" is a float4 in the vector kernel, a float otherwise
  const long long units = kVec ? n / 4 : n;
  const long long base =
      (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float a = alpha[r];
    const long long row_off = (long long)r * n;
    const float* xr = x + row_off;
    const float* ur = u + (u_per_row ? row_off : 0);
    float* outr = out + row_off;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = base + (long long)i * kThreads;
      if (j >= units) break;
      if (kVec) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xr) + j);
        const float4 uv = __ldg(reinterpret_cast<const float4*>(ur) + j);
        float4 q;
        q.x = luq_round(xv.x, uv.x, a);
        q.y = luq_round(xv.y, uv.y, a);
        q.z = luq_round(xv.z, uv.z, a);
        q.w = luq_round(xv.w, uv.w, a);
        reinterpret_cast<float4*>(outr)[j] = q;
      } else {
        outr[j] = luq_round(__ldg(xr + j), __ldg(ur + j), a);
      }
    }
  }
}

}  // namespace

// x, out: (rows, n); u: (n,) shared by the rows (u_per_row = 0) or
// (rows, n) (u_per_row = 1); alpha: (rows,).  All float32, contiguous, on
// the device.  vec = 1 takes float4 loads and stores: n % 4 == 0 and every
// pointer 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int repro_luq_quant(const void* x, const void* u, const void* alpha,
                               void* out, int rows, long long n,
                               int u_per_row, int vec, void* stream) {
  if (rows < 1 || n < 1 || (vec && n % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long units = vec ? n / 4 : n;
  const long long per_block = (long long)kThreads * kItems;
  const long long gx = (units + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, rows < kMaxGridY ? rows : kMaxGridY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    luq_quant_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)u, (const float*)alpha, (float*)out,
        rows, n, u_per_row);
  } else {
    luq_quant_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)u, (const float*)alpha, (float*)out,
        rows, n, u_per_row);
  }
  return (int)cudaGetLastError();
}
