// LUQ-FP4 quantize-both-operands matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quant_matmul` (src/repro/kernels/
// quant_matmul.py, `_qmm_kernel`).  out[r, n] = sum_k Q(a)[r, k] * Q(b)[k, n],
// where Q is LUQ-FP4 stochastic rounding against explicit uniforms (`ua`,
// `ub`) and per-tensor scales (`alpha_a` per row, `alpha_b` shared).
//
// Bound on this card: bytes.  On the serving path M is 1 row per slot, so
// the product is a GEMV over the (K, N) head: each call reads b once and
// the uniforms ub once per uniform group (f32 each), and does only ~2
// FLOPs plus one LUQ rounding per element read.
//
// Design: the TPU kernel walks K as a sequential grid axis with a VMEM
// accumulator.  Here a block owns kCols output columns and loops over all
// of K itself, split across kSplits warps-pairs; the partial sums are
// added in shared memory in a fixed order, so results are deterministic
// (no atomics).  Neighbouring threads own neighbouring columns, so every
// load of b and ub is a coalesced 128-byte row segment.  The quantized a
// rows are staged in shared memory one K chunk at a time and read as
// broadcasts.  b and ub are quantized in registers; nothing quantized is
// written back to device memory.
//
// Uniform layout: `ub` is (K, N) when all rows share one draw (`per_row_ub`
// = 0: one quantization of b for the whole matrix), or (rows, K, N) when
// each row has its own draw (`per_row_ub` = 1: the per-slot logits head,
// where every slot quantizes the head with its own position-derived
// stream).
//
// Numerics: the LUQ rounding is `luq_round` of luq.cuh (shared with
// luq_quant.cu): exactly the float32 operations of the plain version, so
// Q(a) and Q(b) agree bitwise with it on the card; only the summation
// order of the product differs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "luq.cuh"

namespace {

using repro_luq::luq_round;

constexpr int kThreads = 256;
constexpr int kCols = 64;                    // output columns per block
constexpr int kSplits = kThreads / kCols;    // K slices per block
constexpr int kMaxRows = 8;                  // rows per launch
constexpr int kChunk = 512;                  // K staged per shared-memory step

__global__ void __launch_bounds__(kThreads)
luq_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ ua, const float* __restrict__ ub,
                  const float* __restrict__ alpha_a,
                  const float* __restrict__ alpha_b_ptr,
                  float* __restrict__ out, int rows, int K, int N,
                  int per_row_ub) {
  __shared__ float aq[kMaxRows][kChunk];
  __shared__ float partial[kSplits][kMaxRows][kCols];

  const int col = threadIdx.x % kCols;
  const int split = threadIdx.x / kCols;
  const int n = blockIdx.x * kCols + col;
  const bool valid_col = n < N;
  const float alpha_b = *alpha_b_ptr;
  const size_t plane = (size_t)K * N;

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    for (int i = threadIdx.x; i < rows * kc; i += kThreads) {
      const int r = i / kc;
      const int kk = i - r * kc;
      const size_t idx = (size_t)r * K + k0 + kk;
      aq[r][kk] = luq_round(a[idx], ua[idx], alpha_a[r]);
    }
    __syncthreads();
    if (valid_col) {
      for (int kk = split; kk < kc; kk += kSplits) {
        const size_t bidx = (size_t)(k0 + kk) * N + n;
        const float bv = __ldg(b + bidx);
        if (per_row_ub) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < rows) {
              const float bq =
                  luq_round(bv, __ldg(ub + r * plane + bidx), alpha_b);
              acc[r] = fmaf(aq[r][kk], bq, acc[r]);
            }
          }
        } else {
          const float bq = luq_round(bv, __ldg(ub + bidx), alpha_b);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < rows) acc[r] = fmaf(aq[r][kk], bq, acc[r]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) partial[split][r][col] = acc[r];
  }
  __syncthreads();
  if (split == 0 && valid_col) {
    for (int r = 0; r < rows; ++r) {
      float s = partial[0][r][col];
#pragma unroll
      for (int j = 1; j < kSplits; ++j) s += partial[j][r][col];
      out[(size_t)r * N + n] = s;
    }
  }
}

}  // namespace

extern "C" int repro_luq_matmul_max_rows() { return kMaxRows; }

// a, ua: (rows, K); b: (K, N); ub: (K, N) or (rows, K, N); alpha_a: (rows,);
// alpha_b: one float; out: (rows, N).  All float32, contiguous, on the device.
// Returns the cudaError_t of the launch.
extern "C" int repro_luq_matmul(const void* a, const void* b, const void* ua,
                                const void* ub, const void* alpha_a,
                                const void* alpha_b, void* out, int rows,
                                int K, int N, int per_row_ub, void* stream) {
  if (rows < 1 || rows > kMaxRows || K < 1 || N < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kCols - 1) / kCols);
  luq_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)ua, (const float*)ub,
      (const float*)alpha_a, (const float*)alpha_b, (float*)out, rows, K, N,
      per_row_ub);
  return (int)cudaGetLastError();
}
