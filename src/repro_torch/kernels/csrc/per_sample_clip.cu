// Fused per-example clip and batch sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `per_sample_clip` (src/repro/kernels/
// per_sample_clip.py, `_clip_kernel`).  For (B, D) per-example gradient
// rows g:
//
//     norms[b] = ||g[b]||_2
//     out[d]   = sum_b min(1, C / max(norms[b], 1e-12)) * g[b, d]
//
// Bound on this card: bytes.  The function must read the B x D float32
// matrix once (2.87 GB for ResNet-18's 11.19 M parameters at B = 64) and
// does two float32 operations per element; at 3.35 TB/s that is ~0.86 ms.
//
// Design: deterministic, no atomics, so a DP step is reproducible run to
// run (DP auditing replays steps).  The TPU kernel walks the column blocks
// twice in one sequential grid, carrying the (B, 1) square sums in VMEM.
// Blocks on Hopper run in no order, so that carry becomes three launches
// on one stream:
//
//   1. row_sumsq: block (p, b) sums the squares of column chunk p of row b
//      (a fixed per-thread stride, then a warp-shuffle tree and the warps
//      in order) into partial[b, p];
//   2. row_scale: one thread per row adds its P partials in order and
//      writes norms[b] and the clip factor scale[b];
//   3. column_sum: one thread per column walks b = 0..B-1 in order,
//      acc = fma(scale[b], g[b, d], acc), with the B factors in shared
//      memory, and writes out[d].
//
// The matrix is read twice (steps 1 and 3), as the TPU kernel's two phases
// read it; the second read is what keeps the kernel above its bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;               // column chunks per row (P)
constexpr long long kMinChunk = 4096;        // columns per chunk, at least
constexpr int kMaxRows = 8192;               // B: scale[] in shared memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
row_sumsq_kernel(const float* __restrict__ g, float* __restrict__ partial,
                 long long D, int P) {
  __shared__ float warp_part[kThreads / 32];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const long long chunk = (D + P - 1) / P;
  const long long start = (long long)p * chunk;
  const long long stop = start + chunk < D ? start + chunk : D;
  const float* row = g + (long long)b * D;
  float acc = 0.f;
  long long j = start + threadIdx.x;
  for (; j + 3 * kThreads < stop; j += 4 * kThreads) {
    const float v0 = __ldg(row + j);
    const float v1 = __ldg(row + j + kThreads);
    const float v2 = __ldg(row + j + 2 * kThreads);
    const float v3 = __ldg(row + j + 3 * kThreads);
    acc = fmaf(v0, v0, acc);
    acc = fmaf(v1, v1, acc);
    acc = fmaf(v2, v2, acc);
    acc = fmaf(v3, v3, acc);
  }
  for (; j < stop; j += kThreads) {
    const float v = __ldg(row + j);
    acc = fmaf(v, v, acc);
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
    partial[(long long)b * P + p] = s;
  }
}

__global__ void row_scale_kernel(const float* __restrict__ partial,
                                 float* __restrict__ norms,
                                 float* __restrict__ scale, int B, int P,
                                 float clip_norm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)b * P + p];
  const float n = sqrtf(s);
  norms[b] = n;
  scale[b] = fminf(1.f, clip_norm / fmaxf(n, 1e-12f));
}

__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ g, const float* __restrict__ scale,
                  float* __restrict__ out, int B, long long D) {
  extern __shared__ float s_scale[];
  for (int b = threadIdx.x; b < B; b += kThreads) s_scale[b] = scale[b];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long d = (long long)blockIdx.x * kThreads + threadIdx.x; d < D;
       d += stride) {
    float acc = 0.f;
    int b = 0;
    for (; b + 8 <= B; b += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __ldg(g + (long long)(b + i) * D + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(s_scale[b + i], v[i], acc);
    }
    for (; b < B; ++b) {
      acc = fmaf(s_scale[b], __ldg(g + (long long)b * D + d), acc);
    }
    out[d] = acc;
  }
}

}  // namespace

// Number of column chunks P the first step splits each row into; the
// caller allocates `partial` as (B, P) float32.
extern "C" int repro_per_sample_clip_chunks(long long D) {
  long long p = D / kMinChunk;
  if (p < 1) p = 1;
  if (p > kMaxChunks) p = kMaxChunks;
  return (int)p;
}

// g: (B, D); out: (D,); norms, scale: (B,); partial: (B, P) scratch with
// P = repro_per_sample_clip_chunks(D).  All float32, contiguous, on the
// device.  Returns the cudaError_t of the launches.
extern "C" int repro_per_sample_clip(const void* g, void* out, void* norms,
                                     void* partial, void* scale, int B,
                                     long long D, float clip_norm,
                                     void* stream) {
  if (B < 1 || B > kMaxRows || D < 1) return (int)cudaErrorInvalidValue;
  const int P = repro_per_sample_clip_chunks(D);
  const cudaStream_t s = (cudaStream_t)stream;
  row_sumsq_kernel<<<dim3(P, B), kThreads, 0, s>>>(
      (const float*)g, (float*)partial, D, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_scale_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      (const float*)partial, (float*)norms, (float*)scale, B, P, clip_norm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long blocks = (D + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond that
  column_sum_kernel<<<(unsigned)blocks, kThreads, B * sizeof(float), s>>>(
      (const float*)g, (const float*)scale, (float*)out, B, D);
  return (int)cudaGetLastError();
}
