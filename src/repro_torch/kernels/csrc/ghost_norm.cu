// Fused ghost norm for Hopper (sm_90a): LUQ-FP4 quantize + two Grams +
// their inner product, per example.
//
// Replaces the Pallas TPU kernel `ghost_norm_gram` (src/repro/kernels/
// ghost_norm.py, `_ghost_norm_kernel`).  For each example b, with x_b
// (T, Dx) the wgrad GEMM's input rows and g_b (T, Dg) its cotangent rows:
//
//     out[b] = sum_ij (Q(x_b) Q(x_b)^T)_ij * (Q(g_b) Q(g_b)^T)_ij
//            = || Q(x_b)^T Q(g_b) ||_F^2
//
// the per-example squared weight-gradient norm of ghost clipping (the
// Gram route of the mixed ghost norm).  Q is the quantize kernel of
// luq_quant.cu (`repro_luq_quant`, linked into the same library), so the
// quantized operands are bitwise its codes; the uniforms ux (T*Dx) and
// ug (T*Dg) are shared by the examples, alpha is per example.
//
// Design, simple first.  The TPU kernel quantizes each (T, 256) column
// block in VMEM and accumulates two whole (T, T) Grams there.  Two whole
// Grams do not fit shared memory here, so the Grams are tiled, and a tile
// grid reads every operand row 2 T / 64 times: quantizing on load would
// repeat the LUQ rounding (a log2, two exp2 and two IEEE divisions) that
// many times, which measured slower than the plain PyTorch version.  So
// four launches on one stream:
//
//   1-2. repro_luq_quant: Q(x), Q(g) once into scratch the wrapper
//      allocates (one row per example, shared uniforms);
//   3. gram_tiles: block (tj, ti, b) owns the 64 x 64 tile (ti, tj) of both
//      Grams of example b.  It streams 32 columns at a time of Q(x)'s tile
//      rows ti and tj through shared memory and accumulates the XX tile in
//      registers (4 x 4 a thread), then the same over Q(g) for GG, and
//      reduces the tile's sum XX o GG in a fixed order to one partial;
//   4. sum_partials: each example's partials added in a fixed order.
//
// Every tile is computed, both triangles: the Grams' symmetry would halve
// the multiply-adds, and tensor cores could take them (Q(v) / alpha is
// +-2^-k, exact in bf16); both are left for a later design.  No atomics:
// the same input gives the same bits on every run.  No limit on T (the
// TPU wrapper's T <= 512 cap existed for VMEM only).
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int repro_luq_quant(const void* x, const void* u,
                               const void* alpha, void* out, int rows,
                               long long n, int u_per_row, int vec,
                               void* stream);

namespace {

constexpr int kTile = 64;                    // Gram tile edge
constexpr int kK = 32;                       // columns per shared stage
constexpr int kThreads = 256;                // 16 x 16, 4 x 4 outputs each
constexpr int kStride = kTile + 4;           // padded row of a stage
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// acc[r][c] += sum_d q[i0 + 4 ty + r, d] q[j0 + 4 tx + c, d] over one
// example's (T, D) quantized matrix q, stage by stage through `si` / `sj`
// (kK rows of kStride floats: column d of the stage holds the 64 rows).
__device__ __forceinline__ void gram_tile(const float* __restrict__ q, int T,
                                          int D, int i0, int j0,
                                          float (*si)[kStride],
                                          float (*sj)[kStride],
                                          float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // loads: thread t takes column t % kK of rows t / kK + 8 r, r = 0..7, so
  // a warp reads 32 consecutive floats of one row
  const int lc = threadIdx.x % kK, lr = threadIdx.x / kK;
  for (int k0 = 0; k0 < D; k0 += kK) {
    const int col = k0 + lc;
#pragma unroll
    for (int r = 0; r < kTile / (kThreads / kK); ++r) {
      const int row = lr + r * (kThreads / kK);
      const int gi = i0 + row, gj = j0 + row;
      si[lc][row] = (col < D && gi < T) ? __ldg(q + (long long)gi * D + col)
                                        : 0.f;
      sj[lc][row] = (col < D && gj < T) ? __ldg(q + (long long)gj * D + col)
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&si[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sj[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }
}

// partial[b, ti * nt + tj] = sum over tile (ti, tj) of XX o GG.
__global__ void __launch_bounds__(kThreads)
gram_tiles_kernel(const float* __restrict__ qx, const float* __restrict__ qg,
                  float* __restrict__ partial, int B, int T, int Dx, int Dg) {
  __shared__ __align__(16) float si[kK][kStride];
  __shared__ __align__(16) float sj[kK][kStride];
  __shared__ float warp_part[kThreads / 32];
  const int nt = gridDim.x;
  const int tj = blockIdx.x, ti = blockIdx.y;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    float xx[4][4] = {}, gg[4][4] = {};
    gram_tile(qx + (long long)b * T * Dx, T, Dx, ti * kTile, tj * kTile, si,
              sj, xx);
    gram_tile(qg + (long long)b * T * Dg, T, Dg, ti * kTile, tj * kTile, si,
              sj, gg);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s = fmaf(xx[r][c], gg[r][c], s);
    }
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t += warp_part[w];
      partial[((long long)b * nt + ti) * nt + tj] = t;
    }
    __syncthreads();
  }
}

// out[b] = sum of example b's P partials, in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int B, int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)b * P + p];
  out[b] = s;
}

// Q(m) into q: the quantize kernel of luq_quant.cu, one row per example,
// its float4 path when the row length and the pointers allow it.
int quantize(const void* m, const void* u, const void* alpha, void* q,
             int B, long long n, cudaStream_t s) {
  const int vec = n % 4 == 0 &&
                  (((uintptr_t)m | (uintptr_t)u | (uintptr_t)q) & 15) == 0;
  return repro_luq_quant(m, u, alpha, q, B, n, 0, vec, (void*)s);
}

}  // namespace

// Number of partials per example: the caller allocates `partial` as
// (B, repro_ghost_norm_partials(T)) float32.
extern "C" int repro_ghost_norm_partials(int T) {
  const int nt = (T + kTile - 1) / kTile;
  return nt * nt;
}

// x, qx: (B, T, Dx); g, qg: (B, T, Dg); ux: (T * Dx,); ug: (T * Dg,); ax,
// ag, out: (B,); partial: (B, repro_ghost_norm_partials(T)).  qx, qg and
// partial are scratch.  All float32, contiguous, on the device.  Returns
// the cudaError_t of the launches.
extern "C" int repro_ghost_norm(const void* x, const void* ux, const void* ax,
                                const void* g, const void* ug, const void* ag,
                                void* qx, void* qg, void* partial, void* out,
                                int B, int T, int Dx, int Dg, void* stream) {
  if (B < 1 || T < 1 || Dx < 1 || Dg < 1) return (int)cudaErrorInvalidValue;
  const int nt = (T + kTile - 1) / kTile;
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = quantize(x, ux, ax, qx, B, (long long)T * Dx, s);
  if (rc != (int)cudaSuccess) return rc;
  rc = quantize(g, ug, ag, qg, B, (long long)T * Dg, s);
  if (rc != (int)cudaSuccess) return rc;
  const dim3 grid(nt, nt, B < kMaxGridY ? B : kMaxGridY);
  gram_tiles_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)qx, (const float*)qg, (float*)partial, B, T, Dx, Dg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      (const float*)partial, (float*)out, B, nt * nt);
  return (int)cudaGetLastError();
}
