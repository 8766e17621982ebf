// LUQ-FP4 quantize-both-operands matmul for Hopper (sm_90a), drawing its
// own uniforms.
//
// Replaces the Pallas TPU kernel `quant_matmul` (src/repro/kernels/
// quant_matmul.py, `_qmm_kernel`).  out[r, n] = sum_k Q(a)[r, k] Q(b)[k, n],
// Q the LUQ-FP4 stochastic rounding of luq.cuh with per-tensor scales
// (`alpha_a` per row, `alpha_b` shared).  The TPU kernel reads explicit
// uniform tensors; this one draws them itself with Philox4x32-10
// (philox.cuh) and reads no uniform from device memory.  Element e of a (operand 0) or b (operand 1) takes
// lane e % 4 of the call with counter (e / 4, operand, 0), as the plain
// twin repro_torch.quant.philox lays the stream out.
//
// Keys: one key for all rows, passed by value (prefill, lockstep decode;
// a is one matrix, its element r * K + k), or one key a row, read from
// device memory (`row_keys`: the per-slot logits head, where row r
// quantizes a[r] (element k) and the whole of b with its own
// position-derived stream).  The per-row keys are built on the device
// from the slots' positions, so a CUDA graph of the decode step replays
// with each tick's keys; each block turns its rows' keys into round keys
// in shared memory once, before its loop.
//
// What bounds it on this card: integer operations.  The serving head is
// (R <= 8, 4096) x (4096, 64000) float32: b is 1.05 GB (0.31 ms at
// 3.35 TB/s), and each row of a per-row call needs K N / 4 = 65.5 M Philox
// calls of at least 44 int32 operations (10 rounds of two 32 x 32 -> 64
// multiplies and two three-input XORs, a shift a word), 1.15 10^10 for a
// decode call of 4 rows: 0.69 ms at 132 SMs x 64 int32 lanes x 1.98 GHz.
// The previous design read R x K x N float32 uniforms that torch.rand had
// written (4.2 GB a decode tick), which alone bounded it (1.57 ms) above
// one float32 cuBLAS product of the quantized operands (1.39 ms; on their
// bf16 codes with float32 sums, 0.70 ms).
//
// Design:
//   1. quantize_a: Q(a) (R x K, a few KB) once into scratch, one thread an
//      element, one Philox call each.
//   2. the product: a block is 8 warps over 128 columns; lane l of every
//      warp owns columns 4 l .. 4 l + 3 of the block and reads them with
//      one 16-byte load per k (a warp reads 512 contiguous bytes of a row
//      of b).  The 8 warps split the block's K range (k = k0 + w, k0 + w +
//      8, ...), and the grid's y axis splits K further, so that a (K, N)
//      head keeps ~16 blocks an SM in flight for any R (N / 128 column
//      blocks alone are 500 at N = 64000, under 4 an SM).
//      Per element of b, LUQ's row-independent part is computed once
//      (`luq_prep`: y, sign, the level from the exponent bits, low / high,
//      p_up, the underflow threshold) and folded into a `luq_pick`: the
//      one threshold the row's draw is compared with, as a 24-bit integer,
//      and the two outcomes already times sign * alpha.  Per row remain one
//      Philox call per 4 consecutive columns (N % 4 == 0; other N take a
//      call per element), with the round keys precomputed (a shared key's
//      in the kernel's parameters, per-row keys in shared memory), then
//      per element a shift, an integer compare, a select
//      and the FMA: no uniform is converted to float.  Q(a)[r, k] is a
//      broadcast load from the scratch.  The sums (4 a row a thread) take
//      registers for 1, 4 or 8 rows, the fewest that hold the launch's, so
//      a prefill launch keeps more blocks an SM.  Loading rows of b ahead
//      measured no faster (more registers, fewer blocks an SM), so each
//      warp loads one at a time.
//   3. the warps' partial sums are added in shared memory in a fixed
//      order; with a K split, a last kernel adds the splits in order.
//   No atomics: the same inputs and keys give the same bits on every run.
//
// A vocab shard (the logits head split over the model group's ranks): b is
// the rank's (K, N) block of columns col0 .. col0 + N - 1 of a (K, n_glob)
// head.  Its element (k, n) draws at the whole head's counter k n_glob +
// col0 + n, its scale alpha_b is the whole head's (the group's max, given
// by the caller), and the K splits are chosen from n_glob: every column is
// then summed in the whole head's order, and the shard's output is the
// whole head's columns bit for bit.  A whole head is col0 = 0, n_glob = N.
//
// Numerics: Q(a) and Q(b) are, bit for bit, luq.cuh's rounding of the
// plain version's uniforms (repro_torch.kernels.ref.luq_matmul_keys_ref;
// the integer compares are the float ones, see luq.cuh); only the
// summation order of the product differs.  Not for --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "luq.cuh"
#include "philox.cuh"

namespace {

using repro_luq::luq_pick;
using repro_luq::luq_prep;
using repro_luq::luq_round;
using repro_luq::luq_value_m;
using repro_luq::Pick;
using repro_philox::philox_group;
using repro_philox::RoundKeys;
using repro_philox::uniform24;
using repro_philox::Words;

constexpr int kMaxRows = 8;                  // rows per launch
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4 * 32;                // output columns per block
constexpr int kBlocksPerSm = 16;             // K-split target

// Row r's round keys, from its words (k0, k1) in row_keys.
__device__ __forceinline__ RoundKeys row_round_keys(
    const uint32_t* __restrict__ row_keys, int r) {
  return repro_philox::philox_round_keys(__ldg(row_keys + 2 * r),
                                         __ldg(row_keys + 2 * r + 1));
}

// aq[r, k] = Q(a)[r, k]; row r of this launch is row row0 + r of the call.
// row_keys: the launch's rows' keys (rows x 2 words), or null for the
// shared key.
__global__ void quantize_a_kernel(const float* __restrict__ a,
                                  const float* __restrict__ alpha_a,
                                  RoundKeys shared_key,
                                  const uint32_t* __restrict__ row_keys,
                                  int rows, int row0, int K,
                                  float* __restrict__ aq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * K) return;
  const int r = i / K, k = i - r * K;
  const bool per_row = row_keys != nullptr;
  const uint64_t e = per_row ? (uint64_t)k : (uint64_t)(row0 + r) * K + k;
  const Words w = per_row ? philox_group(e >> 2, 0u,
                                         row_round_keys(row_keys, r))
                          : philox_group(e >> 2, 0u, shared_key);
  aq[i] = luq_round(a[i], uniform24(w.w[e & 3]), alpha_a[r]);
}

// The 24-bit integers m (uniform = m 2^-24) of elements e0 .. e0 + 3 of b
// for one key: one Philox call when e0 % 4 == 0 (kVec), else one per
// element.
template <bool kVec>
__device__ __forceinline__ void draws4(uint64_t e0, const RoundKeys& rk,
                                       uint32_t (&m)[4]) {
  if constexpr (kVec) {
    const Words w = philox_group(e0 >> 2, 1u, rk);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = w.w[j] >> 8;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t e = e0 + j;
      m[j] = philox_group(e >> 2, 1u, rk).w[e & 3] >> 8;
    }
  }
}

// b[k, n0 .. n0 + 3]: one 16-byte load (kVec), else 4 loads, 0 past N.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ b,
                                        size_t e0, int n0, int N) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(b + e0));
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = n0 + j < N ? __ldg(b + e0 + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// dst[split, r, n] = sum over k in split's range of Q(a)[r, k] Q(b)[k, n];
// dst is `out` itself when gridDim.y == 1.  kRows >= rows: the registers
// of the sums (kRows x 4 a thread) are sized to the launch, so a launch of
// one row (prefill) keeps more blocks an SM in flight.
template <bool kVec, int kRows>
__global__ void __launch_bounds__(kThreads)
luq_matmul_kernel(const float* __restrict__ aq, const float* __restrict__ b,
                  const float* __restrict__ alpha_b_ptr, RoundKeys shared_key,
                  const uint32_t* __restrict__ row_keys, int rows, int K,
                  int N, long long n_glob, long long col0, int k_per_split,
                  float* __restrict__ dst) {
  __shared__ float red[kWarps][kRows][kCols];
  __shared__ RoundKeys row_key[kRows];
  const bool per_row = row_keys != nullptr;
  if (per_row && threadIdx.x < rows) {
    row_key[threadIdx.x] = row_round_keys(row_keys, threadIdx.x);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols + 4 * lane;
  const int kb = blockIdx.y * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const float alpha_b = *alpha_b_ptr;

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  if (n0 < N) {
    for (int k = kb + warp; k < ke; k += kWarps) {
      const float4 v = load4<kVec>(b, (size_t)k * N + n0, n0, N);
      // the draws' counter: this element's index in the whole head
      const uint64_t e0 = (uint64_t)k * n_glob + col0 + n0;
      const float x[4] = {v.x, v.y, v.z, v.w};
      Pick q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = luq_pick(luq_prep(x[j], alpha_b));
      uint32_t m[4];
      if (!per_row) draws4<kVec>(e0, shared_key, m);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          if (per_row) draws4<kVec>(e0, row_key[r], m);
          const float ar = __ldg(aq + (size_t)r * K + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][j] = fmaf(ar, luq_value_m(q[j], m[j]), acc[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][r][4 * lane + j] = acc[r][j];
    }
  }
  __syncthreads();
  float* out = dst + (size_t)blockIdx.y * rows * N;
  for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
    const int r = i / kCols, c = i - r * kCols;
    const int n = blockIdx.x * kCols + c;
    if (n >= N) continue;
    float s = red[0][r][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][r][c];
    out[(size_t)r * N + n] = s;
  }
}

// out[i] = sum over s of partial[s, i], in order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  size_t plane) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float s = partial[i];
  for (int p = 1; p < splits; ++p) s += partial[(size_t)p * plane + i];
  out[i] = s;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

}  // namespace

extern "C" int repro_luq_matmul_max_rows() { return kMaxRows; }

// Splits of K for a (K, N) product: the `partial` scratch the caller
// allocates holds splits * rows * N floats (none for 1 split).
extern "C" int repro_luq_matmul_splits(int K, int N) {
  const int col_blocks = (N + kCols - 1) / kCols;
  const int want = (sm_count() * kBlocksPerSm + col_blocks - 1) / col_blocks;
  const int most = (K + 8 * kWarps - 1) / (8 * kWarps);  // >= 8 k a warp
  const int splits = want < most ? want : most;
  return splits > 1 ? splits : 1;
}

// a: (rows, K); b: (K, N), columns col0 .. col0 + N - 1 of a (K, n_glob)
// head (a whole head: col0 0, n_glob N); alpha_a: (rows,); alpha_b: one
// float, the whole head's scale; aq: (rows, K) scratch; partial:
// repro_luq_matmul_splits(K, n_glob) * rows * N scratch (unused for 1
// split); out: (rows, N).  All float32, contiguous,
// on the device.  Keys: row_keys, on the device, rows x 2 words (k0, k1),
// one key a row; or, when row_keys is null, the key (k0, k1) shared by
// every row; row0: the first row's index in the whole call (the shared
// stream numbers a's elements across launches).  Returns the cudaError_t
// of the launches.
extern "C" int repro_luq_matmul(const void* a, const void* b,
                                const void* alpha_a, const void* alpha_b,
                                unsigned k0, unsigned k1,
                                const void* row_keys, int row0, void* aq,
                                void* partial, void* out, int rows, int K,
                                int N, long long n_glob, long long col0,
                                void* stream) {
  if (rows < 1 || rows > kMaxRows || K < 1 || N < 1 || col0 < 0 ||
      col0 + N > n_glob || n_glob > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const RoundKeys shared_key = repro_philox::philox_round_keys(k0, k1);
  const auto* rk = (const uint32_t*)row_keys;
  const cudaStream_t s = (cudaStream_t)stream;
  quantize_a_kernel<<<(rows * K + 255) / 256, 256, 0, s>>>(
      (const float*)a, (const float*)alpha_a, shared_key, rk, rows, row0, K,
      (float*)aq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the whole head's K splits, so a shard sums in the whole head's order
  const int splits = repro_luq_matmul_splits(K, (int)n_glob);
  const int k_per_split = (K + splits - 1) / splits;
  const dim3 grid((N + kCols - 1) / kCols, splits);
  float* dst = splits > 1 ? (float*)partial : (float*)out;
  // whole 16-byte loads and whole Philox calls of 4 columns
  const bool vec = N % 4 == 0 && n_glob % 4 == 0 && col0 % 4 == 0 &&
                   ((uintptr_t)b & 15) == 0;
  const auto* aqf = (const float*)aq;
  const auto* bf = (const float*)b;
  const auto* ab = (const float*)alpha_b;
  if (vec) {
    if (rows == 1) {
      luq_matmul_kernel<true, 1><<<grid, kThreads, 0, s>>>(
          aqf, bf, ab, shared_key, rk, rows, K, N, n_glob, col0, k_per_split,
          dst);
    } else if (rows <= 4) {
      luq_matmul_kernel<true, 4><<<grid, kThreads, 0, s>>>(
          aqf, bf, ab, shared_key, rk, rows, K, N, n_glob, col0, k_per_split,
          dst);
    } else {
      luq_matmul_kernel<true, kMaxRows><<<grid, kThreads, 0, s>>>(
          aqf, bf, ab, shared_key, rk, rows, K, N, n_glob, col0, k_per_split,
          dst);
    }
  } else {
    luq_matmul_kernel<false, kMaxRows><<<grid, kThreads, 0, s>>>(
        aqf, bf, ab, shared_key, rk, rows, K, N, n_glob, col0, k_per_split,
          dst);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t plane = (size_t)rows * N;
  sum_splits_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, s>>>(
      (const float*)partial, (float*)out, splits, plane);
  return (int)cudaGetLastError();
}
