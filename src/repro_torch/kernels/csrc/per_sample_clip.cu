// Fused per-example clip and batch sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `per_sample_clip` (src/repro/kernels/
// per_sample_clip.py, `_clip_kernel`).  For (B, D) per-example gradient
// rows g:
//
//     norms[b] = ||g[b]||_2
//     out[d]   = sum_b min(1, C / max(norms[b], 1e-12)) * g[b, d]
//
// Bound on this card: bytes.  Reading the B x D float32 matrix once
// (2.86 GB for ResNet-18's 11.19 M parameters at B = 64) takes ~0.86 ms at
// 3.35 TB/s, and the kernel does two float32 operations per element.  But
// a (B, D) matrix in device memory has to be read twice: every clip factor
// needs its whole row's norm before any column can be summed, and 2.86 GB
// is far beyond the 50 MB L2.  The honest floor of this interface is two
// reads, ~1.71 ms; the design aims at the memory rate for both.
//
// Two launches on one stream, deterministic (no atomics, every sum in a
// fixed order, so a DP step is reproducible run to run; DP auditing
// replays steps):
//
//   1. row_sumsq: block (b, p) sums the squares of column chunk p of row b
//      into partial[b, p].  D is odd for ResNet-18, so rows b >= 1 do not
//      start on a 16-byte boundary (nor does row 0 of a view at an odd
//      offset; both passes take the misalignment from the address): each
//      chunk is a scalar head up to the next boundary, a float4 body (4
//      float4 loads in flight per thread) and a scalar tail.  The grid
//      runs p slowest, so the last blocks read the last columns of every
//      row and leave them in L2.
//   2. column_sum: a persistent grid (as many blocks as fit on the card)
//      walks contiguous tiles of kTile = 2048 columns, in reverse order
//      (the first tiles find pass 1's last columns in L2).  A block's
//      prologue adds the (B, P) partials of each row in order p = 0..P-1,
//      from L2, into the clip factors in shared memory: every block
//      computes the same bits, and block 0 writes norms.  For each tile it
//      walks b = 0..B-1 in order, reading each row's tile as one 8 KB run
//      (DRAM locality; 4 rows of loads in flight per thread), lane l of a
//      warp owning 4 columns of a 128-column segment, and keeps its 8
//      columns' sums in registers: acc = fma(scale[b], g[b, d], acc).  A
//      row whose tile starts k floats past a 16-byte address is read with
//      aligned float4s starting k columns early (the same 16-byte words,
//      so never outside the allocation); each lane takes the k columns it
//      lacks from its right neighbour by warp shuffle, the k read early
//      are dropped, and lane 31 reads its k with scalar loads, so no load
//      passes the tile's end.  The last, partial tile takes scalar loads.
//
// Both passes run at ~3.0 TB/s on an H100 (PERF.md).  Staging the tiles
// through a shared-memory ring of cp.async copies, 1024-column tiles or
// more rows in flight were all slower for pass 2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;               // column chunks per row (P)
constexpr long long kMinChunk = 4096;        // columns per chunk, at least
constexpr int kMaxRows = 8192;               // B: scale[] in shared memory
constexpr int kTile = 2048;                  // columns per block, pass 2
constexpr int kSegs = kTile / 128;           // 128-column segments a tile
constexpr int kSegsPerWarp = kSegs / (kThreads / 32);
constexpr int kRowUnroll = 4;                // rows of loads in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

__device__ __forceinline__ float sumsq4(float4 v, float acc) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

// Floats from p to the next 16-byte address (0 to 3).
__device__ __forceinline__ int misalign_to_next(const float* p) {
  return (int)((4 - (((uintptr_t)p >> 2) & 3)) & 3);
}

// Floats from the 16-byte address at or before p to p (0 to 3).
__device__ __forceinline__ int misalign_from_prev(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

__global__ void __launch_bounds__(kThreads)
row_sumsq_kernel(const float* __restrict__ g, float* __restrict__ partial,
                 long long D, int P) {
  __shared__ float warp_part[kThreads / 32];
  const int b = blockIdx.x;
  const int p = blockIdx.y;
  const long long chunk = (D + P - 1) / P;
  const long long start = (long long)p * chunk;
  const long long stop = start + chunk < D ? start + chunk : D;
  // element indices from g: [a0, h) head, [h, t) float4 body, [t, a1).
  // The head runs to the next 16-byte address, so any 4-byte aligned g
  // (a view at any offset) takes the same path.
  const long long a0 = (long long)b * D + start;
  const long long a1 = (long long)b * D + stop;
  long long h = a0 + misalign_to_next(g + a0);
  if (h > a1) h = a1;
  const long long nb = (a1 - h) >> 2;
  const long long t = h + 4 * nb;
  const int tid = threadIdx.x;
  float acc = 0.f;
  if (tid < h - a0) {
    const float v = __ldg(g + a0 + tid);
    acc = fmaf(v, v, acc);
  }
  const float4* body = reinterpret_cast<const float4*>(g + h);
  long long i = tid;
  for (; i + 3 * kThreads < nb; i += 4 * kThreads) {
    const float4 v0 = __ldg(body + i);
    const float4 v1 = __ldg(body + i + kThreads);
    const float4 v2 = __ldg(body + i + 2 * kThreads);
    const float4 v3 = __ldg(body + i + 3 * kThreads);
    acc = sumsq4(v0, acc);
    acc = sumsq4(v1, acc);
    acc = sumsq4(v2, acc);
    acc = sumsq4(v3, acc);
  }
  for (; i < nb; i += kThreads) acc = sumsq4(__ldg(body + i), acc);
  if (tid < a1 - t) {
    const float v = __ldg(g + t + tid);
    acc = fmaf(v, v, acc);
  }
  acc = warp_sum(acc);
  if ((tid & 31) == 0) warp_part[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
    partial[(long long)b * P + p] = s;
  }
}

// Columns 4 lane .. 4 lane + 3 of the row whose aligned float4 `own`
// starts `sh` columns early: the first sh of the neighbour's float4 come
// by shuffle, lane 31's from `ex`.  sh is the same for the whole warp.
__device__ __forceinline__ float4 realign(float4 own, const float ex[3],
                                          int sh, int lane) {
  float nx = __shfl_down_sync(kFull, own.x, 1);
  float ny = __shfl_down_sync(kFull, own.y, 1);
  float nz = __shfl_down_sync(kFull, own.z, 1);
  if (lane == 31) {
    nx = ex[0];
    ny = ex[1];
    nz = ex[2];
  }
  if (sh == 1) return make_float4(own.y, own.z, own.w, nx);
  if (sh == 2) return make_float4(own.z, own.w, nx, ny);
  return make_float4(own.w, nx, ny, nz);
}

// out[c0 .. c0 + kTile) (or to D) = sum_b scale[b] g[b, c], b in order.
__device__ __forceinline__ void column_tile(const float* __restrict__ g,
                                            const float* s_scale,
                                            float* __restrict__ out, int B,
                                            long long D, long long c0) {
  if (c0 + kTile > D) {                      // the partial last tile
    for (long long c = c0 + threadIdx.x; c < D; c += kThreads) {
      float acc = 0.f;
      for (int b = 0; b < B; ++b) {
        acc = fmaf(s_scale[b], __ldg(g + (long long)b * D + c), acc);
      }
      out[c] = acc;
    }
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int col[kSegsPerWarp];
#pragma unroll
  for (int k = 0; k < kSegsPerWarp; ++k) {
    col[k] = (warp + k * (kThreads / 32)) * 128 + 4 * lane;
  }
  float4 acc[kSegsPerWarp];
#pragma unroll
  for (int k = 0; k < kSegsPerWarp; ++k) {
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int b0 = 0; b0 < B; b0 += kRowUnroll) {
    float4 own[kRowUnroll][kSegsPerWarp];
    float ex[kRowUnroll][kSegsPerWarp][3];
#pragma unroll
    for (int r = 0; r < kRowUnroll; ++r) {
      const float* row = g + (long long)(b0 + r) * D + c0;
      const int sh = misalign_from_prev(row);
      const float* base = row - sh;
#pragma unroll
      for (int k = 0; k < kSegsPerWarp; ++k) {
        own[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        ex[r][k][0] = ex[r][k][1] = ex[r][k][2] = 0.f;
        if (b0 + r < B) {
          own[r][k] = __ldg(reinterpret_cast<const float4*>(base + col[k]));
          if (lane == 31) {
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (e < sh) ex[r][k][e] = __ldg(base + col[k] + 4 + e);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowUnroll; ++r) {
      const int b = b0 + r;
      if (b < B) {
        const int sh = misalign_from_prev(g + (long long)b * D + c0);
        const float sc = s_scale[b];
#pragma unroll
        for (int k = 0; k < kSegsPerWarp; ++k) {
          const float4 v = sh ? realign(own[r][k], ex[r][k], sh, lane)
                              : own[r][k];
          acc[k].x = fmaf(sc, v.x, acc[k].x);
          acc[k].y = fmaf(sc, v.y, acc[k].y);
          acc[k].z = fmaf(sc, v.z, acc[k].z);
          acc[k].w = fmaf(sc, v.w, acc[k].w);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSegsPerWarp; ++k) {
    *reinterpret_cast<float4*>(out + c0 + col[k]) = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ g,
                  const float* __restrict__ partial,
                  float* __restrict__ norms, float* __restrict__ out, int B,
                  long long D, int P, float clip_norm) {
  extern __shared__ float s_scale[];
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const float* row = partial + (long long)b * P;
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < P; ++p) s += row[p];
    const float n = sqrtf(s);
    s_scale[b] = fminf(1.f, clip_norm / fmaxf(n, 1e-12f));
    if (blockIdx.x == 0) norms[b] = n;
  }
  __syncthreads();

  const long long tiles = (D + kTile - 1) / kTile;
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    column_tile(g, s_scale, out, B, D, (tiles - 1 - k) * kTile);
  }
}

}  // namespace

// Number of column chunks P the first pass splits each row into; the
// caller allocates `partial` as (B, P) float32.
extern "C" int repro_per_sample_clip_chunks(long long D) {
  long long p = D / kMinChunk;
  if (p < 1) p = 1;
  if (p > kMaxChunks) p = kMaxChunks;
  return (int)p;
}

// g: (B, D), 4-byte aligned (a view at any element offset); out: (D,),
// 16-byte aligned; norms: (B,); partial: (B, P) scratch with P =
// repro_per_sample_clip_chunks(D).  All float32, contiguous, on the
// device.  Returns the cudaError_t of the launches.
extern "C" int repro_per_sample_clip(const void* g, void* out, void* norms,
                                     void* partial, int B, long long D,
                                     float clip_norm, void* stream) {
  if (B < 1 || B > kMaxRows || D < 1 || (uintptr_t)g % 4 ||
      (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = repro_per_sample_clip_chunks(D);
  const cudaStream_t s = (cudaStream_t)stream;
  row_sumsq_kernel<<<dim3(B, P), kThreads, 0, s>>>(
      (const float*)g, (float*)partial, D, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: as many blocks as fit on the card at once, each
  // adding the partials once and walking tiles k, k + grid, ...
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, column_sum_kernel,
                                                kThreads, B * sizeof(float));
  const long long tiles = (D + kTile - 1) / kTile;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  column_sum_kernel<<<(unsigned)blocks, kThreads, B * sizeof(float), s>>>(
      (const float*)g, (const float*)partial, (float*)norms, (float*)out, B,
      D, P, clip_norm);
  return (int)cudaGetLastError();
}
