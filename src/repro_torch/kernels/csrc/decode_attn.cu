// Fused one-token GQA attention over the quantized slot-pool KV cache,
// for Hopper (sm_90a): split-S ("flash-decoding") over the cache rows.
//
// Replaces the Pallas TPU kernel `decode_attn_call` (src/repro/kernels/
// decode_attn.py, `_decode_attn_kernel`).  For slot b and kv head h the g
// query rows of that head attend to cache rows s <= pos[b]: decode the
// codes, fold the K scale into the score (score * (k_scale * scale)),
// softmax, fold the V scale into the probability, and sum the value rows.
//
// Bound on this card: bytes (int8) or float32 operations (luq_fp4), both
// about a microsecond at yi-6b's decode shape (4 slots, 4 kv heads, g = 8,
// head_dim 128): a tick reads every live row once, codes plus two bf16
// scales, and does ~4 g FLOPs per stored element.  What the kernel really
// fights is latency: one (slot, kv head) is a chain of up to S dependent
// row steps, and the grid of one block per (slot, kv head) gave 16 blocks
// for 132 SMs.  So the rows are split across blocks:
//
// 1. decode_attn_split_kernel, grid (splits, slots x kv heads): block i
//    owns the fixed rows [i L, (i + 1) L), L = kSplit = 64, and returns at
//    once when i L > pos[b].  Split boundaries depend on row indices only,
//    never on B, the live slots or other slots' positions, so a slot's
//    output has the same bits alone as in any batch (the engine's decode
//    stays token-identical to the oneshot driver).  The block
//    - copies its live rows' K codes, then V codes, into shared memory
//      with 16-byte cp.async (two commit groups; int8: 8 lanes per 128-byte
//      row, fp4: 4 lanes per 64-byte row), every load in flight before any
//      arithmetic, and the V copy overlapping the scores;
//    - keeps q in registers: lane l owns elements 4l..4l+3 of all g rows;
//    - scores: warp w takes rows 8w..8w+7 in two groups of 4; each lane
//      forms its 4-element part of the 4 x 8 (row, query) dot products and
//      a transposing butterfly (5 levels, 31 shuffles for 32 sums) leaves
//      lane l holding the full score of row l / 8, query l % 8;
//    - softmax once per split: warp j takes query row j, the split's max
//      first, then one expf per row (2 per lane), its sum by a butterfly;
//      p * v_scale goes to shared memory, (max, sum) to scratch;
//    - P V: warp w takes its 8 rows again, lane l its 4 output elements of
//      all g rows (32 accumulators), each V code decoded once; the 8 warps'
//      partials are added in warp order into the split's partial output.
//    Float32 SIMT, no tensor cores: a call is ~35 MFLOP, and float32 q
//    times the codes must stay float32 for the 1e-5 tolerance.
// 2. decode_attn_merge_kernel, one block per (slot, kv head), warp j for
//    query row j: the global max over the live splits, then the splits in
//    split order, out = sum_i acc_i exp(m_i - M) / sum_i l_i exp(m_i - M).
//
// Both launches come from one C entry point on one stream.  No atomics:
// every sum has a fixed order, so two runs give the same bits.  Only rows
// s <= pos[b] are read: masked rows have probability exactly zero in the
// reference, and stale rows past pos may hold anything (they are never
// copied).  The TPU padding of g to 8 and head_dim to 128 is gone.
//
// Alignment: the 16-byte copies need the code rows (hd or hd / 2 bytes)
// to be a multiple of 16 and both code tensors 16-byte aligned; otherwise
// the block copies byte by byte (same results, for odd test shapes).
//
// Limits: head_dim a multiple of 4 and at most 128; g at most 8 (yi-6b:
// g = 8, head_dim = 128).  The wrapper checks them.  Scratch: see
// repro_decode_attn_scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 64;                 // cache rows per split (L)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kSplit / kWarps;
constexpr int kMaxG = 8;
constexpr int kMaxHd = 128;
constexpr int kRowStride = kMaxHd;         // bytes of a staged code row
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSplit == 64 && kRowsPerWarp == 8 && kWarps == kMaxG,
              "the score, softmax and P V mappings assume these sizes");

// Shared memory of a split block, in bytes.  The warps' partial outputs
// (kRed) reuse the whole buffer once P V is done.
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kSplit * kRowStride;
constexpr int kOffScore = kOffV + kSplit * kRowStride;          // [s][j]
constexpr int kOffP = kOffScore + kSplit * kMaxG * 4;           // [s][j]
constexpr int kOffKs = kOffP + kSplit * kMaxG * 4;
constexpr int kOffVs = kOffKs + kSplit * 4;
constexpr int kStageBytes = kOffVs + kSplit * 4;
constexpr int kRedBytes = kWarps * kMaxG * kMaxHd * 4;
constexpr int kSmemBytes = kStageBytes > kRedBytes ? kStageBytes : kRedBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the n code rows at src (row_bytes each) into tile (kRowStride apart)
// and commit them as one cp.async group.
__device__ __forceinline__ void stage_rows(uint8_t* tile, const uint8_t* src,
                                           int n, int row_bytes, bool vec) {
  if (vec) {
    const int chunks = row_bytes / 16;
    for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      cp_async16(tile + r * kRowStride + c * 16,
                 src + (size_t)r * row_bytes + c * 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * row_bytes; i += kThreads) {
      const int r = i / row_bytes;
      const int c = i - r * row_bytes;
      tile[r * kRowStride + c] = src[(size_t)r * row_bytes + c];
    }
  }
  cp_async_commit();
}

// 2^(m - 7) for m in 1..7 is exact: biased exponent m + 120.
__device__ __forceinline__ float fp4_unit(unsigned c) {
  const unsigned m = c & 7u;
  const float mag = m ? __int_as_float((int)((m + 120u) << 23)) : 0.f;
  return (c & 8u) ? -mag : mag;
}

// Unscaled values of elements 4 lane .. 4 lane + 3 of one staged row.
// Lanes past head_dim read stale but finite codes; their q is zero and
// their outputs are never written.
template <bool kFp4>
__device__ __forceinline__ void unit4(const uint8_t* row, int lane,
                                      float v[4]) {
  if (kFp4) {
    const unsigned two = *reinterpret_cast<const uint16_t*>(row + 2 * lane);
    v[0] = fp4_unit(two & 0xfu);
    v[1] = fp4_unit((two >> 4) & 0xfu);
    v[2] = fp4_unit((two >> 8) & 0xfu);
    v[3] = fp4_unit((two >> 12) & 0xfu);
  } else {
    const char4 c = *reinterpret_cast<const char4*>(row + 4 * lane);
    v[0] = (float)c.x;
    v[1] = (float)c.y;
    v[2] = (float)c.z;
    v[3] = (float)c.w;
  }
}

// transpose_sum<16>: v[0..31] of every lane -> v[0] of lane l holds the
// warp's sum of v[l].  Each level sends half of the remaining values to
// the partner lane and keeps the half named by its own lane bit (a
// template, so every index is a constant and v stays in registers).
template <int kHalf>
__device__ __forceinline__ void transpose_sum(float* v, int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
  if constexpr (kHalf > 1) transpose_sum<kHalf / 2>(v, lane);
}

template <bool kFp4>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const float* __restrict__ q,
                         const uint8_t* __restrict__ k_codes,
                         const uint8_t* __restrict__ v_codes,
                         const __nv_bfloat16* __restrict__ k_scale,
                         const __nv_bfloat16* __restrict__ v_scale,
                         const int32_t* __restrict__ pos,
                         float* __restrict__ part, float* __restrict__ ml,
                         int n_kv, int g, int S, int hd, float scale,
                         bool vec) {
  __shared__ __align__(16) uint8_t smem[kSmemBytes];
  uint8_t* s_k = smem + kOffK;
  uint8_t* s_v = smem + kOffV;
  float* s_score = reinterpret_cast<float*>(smem + kOffScore);
  float* s_p = reinterpret_cast<float*>(smem + kOffP);
  float* s_ks = reinterpret_cast<float*>(smem + kOffKs);
  float* s_vs = reinterpret_cast<float*>(smem + kOffVs);

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.y;                 // slot * n_kv + kv head
  const int slot = bk / n_kv;
  const int last = min(pos[slot], S - 1);
  const int s0 = split * kSplit;
  if (s0 > last) return;
  const int n = min(kSplit, last + 1 - s0);  // live rows of this split
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_bytes = kFp4 ? hd / 2 : hd;
  const size_t row0 = (size_t)bk * S + s0;

  stage_rows(s_k, k_codes + row0 * row_bytes, n, row_bytes, vec);
  stage_rows(s_v, v_codes + row0 * row_bytes, n, row_bytes, vec);
  if (threadIdx.x < n) {
    s_ks[threadIdx.x] = __bfloat162float(k_scale[row0 + threadIdx.x]) * scale;
  } else if (threadIdx.x >= kSplit && threadIdx.x < kSplit + n) {
    const int s = threadIdx.x - kSplit;
    s_vs[s] = __bfloat162float(v_scale[row0 + s]);
  }
  float qr[kMaxG][4];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j][e] = (j < g && 4 * lane + e < hd)
          ? q[((size_t)bk * g + j) * hd + 4 * lane + e] : 0.f;
    }
  }
  cp_async_wait<1>();                        // the K rows have landed
  __syncthreads();

  // scores of rows 8 warp .. 8 warp + 7, four rows at a time
#pragma unroll
  for (int grp = 0; grp < kRowsPerWarp / 4; ++grp) {
    const int r0 = warp * kRowsPerWarp + grp * 4;
    float d[32];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float kv[4];
      unit4<kFp4>(s_k + (r0 + r) * kRowStride, lane, kv);
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        d[r * kMaxG + j] = qr[j][0] * kv[0] + qr[j][1] * kv[1]
                         + qr[j][2] * kv[2] + qr[j][3] * kv[3];
      }
    }
    transpose_sum<16>(d, lane);
    const int s = r0 + lane / kMaxG;
    if (s < n) s_score[s * kMaxG + lane % kMaxG] = d[0] * s_ks[s];
  }
  __syncthreads();

  // softmax of query row j = warp over the split: max first, then the
  // probabilities and their sum
  {
    const int j = warp;
    const bool on = j < g;
    const float x0 = (on && lane < n) ? s_score[lane * kMaxG + j] : -INFINITY;
    const float x1 = (on && lane + 32 < n)
        ? s_score[(lane + 32) * kMaxG + j] : -INFINITY;
    float m = fmaxf(x0, x1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    const float p0 = (on && lane < n) ? expf(x0 - m) : 0.f;
    const float p1 = (on && lane + 32 < n) ? expf(x1 - m) : 0.f;
    float l = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(kFull, l, off);
    }
    s_p[lane * kMaxG + j] = lane < n ? p0 * s_vs[lane] : 0.f;
    s_p[(lane + 32) * kMaxG + j] = lane + 32 < n ? p1 * s_vs[lane + 32] : 0.f;
    if (on && lane == 0) {
      float* out = ml + (((size_t)bk * n_split + split) * kMaxG + j) * 2;
      out[0] = m;
      out[1] = l;
    }
  }
  cp_async_wait<0>();                        // the V rows have landed
  __syncthreads();

  // P V over rows 8 warp .. 8 warp + 7: lane owns elements 4 lane .. + 3
  float acc[kMaxG][4];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const float4* s_p4 = reinterpret_cast<const float4*>(s_p);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = warp * kRowsPerWarp + r;
    if (s < n) {
      float vv[4];
      unit4<kFp4>(s_v + s * kRowStride, lane, vv);
      const float4 pa = s_p4[s * 2];
      const float4 pb = s_p4[s * 2 + 1];
      const float p[kMaxG] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(p[j], vv[e], acc[j][e]);
      }
    }
  }
  __syncthreads();                           // the stage buffers are dead
  float4* red = reinterpret_cast<float4*>(smem);   // [warp][j][hd / 4]
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    red[(warp * kMaxG + j) * (kMaxHd / 4) + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int quads = hd / 4;
  float4* dst = reinterpret_cast<float4*>(
      part + ((size_t)bk * n_split + split) * g * hd);
  for (int i = threadIdx.x; i < g * quads; i += kThreads) {
    const int j = i / quads;
    const int c = i - j * quads;
    float4 sum = red[j * (kMaxHd / 4) + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x = red[(w * kMaxG + j) * (kMaxHd / 4) + c];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    dst[i] = sum;
  }
}

// One block per (slot, kv head); warp j merges query row j's live splits.
__global__ void __launch_bounds__(kThreads)
decode_attn_merge_kernel(const float* __restrict__ part,
                         const float* __restrict__ ml,
                         const int32_t* __restrict__ pos,
                         float* __restrict__ out, int n_kv, int g, int S,
                         int hd, int n_split) {
  const int bk = blockIdx.x;
  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (j >= g) return;
  const int live = min(pos[bk / n_kv], S - 1) / kSplit + 1;
  const float* mlj = ml + (size_t)bk * n_split * kMaxG * 2 + j * 2;
  float M = -INFINITY;
  for (int i = lane; i < live; i += 32) M = fmaxf(M, mlj[i * kMaxG * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
  }
  const bool lane_on = 4 * lane < hd;
  const float4* src = reinterpret_cast<const float4*>(
      part + ((size_t)bk * n_split * g + j) * hd) + lane;
  const size_t split_stride = (size_t)g * hd / 4;          // in float4
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < live; i0 += 32) {
    // lane t holds split i0 + t's factor and weighted sum
    const bool own = i0 + lane < live;
    const float c_own = own ? expf(mlj[(i0 + lane) * kMaxG * 2] - M) : 0.f;
    const float lc_own = own ? mlj[(i0 + lane) * kMaxG * 2 + 1] * c_own : 0.f;
    const int stop = min(32, live - i0);
    for (int t0 = 0; t0 < stop; t0 += 8) {
      // the loads of 8 splits in flight, then their sums in split order
      float4 x[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        x[t] = (lane_on && t0 + t < stop)
            ? src[(size_t)(i0 + t0 + t) * split_stride]
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float c = __shfl_sync(kFull, c_own, t0 + t);
        const float lc = __shfl_sync(kFull, lc_own, t0 + t);
        if (t0 + t < stop) {
          l += lc;
          a.x += x[t].x * c;
          a.y += x[t].y * c;
          a.z += x[t].z * c;
          a.w += x[t].w * c;
        }
      }
    }
  }
  if (lane_on) {
    reinterpret_cast<float4*>(out + ((size_t)bk * g + j) * hd)[lane] =
        make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
}

int n_splits(int S) { return (S + kSplit - 1) / kSplit; }

}  // namespace

extern "C" int repro_decode_attn_limits(int* max_g, int* max_hd) {
  *max_g = kMaxG;
  *max_hd = kMaxHd;
  return 0;
}

// Float32 elements of the scratch repro_decode_attn needs: each split's
// partial output (g x hd) and its (max, sum) for kMaxG query rows.
extern "C" long long repro_decode_attn_scratch(int B, int n_kv, int g, int S,
                                               int hd) {
  return (long long)B * n_kv * n_splits(S) * ((long long)g * hd + 2 * kMaxG);
}

// q: (B, n_kv, g, hd) float32; k_codes/v_codes: (B, n_kv, S, hd) int8
// (fmt 0) or (B, n_kv, S, hd / 2) packed uint8 (fmt 1); k_scale/v_scale:
// (B, n_kv, S) bfloat16; pos: (B,) int32 with 0 <= pos; out: (B, n_kv, g,
// hd) float32; scratch: repro_decode_attn_scratch(...) float32, 16-byte
// aligned.  Two launches on `stream`.  Returns the cudaError_t of the
// launches.
extern "C" int repro_decode_attn(const void* q, const void* k_codes,
                                 const void* v_codes, const void* k_scale,
                                 const void* v_scale, const void* pos,
                                 void* out, void* scratch, int B, int n_kv,
                                 int g, int S, int hd, float scale, int fmt,
                                 void* stream) {
  if (B < 1 || n_kv < 1 || g < 1 || g > kMaxG || S < 1 || hd < 4 ||
      hd > kMaxHd || hd % 4 || fmt < 0 || fmt > 1 ||
      (uintptr_t)scratch % 16 || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_split = n_splits(S);
  const int row_bytes = fmt ? hd / 2 : hd;
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)k_codes % 16 == 0 &&
                   (uintptr_t)v_codes % 16 == 0;
  float* part = (float*)scratch;
  float* ml = part + (size_t)B * n_kv * n_split * g * hd;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_split, B * n_kv);
  if (fmt == 0) {
    decode_attn_split_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const uint8_t*)k_codes, (const uint8_t*)v_codes,
        (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
        (const int32_t*)pos, part, ml, n_kv, g, S, hd, scale, vec);
  } else {
    decode_attn_split_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const uint8_t*)k_codes, (const uint8_t*)v_codes,
        (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
        (const int32_t*)pos, part, ml, n_kv, g, S, hd, scale, vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_merge_kernel<<<B * n_kv, kThreads, 0, s>>>(
      part, ml, (const int32_t*)pos, (float*)out, n_kv, g, S, hd, n_split);
  return (int)cudaGetLastError();
}
