// LUQ-FP4 stochastic quantizer for Hopper (sm_90a): the whole quantize
// op in two launches, drawing its own uniforms.
//
// Replaces the Pallas TPU kernel `luq_quant_2d` (src/repro/kernels/
// luq_quant.py, `_luq_kernel`) and what its JAX wrapper does around it
// (`ops.luq_quantize`: the per-tensor max, the threefry draws).  For each
// row r of x (R, N):
//
//     alpha[r]  = max_n |x[r, n]|
//     out[r, n] = luq_round(x[r, n], u[n], alpha[r])
//
// with one draw u shared by every row (a tensor quantized whole is one row;
// the per-example rows of a microbatch share the draw of their fake-quant
// call, as the JAX package's vmap with an unbatched key does).  u is the
// Philox4x32-10 stream of the call's key (philox.cuh): element n takes lane
// n % 4 of the call with counter (n / 4, 0, 0, 0), u = (word >> 8) 2^-24,
// the layout of the plain twin repro_torch.quant.philox.  x is read in its
// own type (float32 or bf16) and the result written in it: bf16 -> float32
// is exact, the rounding runs in float32, and the float32 result goes back
// to bf16 with round-to-nearest-even, as the TPU kernel casts its output
// (`out.astype(o_ref.dtype)`) and PyTorch's `.to(torch.bfloat16)` does.
// With `codes`, the kernel writes the bf16 code Q(x) / alpha = sign 2^-k
// (luq_code), which bf16 holds exactly: the fused ghost norm's operands.
//
// The DPQuant policy flag.  An optional `flag` (one float32 in device
// memory, the layer's entry of the trainer's flags tensor) is read by both
// launches, so one CUDA graph serves every policy: the reference's
// lax.cond(flag > 0.5, quantize, identity).  With the flag at 0 the row-max
// pass returns at once and the rounding pass copies x to the output bit for
// bit (codes: x cast to bf16, exact for a bf16 x, and alpha 1), one read
// and one write an element.
//
// What bounds it on this card.  By bytes: x read once and the result
// written once, 4 bytes an element for bf16 (8 for float32).  By the
// arithmetic: one Philox call per 4 elements and LUQ's rounding come to
// ~60 instructions an element in the compiled rounding pass (an IEEE
// division, the level and its guarded log2f, compares and selects, the
// Philox rounds, the uniform's conversion), and at the card's issue rate
// that takes longer than the bytes: the rounding pass is held by its
// instruction count, the max pass by memory.  The second read of a weight
// of up to 35 MB is partly served by the 50 MB L2.
//
// Design.  The quantize op before this took six device passes (a float32
// copy of a bf16 operand, |x|, amax, torch.rand's uniforms, the rounding
// kernel reading x and u, the cast back): ~40 bytes an element for bf16.
// Here nothing but x is read and nothing but the result written:
//   1. luq_row_max_kernel: block (p, r) takes a contiguous part of row r
//      (at least 4096 elements, at most 1024 parts a row), 8 loads of 16
//      bytes in flight a thread, and writes the largest |x| of its part,
//      as the bits of a non-negative float, to a (R, P) scratch of
//      partial maxima.  |x| compares as an unsigned integer on its bits
//      (NaN above inf, as torch's amax keeps a NaN), so the maximum is
//      exact in any order: no atomics, no zeroing launch, the same bits
//      every run.
//   2. luq_round_kernel: one wave of blocks (4 an SM, at most 64
//      registers a thread), a row's blocks striding over its groups of 4
//      consecutive elements.  A thread issues its first group's load,
//      then the block takes the row's alpha, the max of the row's P
//      partials (every thread reads a few; block 0 of the row also writes
//      it to `alpha_out`, for the ghost norm's scales).  Then per group
//      it issues the next group's load, draws the 4 uniforms with one
//      Philox call and rounds each element with luq.cuh, so that a load
//      is in flight while the arithmetic, which holds this pass, runs.
//      Vector loads and stores (16 bytes of float32 or 8 of bf16 a group)
//      when the row and pointers allow it, else one element at a time.
//
// A shard of an operand.  When a tensor is split over ranks (the model
// axis: a column- or row-parallel projection's weight, activation or
// cotangent), each rank holds a part of every row, and the shard must
// round as the slice of the whole row's quantization: with the whole
// row's alpha and each element's uniform drawn at its index in the whole
// row.  The op then splits in two so the caller can take the max over
// the ranks between them:
//   repro_luq_row_max: pass 1, then luq_alpha_kernel folds each row's
//      partials into alpha (R,) float32 (no flag: one read either way);
//   repro_luq_round: luq_round_given_kernel, the rounding against the
//      given alpha, each local element e at its global index
//      G(e) = (e / blk) gblk + off + e % blk (a split dim of n_glob
//      entries of `inner` elements each, of which the rank holds n_loc
//      from entry o: blk = n_loc inner, gblk = n_glob inner, off = o
//      inner; blk = 0 is the identity).  Where blk, gblk and off are
//      multiples of 4, four local neighbours 4g .. 4g + 3 are one global
//      group and share one Philox call; else (a head_dim or a split
//      width that is not a multiple of 4) each element draws the call of
//      its own group G / 4 and takes lane G % 4.
// No --use_fast_math: luq.cuh's rounding is the plain version's float32
// operations bit for bit only with IEEE log2f, division and conversions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "luq.cuh"
#include "philox.cuh"

namespace {

using repro_luq::luq_code;
using repro_luq::luq_round;
using repro_philox::philox_group;
using repro_philox::philox_round_keys;
using repro_philox::RoundKeys;
using repro_philox::uniform24;
using repro_philox::Words;

constexpr int kThreads = 256;
constexpr int kRoundBlocksPerSm = 4;         // the round pass's occupancy
constexpr int kMaxUnroll = 8;                // 16-byte loads in flight, max pass
constexpr long long kMinPart = 4096;         // elements a max block, least
constexpr int kMaxParts = 1024;              // max blocks a row
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

// ---- element types ------------------------------------------------------ //
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements e0 .. e0 + 3 of a row as float32; kVec: one aligned vector load
// (e0 % 4 == 0, the row's start aligned to 4 elements), else one load
// each, 0 past the row's end n.
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ row,
                                      long long e0, long long n,
                                      float (&v)[4]) {
  if constexpr (kVec && sizeof(T) == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(row + e0));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (kVec) {
    // four bf16: a float32 is the bf16's bits in its upper half
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + e0));
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = e0 + j < n ? to_f32(row[e0 + j]) : 0.f;
    }
  }
}

template <typename O, bool kVec>
__device__ __forceinline__ void store4(O* __restrict__ row, long long e0,
                                       long long n, const float (&q)[4]) {
  if constexpr (kVec && sizeof(O) == 4) {
    *reinterpret_cast<float4*>(row + e0) = make_float4(q[0], q[1], q[2], q[3]);
  } else if constexpr (kVec) {
    uint2 w;
    w.x = (uint32_t)__bfloat16_as_ushort(from_f32<O>(q[0])) |
          ((uint32_t)__bfloat16_as_ushort(from_f32<O>(q[1])) << 16);
    w.y = (uint32_t)__bfloat16_as_ushort(from_f32<O>(q[2])) |
          ((uint32_t)__bfloat16_as_ushort(from_f32<O>(q[3])) << 16);
    *reinterpret_cast<uint2*>(row + e0) = w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < n) row[e0 + j] = from_f32<O>(q[j]);
    }
  }
}

// The policy flag: on when absent or above 0.5 (NaN is off, as in the
// plain version's torch.where(flag > 0.5, ...)).
__device__ __forceinline__ bool flag_on(const float* flag) {
  return flag == nullptr || __ldg(flag) > 0.5f;
}

// Elements e0 .. e0 + 3 of a row copied to the output unrounded: the bits
// themselves when O is T, else x's float32 value cast to O (bf16 codes of
// a float32 x, round-to-nearest-even).
template <typename T, typename O, bool kVec>
__device__ __forceinline__ void pass4(const T* __restrict__ row,
                                      O* __restrict__ out, long long e0,
                                      long long n) {
  if constexpr (std::is_same<T, O>::value) {
    if constexpr (kVec && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out + e0) =
          __ldg(reinterpret_cast<const float4*>(row + e0));
    } else if constexpr (kVec) {
      *reinterpret_cast<uint2*>(out + e0) =
          __ldg(reinterpret_cast<const uint2*>(row + e0));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e0 + j < n) out[e0 + j] = row[e0 + j];
      }
    }
  } else {
    float v[4];
    load4<T, kVec>(row, e0, n, v);
    store4<O, kVec>(out, e0, n, v);
  }
}

// ---- pass 1: partial row maxima ----------------------------------------- //
// The largest |x| bits of the 16 bytes at p: four float32 or eight bf16
// (a bf16's bits are the upper half of its float32's).
template <typename T>
__device__ __forceinline__ uint32_t abs_max16(const T* p) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (sizeof(T) == 4) {
    return max(max(w.x & 0x7fffffffu, w.y & 0x7fffffffu),
               max(w.z & 0x7fffffffu, w.w & 0x7fffffffu));
  } else {
    uint32_t a = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = k == 0 ? w.x : (k == 1 ? w.y : (k == 2 ? w.z : w.w));
      a = max(a, max((v & 0x7fffu) << 16, v & 0x7fff0000u));
    }
    return a;
  }
}

// part[r, p] = bits of max |x[r, e]| over elements [p * per, (p + 1) *
// per) of row r (per a multiple of the 16-byte vector's elements when
// kVec).  kVec: 16-byte loads, kMaxUnroll of them in flight a thread.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
luq_row_max_kernel(const T* __restrict__ x, uint32_t* __restrict__ part,
                   const float* __restrict__ flag, int rows, long long n,
                   long long per) {
  constexpr int kLane = 16 / sizeof(T);      // elements a 16-byte load
  if (!flag_on(flag)) return;                // the rounding pass copies x
  __shared__ uint32_t warp_max[kThreads / 32];
  const long long e0 = (long long)blockIdx.x * per;
  const long long e1 = min(n, e0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* xr = x + (long long)r * n;
    uint32_t m = 0u;
    if constexpr (kVec) {
      for (long long e = e0 + (long long)threadIdx.x * kLane; e < e1;
           e += (long long)kMaxUnroll * kThreads * kLane) {
        uint32_t v[kMaxUnroll];
#pragma unroll
        for (int i = 0; i < kMaxUnroll; ++i) {
          const long long ei = e + (long long)i * kThreads * kLane;
          v[i] = ei < e1 ? abs_max16(xr + ei) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kMaxUnroll; ++i) m = max(m, v[i]);
      }
    } else {
      for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
        m = max(m, __float_as_uint(to_f32(xr[e])) & 0x7fffffffu);
      }
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t b = 0u;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) b = max(b, warp_max[w]);
      part[(long long)r * gridDim.x + blockIdx.x] = b;
    }
    __syncthreads();
  }
}

// ---- pass 2: the rounding ----------------------------------------------- //
template <bool kCodes>
__device__ __forceinline__ float luq_out(float x, float u, float a) {
  return kCodes ? luq_code(x, u, a) : luq_round(x, u, a);
}

template <typename T, typename O, bool kCodes, bool kVec>
__global__ void __launch_bounds__(kThreads, kRoundBlocksPerSm)
luq_round_kernel(const T* __restrict__ x, O* __restrict__ out,
                 const uint32_t* __restrict__ part, float* __restrict__ alpha_out,
                 const float* __restrict__ flag, int rows, long long n,
                 int parts, RoundKeys rk) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!flag_on(flag)) {
    // the layer's flag is off: x passes through (alpha 1 for the codes)
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
      if (alpha_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        alpha_out[r] = 1.f;
      }
      for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
           g < groups; g += stride) {
        pass4<T, O, kVec>(x + (long long)r * n, out + (long long)r * n,
                          4 * g, n);
      }
    }
    return;
  }
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* xr = x + (long long)r * n;
    O* outr = out + (long long)r * n;
    long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (g < groups) load4<T, kVec>(xr, 4 * g, n, v);
    // the row's alpha, while the first load is in flight
    uint32_t m = 0u;
    for (int p = threadIdx.x; p < parts; p += kThreads) {
      m = max(m, __ldg(part + (long long)r * parts + p));
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    m = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    const float a = __uint_as_float(m);
    if (alpha_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      alpha_out[r] = a;
    }
    while (g < groups) {
      const long long next = g + stride;
      float vn[4] = {0.f, 0.f, 0.f, 0.f};
      if (next < groups) load4<T, kVec>(xr, 4 * next, n, vn);
      const Words w = philox_group((uint64_t)g, 0u, rk);
      float q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = luq_out<kCodes>(v[j], uniform24(w.w[j]), a);
      }
      store4<O, kVec>(outr, 4 * g, n, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = vn[j];
      g = next;
    }
    __syncthreads();                         // warp_max of the next row
  }
}

// alpha[r] = the largest of row r's `parts` partial maxima (bits of
// non-negative floats, compared as integers: exact in any order).
__global__ void __launch_bounds__(kThreads)
luq_alpha_kernel(const uint32_t* __restrict__ part, float* __restrict__ alpha,
                 int rows, int parts) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    uint32_t m = 0u;
    for (int p = threadIdx.x; p < parts; p += kThreads) {
      m = max(m, __ldg(part + (long long)r * parts + p));
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t b = 0u;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) b = max(b, warp_max[w]);
      alpha[r] = __uint_as_float(b);
    }
    __syncthreads();
  }
}

// The index in the whole row of a shard's element e (blk 0: e itself).
struct IndexMap {
  long long blk, gblk, off;
};

__device__ __forceinline__ long long global_of(long long e,
                                               const IndexMap& m) {
  return m.blk == 0 ? e : (e / m.blk) * m.gblk + m.off + e % m.blk;
}

__device__ __forceinline__ uint32_t lane_word(const Words& w, int lane) {
  return lane == 0 ? w.w[0] : (lane == 1 ? w.w[1]
                                         : (lane == 2 ? w.w[2] : w.w[3]));
}

// The rounding of a shard's rows against given scales: element e of row
// r rounds against alpha_in[r] and the uniform of global_of(e).  kWhole:
// the map keeps groups of 4 whole (one Philox call a group), else one
// call an element.  The flag as in luq_round_kernel.
template <typename T, typename O, bool kCodes, bool kVec, bool kWhole>
__global__ void __launch_bounds__(kThreads, kRoundBlocksPerSm)
luq_round_given_kernel(const T* __restrict__ x, O* __restrict__ out,
                       const float* __restrict__ alpha_in,
                       float* __restrict__ alpha_out,
                       const float* __restrict__ flag, int rows, long long n,
                       IndexMap map, RoundKeys rk) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const bool on = flag_on(flag);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* xr = x + (long long)r * n;
    O* outr = out + (long long)r * n;
    const float a = on ? __ldg(alpha_in + r) : 1.f;
    if (alpha_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      alpha_out[r] = a;
    }
    for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
         g < groups; g += stride) {
      if (!on) {
        pass4<T, O, kVec>(xr, outr, 4 * g, n);
        continue;
      }
      float v[4];
      load4<T, kVec>(xr, 4 * g, n, v);
      float q[4];
      if constexpr (kWhole) {
        const long long e0 = global_of(4 * g, map);
        const Words w = philox_group((uint64_t)(e0 >> 2), 0u, rk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q[j] = luq_out<kCodes>(v[j], uniform24(w.w[j]), a);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q[j] = 0.f;
          if (4 * g + j < n) {
            const long long e = global_of(4 * g + j, map);
            const Words w = philox_group((uint64_t)(e >> 2), 0u, rk);
            q[j] = luq_out<kCodes>(v[j], uniform24(lane_word(w, (int)(e & 3))),
                                   a);
          }
        }
      }
      store4<O, kVec>(outr, 4 * g, n, q);
    }
  }
}

int parts_of(long long n) {
  long long p = (n + kMinPart - 1) / kMinPart;
  return (int)(p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p));
}

// Blocks of the round pass in one wave on the current device.
int wave_blocks() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms * kRoundBlocksPerSm;
}

template <typename T, typename O, bool kCodes, bool kVec, bool kVec16>
int launch(const void* x, void* out, uint32_t* part, float* alpha_out,
           const float* flag, int rows, long long n, const RoundKeys& rk,
           cudaStream_t s) {
  // the max pass's parts: whole 16-byte vectors when it loads them
  const long long quantum = kVec16 ? 16 / sizeof(T) : 1;
  long long per = (n + parts_of(n) - 1) / parts_of(n);
  per = (per + quantum - 1) / quantum * quantum;
  const int parts = (int)((n + per - 1) / per);
  const int gy = rows < kMaxGridY ? rows : kMaxGridY;
  luq_row_max_kernel<T, kVec16><<<dim3(parts, gy), kThreads, 0, s>>>(
      (const T*)x, part, flag, rows, n, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one wave: a row's share of it, never more blocks than groups need
  const long long groups = (n + 3) / 4;
  const long long need = (groups + kThreads - 1) / kThreads;
  long long gx = wave_blocks() / gy;
  gx = gx < 1 ? 1 : (gx > need ? need : gx);
  luq_round_kernel<T, O, kCodes, kVec><<<dim3((unsigned)gx, gy), kThreads, 0,
                                         s>>>(
      (const T*)x, (O*)out, part, alpha_out, flag, rows, n, parts, rk);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kCodes>
int launch_aligned(const void* x, void* out, uint32_t* part, float* alpha_out,
                   const float* flag, int rows, long long n,
                   const RoundKeys& rk, cudaStream_t s) {
  // the round pass: groups of 4 as one load and one store; the max pass:
  // 16-byte loads, every row starting on the 16-byte grid
  const bool vec = n % 4 == 0 &&
                   (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)out % (4 * sizeof(O)) == 0;
  const bool vec16 = (n * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  if (vec) {
    return vec16 ? launch<T, O, kCodes, true, true>(x, out, part, alpha_out,
                                                    flag, rows, n, rk, s)
                 : launch<T, O, kCodes, true, false>(x, out, part, alpha_out,
                                                     flag, rows, n, rk, s);
  }
  return vec16 ? launch<T, O, kCodes, false, true>(x, out, part, alpha_out,
                                                   flag, rows, n, rk, s)
               : launch<T, O, kCodes, false, false>(x, out, part, alpha_out,
                                                    flag, rows, n, rk, s);
}

}  // namespace

// Words (4 bytes each) of the scratch a call of `rows` rows of n elements
// needs: the (rows, P) partial maxima.
extern "C" long long repro_luq_quant_scratch(int rows, long long n) {
  return (long long)rows * parts_of(n);
}

// x: (rows, n), float32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous at
// any address; out: (rows, n) in x's type (codes = 0) or bf16 codes
// (codes = 1); scratch: repro_luq_quant_scratch(rows, n) words; alpha_out:
// (rows,) float32 or null.  (k0, k1): the Philox key of the draw.  flag:
// one float32 on the device, read by both launches (0: x passes through),
// or null (always quantize).  Two launches on `stream`; returns the
// cudaError_t of the launches.
extern "C" int repro_luq_quant(const void* x, int x_bf16, void* out,
                               int codes, int rows, long long n, uint32_t k0,
                               uint32_t k1, void* scratch, void* alpha_out,
                               const void* flag, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const RoundKeys rk = philox_round_keys(k0, k1);
  auto* part = (uint32_t*)scratch;
  auto* alpha = (float*)alpha_out;
  const auto* fl = (const float*)flag;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    return codes ? launch_aligned<bf16, bf16, true>(x, out, part, alpha, fl,
                                                    rows, n, rk, s)
                 : launch_aligned<bf16, bf16, false>(x, out, part, alpha, fl,
                                                     rows, n, rk, s);
  }
  return codes ? launch_aligned<float, bf16, true>(x, out, part, alpha, fl,
                                                   rows, n, rk, s)
               : launch_aligned<float, float, false>(x, out, part, alpha, fl,
                                                     rows, n, rk, s);
}

namespace {

template <typename T>
int launch_row_max(const void* x, int rows, long long n, uint32_t* part,
                   float* alpha, cudaStream_t s) {
  const bool vec16 = (n * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  const long long quantum = vec16 ? 16 / sizeof(T) : 1;
  long long per = (n + parts_of(n) - 1) / parts_of(n);
  per = (per + quantum - 1) / quantum * quantum;
  const int parts = (int)((n + per - 1) / per);
  const int gy = rows < kMaxGridY ? rows : kMaxGridY;
  if (vec16) {
    luq_row_max_kernel<T, true><<<dim3(parts, gy), kThreads, 0, s>>>(
        (const T*)x, part, nullptr, rows, n, per);
  } else {
    luq_row_max_kernel<T, false><<<dim3(parts, gy), kThreads, 0, s>>>(
        (const T*)x, part, nullptr, rows, n, per);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  luq_alpha_kernel<<<gy, kThreads, 0, s>>>(part, alpha, rows, parts);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kCodes, bool kVec, bool kWhole>
int launch_given4(const void* x, void* out, const float* alpha_in,
                  float* alpha_out, const float* flag, int rows, long long n,
                  const IndexMap& map, const RoundKeys& rk, cudaStream_t s) {
  const long long groups = (n + 3) / 4;
  const long long need = (groups + kThreads - 1) / kThreads;
  const int gy = rows < kMaxGridY ? rows : kMaxGridY;
  long long gx = wave_blocks() / gy;
  gx = gx < 1 ? 1 : (gx > need ? need : gx);
  luq_round_given_kernel<T, O, kCodes, kVec, kWhole>
      <<<dim3((unsigned)gx, gy), kThreads, 0, s>>>(
          (const T*)x, (O*)out, alpha_in, alpha_out, flag, rows, n, map, rk);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kCodes>
int launch_given(const void* x, void* out, const float* alpha_in,
                 float* alpha_out, const float* flag, int rows, long long n,
                 const IndexMap& map, const RoundKeys& rk, cudaStream_t s) {
  const bool vec = n % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)out % (4 * sizeof(O)) == 0;
  const bool whole = map.blk == 0 || (map.blk % 4 == 0 &&
                                      map.gblk % 4 == 0 && map.off % 4 == 0);
  if (vec) {
    return whole ? launch_given4<T, O, kCodes, true, true>(
                       x, out, alpha_in, alpha_out, flag, rows, n, map, rk, s)
                 : launch_given4<T, O, kCodes, true, false>(
                       x, out, alpha_in, alpha_out, flag, rows, n, map, rk, s);
  }
  return whole ? launch_given4<T, O, kCodes, false, true>(
                     x, out, alpha_in, alpha_out, flag, rows, n, map, rk, s)
               : launch_given4<T, O, kCodes, false, false>(
                     x, out, alpha_in, alpha_out, flag, rows, n, map, rk, s);
}

}  // namespace

// The row maxima alone: alpha_out (rows,) float32 = max |x[r]| of x
// (rows, n), float32 or bf16; scratch: repro_luq_quant_scratch(rows, n)
// words.  Two launches on `stream`.
extern "C" int repro_luq_row_max(const void* x, int x_bf16, int rows,
                                 long long n, void* scratch, void* alpha_out,
                                 void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  auto* part = (uint32_t*)scratch;
  auto* alpha = (float*)alpha_out;
  const cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? launch_row_max<__nv_bfloat16>(x, rows, n, part, alpha, s)
                : launch_row_max<float>(x, rows, n, part, alpha, s);
}

// The rounding alone, against the given alpha_in (rows,) float32, element
// e at its global index (blk, gblk, off; blk = 0: e itself); alpha_out
// (rows,) or null gets alpha_in (1 where the flag is 0).  Otherwise as
// repro_luq_quant.  One launch on `stream`.
extern "C" int repro_luq_round(const void* x, int x_bf16, void* out,
                               int codes, int rows, long long n, uint32_t k0,
                               uint32_t k1, const void* alpha_in,
                               void* alpha_out, long long blk, long long gblk,
                               long long off, const void* flag,
                               void* stream) {
  if (rows < 1 || n < 1 || alpha_in == nullptr || blk < 0 ||
      (blk > 0 && (gblk < blk || off < 0 || off > gblk - blk))) {
    return (int)cudaErrorInvalidValue;
  }
  const RoundKeys rk = philox_round_keys(k0, k1);
  const IndexMap map{blk, gblk, off};
  const auto* ain = (const float*)alpha_in;
  auto* aout = (float*)alpha_out;
  const auto* fl = (const float*)flag;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    return codes ? launch_given<bf16, bf16, true>(x, out, ain, aout, fl, rows,
                                                  n, map, rk, s)
                 : launch_given<bf16, bf16, false>(x, out, ain, aout, fl,
                                                   rows, n, map, rk, s);
  }
  return codes ? launch_given<float, bf16, true>(x, out, ain, aout, fl, rows,
                                                 n, map, rk, s)
               : launch_given<float, float, false>(x, out, ain, aout, fl,
                                                   rows, n, map, rk, s);
}
