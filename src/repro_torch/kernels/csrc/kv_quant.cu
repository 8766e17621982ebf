// KV-cache row quantization for Hopper (sm_90a), written straight into the
// cache: the K rows and the V rows of one call in one launch.
//
// Replaces the Pallas TPU kernel `kv_rowquant_2d` (src/repro/kernels/
// decode_attn.py, `_kv_rowquant_kernel`), the nibble packing its JAX
// wrapper did afterwards (`ops.kv_quant_rows`) and the cache writes of
// the decode step (`dynamic_update_slice` at each slot's position).  Per
// row of head_dim values: amax, the bf16-rounded scale, then int8 codes,
// or luq_fp4 codes packed two per byte (even index = low nibble).
//
// Rows: source (N0, N1, T, hd) of K and of V, read in their compute type
// (bf16 or float32) through their strides; row (i, j, t) lands at cache
// row (i, j, w_i + t) of codes (N0, N1, S, code_dim) and scales (N0, N1,
// S), w_i = wpos[i] clamped into [0, S - T] (0 without wpos).  The decode
// step is N0 = slots, N1 = kv heads, T = 1, wpos the slots' clamped
// positions: one launch a layer and tick, where the model made two float32
// copies, two quantize launches and four index writes.  Prefill is the
// layers' K and V stack, N0 = layers x batch, T = the prompt, from row 0.
// Every other cache row is left as it is.
//
// A sequence shard (the cache split over the model group's ranks by its
// rows, the reference's kv_seq fallback): the codes and scales hold rows
// row0 .. row0 + S - 1 of a cache of s_glob rows.  Row t of (i, j) goes to
// the whole cache's row w_i + t, w_i clamped into [0, s_glob - T], and is
// written, at local row w_i + t - row0, only when the shard holds it; the
// other rows of the call are skipped (one warp a row, so a whole warp
// leaves).  A whole cache is row0 = 0, s_glob = S.
//
// Bound on this card: bytes (read 2 B a bf16 element, write 1 or 0.5 B
// plus 2 B a row; a handful of float operations an element).  At the
// decode shapes (2 x 16 rows of 128) that is nanoseconds: the launch is
// the cost, and the design is about launches, not bytes.
//
// Design: one warp per row, the row's indices in 32-bit arithmetic.  When
// head_dim is a multiple of 4 up to 512 and the rows are aligned, each
// lane loads 4 consecutive elements a 128-element chunk with one vector
// load (8 bytes of bf16, 16 of float32), keeps them in registers for the
// amax (a warp shuffle reduction) and the encoding, and writes its 4
// codes as one 4-byte (int8) or 2-byte (packed fp4) store.  Other rows
// take the general path: lanes stride over the row, read it once for the
// amax and once more to encode (the second read hits L1).
//
// Numerics: the scale is __float2bfloat16_rn(amax / 127) (IEEE division,
// round to nearest even) and the encoders divide by the rounded scale; the
// int8 code is rintf (half to even, as jnp.round); the fp4 level is
// floor(log2f(max(y, 2^-7))).  These are the float32 operations of the
// plain version, one for one (bf16 -> float32 is exact), so codes and
// scales agree bitwise.  Must not be built with --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Everything one launch needs: source 0 is K, source 1 is V.
struct KvArgs {
  const void* src[2];
  long long stride[2][3];                    // elements, dims N0, N1, T
  void* codes[2];
  __nv_bfloat16* scales[2];
  const long long* wpos;                     // (N0,) or null
  int n0, n1, t, s, hd;
  long long row0, s_glob;                    // the shard's first row, rows
};

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

__device__ __forceinline__ unsigned int8_code(float x, float safe) {
  return (unsigned)(uint8_t)(int8_t)fminf(fmaxf(rintf(x / safe), -127.f),
                                          127.f);
}

// Four elements of a row from one aligned vector load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

constexpr int kMaxChunks = 4;                // 128-element chunks in registers

template <typename T, bool kFp4, bool kVec>
__global__ void __launch_bounds__(kThreads)
kv_quant_write_kernel(KvArgs a) {
  const int per_src = a.n0 * a.n1 * a.t;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= 2 * per_src) return;              // whole warps leave together
  // K or V: selects, not an index into the parameters (which would copy
  // them to local memory)
  const bool which = r >= per_src;
  const int rest = r - (which ? per_src : 0);
  const int t = rest % a.t;
  const int j = (rest / a.t) % a.n1;
  const int i = rest / (a.t * a.n1);
  const T* row = (const T*)(which ? a.src[1] : a.src[0]) +
                 i * (which ? a.stride[1][0] : a.stride[0][0]) +
                 j * (which ? a.stride[1][1] : a.stride[0][1]) +
                 t * (which ? a.stride[1][2] : a.stride[0][2]);
  void* codes = which ? a.codes[1] : a.codes[0];
  __nv_bfloat16* scales = which ? a.scales[1] : a.scales[0];
  const long long w = a.wpos != nullptr
      ? min(max(a.wpos[i], 0LL), a.s_glob - a.t) : 0LL;
  const long long local = w + t - a.row0;    // the row in this shard
  if (local < 0 || local >= a.s) return;     // held by another rank
  const long long dst = ((long long)i * a.n1 + j) * a.s + local;
  float amax = 0.f;
  float v[kMaxChunks][4];
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = 128 * c + 4 * lane;
      if (e < a.hd) {
        load4(row + e, v[c]);
#pragma unroll
        for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(v[c][k]));
      }
    }
  } else {
    for (int c = lane; c < a.hd; c += 32) {
      amax = fmaxf(amax, fabsf(to_f32(row[c])));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  const __nv_bfloat16 sb = __float2bfloat16_rn(kFp4 ? amax : amax / 127.f);
  const float scale = __bfloat162float(sb);
  const float safe = scale > 0.f ? scale : 1.f;
  if constexpr (kVec && kFp4) {
    uint8_t* out = (uint8_t*)codes + dst * (a.hd / 2);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = 128 * c + 4 * lane;
      if (e < a.hd) {
        const unsigned b0 = fp4_code(v[c][0], safe) |
                            (fp4_code(v[c][1], safe) << 4);
        const unsigned b1 = fp4_code(v[c][2], safe) |
                            (fp4_code(v[c][3], safe) << 4);
        *reinterpret_cast<uint16_t*>(out + e / 2) = (uint16_t)(b0 | (b1 << 8));
      }
    }
  } else if constexpr (kVec) {
    int8_t* out = (int8_t*)codes + dst * a.hd;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = 128 * c + 4 * lane;
      if (e < a.hd) {
        *reinterpret_cast<uint32_t*>(out + e) =
            int8_code(v[c][0], safe) | (int8_code(v[c][1], safe) << 8) |
            (int8_code(v[c][2], safe) << 16) | (int8_code(v[c][3], safe) << 24);
      }
    }
  } else if constexpr (kFp4) {
    uint8_t* out = (uint8_t*)codes + dst * (a.hd / 2);
    for (int c = lane; c < a.hd / 2; c += 32) {
      const unsigned lo = fp4_code(to_f32(row[2 * c]), safe);
      const unsigned hi = fp4_code(to_f32(row[2 * c + 1]), safe);
      out[c] = (uint8_t)(lo | (hi << 4));
    }
  } else {
    int8_t* out = (int8_t*)codes + dst * a.hd;
    for (int c = lane; c < a.hd; c += 32) {
      out[c] = (int8_t)int8_code(to_f32(row[c]), safe);
    }
  }
  if (lane == 0) scales[dst] = sb;
}

template <typename T, bool kFp4>
void launch2(const KvArgs& a, bool vec, dim3 grid, cudaStream_t s) {
  if (vec) {
    kv_quant_write_kernel<T, kFp4, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    kv_quant_write_kernel<T, kFp4, false><<<grid, kThreads, 0, s>>>(a);
  }
}

template <typename T>
void launch(const KvArgs& a, int fp4, cudaStream_t s) {
  const long long rows = 2LL * a.n0 * a.n1 * a.t;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  // the vector path: whole 4-element groups, every row's start aligned
  // for the loads, the codes' rows for the 4- or 2-byte stores
  bool vec = a.hd % 4 == 0 && a.hd <= 128 * kMaxChunks;
  for (int k = 0; k < 2; ++k) {
    vec = vec && (uintptr_t)a.src[k] % (4 * sizeof(T)) == 0 &&
          (uintptr_t)a.codes[k] % 4 == 0;
    for (int d = 0; d < 3; ++d) vec = vec && a.stride[k][d] % 4 == 0;
  }
  if (fp4) {
    launch2<T, true>(a, vec, grid, s);
  } else {
    launch2<T, false>(a, vec, grid, s);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// k, v: (n0, n1, t, hd) float32 (src_bf16 = 0) or bf16 (1), element
// strides k_strides / v_strides (3 each: dims n0, n1, t; the last dim
// contiguous); k_codes, v_codes: (n0, n1, s, hd) int8 (fmt 0) or
// (n0, n1, s, hd / 2) uint8 (fmt 1, hd even); k_scales, v_scales: (n0,
// n1, s) bfloat16; all contiguous.  wpos: (n0,) int64 or null.  The
// codes and scales hold rows row0 .. row0 + s - 1 of a cache of s_glob
// rows (a whole cache: row0 0, s_glob s).  One launch on `stream`;
// returns its cudaError_t.
extern "C" int repro_kv_quant_write(const void* k, const void* v, int src_bf16,
                                    const long long* k_strides,
                                    const long long* v_strides, void* k_codes,
                                    void* v_codes, void* k_scales,
                                    void* v_scales, const void* wpos, int n0,
                                    int n1, int t, int s, int hd, int fmt,
                                    long long row0, long long s_glob,
                                    void* stream) {
  if (n0 < 1 || n1 < 1 || t < 1 || t > s_glob || s < 1 || row0 < 0 ||
      row0 + s > s_glob || hd < 1 || fmt < 0 || fmt > 1 ||
      (fmt == 1 && hd % 2) || 2LL * n0 * n1 * t > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  KvArgs a;
  a.src[0] = k;
  a.src[1] = v;
  for (int d = 0; d < 3; ++d) {
    a.stride[0][d] = k_strides[d];
    a.stride[1][d] = v_strides[d];
  }
  a.codes[0] = k_codes;
  a.codes[1] = v_codes;
  a.scales[0] = (__nv_bfloat16*)k_scales;
  a.scales[1] = (__nv_bfloat16*)v_scales;
  a.wpos = (const long long*)wpos;
  a.n0 = n0;
  a.n1 = n1;
  a.t = t;
  a.s = s;
  a.hd = hd;
  a.row0 = row0;
  a.s_glob = s_glob;
  if (src_bf16) {
    launch<__nv_bfloat16>(a, fmt, (cudaStream_t)stream);
  } else {
    launch<float>(a, fmt, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
