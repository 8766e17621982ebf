// Fused ghost norm for Hopper (sm_90a): LUQ-FP4 quantize + two Grams +
// their inner product, per example, the Grams on bf16 tensor cores.
//
// Replaces the Pallas TPU kernel `ghost_norm_gram` (src/repro/kernels/
// ghost_norm.py, `_ghost_norm_kernel`).  For each example b, with x_b
// (T, Dx) the wgrad GEMM's input rows and g_b (T, Dg) its cotangent rows:
//
//     out[b] = sum_ij (Q(x_b) Q(x_b)^T)_ij * (Q(g_b) Q(g_b)^T)_ij
//            = || Q(x_b)^T Q(g_b) ||_F^2
//
// the per-example squared weight-gradient norm of ghost clipping (the
// Gram route of the mixed ghost norm).  Q is LUQ-FP4 with per-example
// scales alpha = max|x_b|, max|g_b| and the Philox draws of the keys kx,
// kg shared by the examples (luq_quant.cu's stream: the draws fake-quant's
// wgrad folds 4 and 5 make for one example).  x and g are read in their
// own type, float32 or bf16.
//
// What bounds it on this card: bytes.  At stablelm-3b's pass-1 shapes (4
// examples of 256 x 2560 / 6912, bf16) the operands are 13 / 24.4 MB,
// read twice by the quantizer (4 / 7 us at 3.35 TB/s each read), its
// codes 13 / 24.4 MB written and read once; the Grams' upper triangles
// are 1.35 / 2.49 GFLOP, 1.4 / 2.5 us on the bf16 tensor cores.  A design
// before this one ran both whole Grams as float32 SIMT FMAs over float32
// copies of the quantized operands, 64 blocks of 64 x 64 tiles on 132 SMs,
// and lost to two float32 cuBLAS Grams by 2-2.7x.
//
// Design.  Q(v) = alpha * c with the code c = sign * 2^-k (or 0), which
// bf16 holds exactly, so
//
//     out[b] = (alpha_x alpha_g)^2 * sum_ij (Cx Cx^T)_ij (Cg Cg^T)_ij
//
// and the Grams of the codes can run on the tensor cores: each product
// of two codes is a power of two, exact, summed in float32.  Six
// launches on one stream:
//
//   1-4. repro_luq_quant (luq_quant.cu, linked into the same library),
//      its two passes for each operand with the code output: the row
//      maxima, then Cx, Cg once into bf16 scratch (one row per example,
//      the keys' shared draw), half the bytes of float32 values, and the
//      alphas into scratch.  Same rounding as every other quantizer.
//   5. gram_tiles: block (p, b) owns upper-triangle tile p = (ti <= tj) of
//      32 x 32 of both Grams of example b: T = 256 gives 36 tiles, 144
//      blocks at B = 4 (the previous 64 x 64 tiling had 10 upper tiles,
//      40 blocks).  The block's 8 warps split D in 32-column chunks; a
//      warp computes the whole 32 x 32 tile over its chunks with
//      mma.sync.m16n8k16 (bf16 in, float32 sums), its fragments loaded
//      straight from global memory as one 16-byte load per thread and
//      row (a Gram sums over d in any order, so the fragments' k slots
//      take the 8 consecutive columns a thread loads); on a diagonal
//      tile the A rows serve as the B rows.  Each mma sums its 16 exact
//      products from zero, and the warp adds the result to its float32
//      tile with IEEE adds (see mma_bf16).  The warps' tiles are added in
//      shared memory in a fixed order, first for Cx (into registers), then
//      for Cg, and the tile's sum of XX o GG is reduced in a fixed order,
//      doubled off the diagonal (exact), to one partial;
//   6. sum_partials: each example's partials added in order, scaled by
//      (alpha_x alpha_g)^2 in float32, the alphas those the quantize
//      passes took.
//
// A shard of the examples' rows (an operand split over the model group:
// the cotangent of a column-parallel projection, the input of a
// row-parallel one) comes with its rows' alphas, the max over the ranks,
// and its index map (repro_ghost_norm_mapped): its quantize pass is then
// repro_luq_round alone, each element drawing at its index in the whole
// row, and the result is this rank's part of the whole norm, since the
// Gram identity adds over a split dim.
//
// No atomics: the same input gives the same bits on every run.  No limit
// on T (the TPU wrapper's T <= 512 cap existed for VMEM only).  An
// all-zero example has codes 0 and alpha 0: exactly 0.
//
// The DPQuant policy flag.  An optional `flag` (one float32 in device
// memory, the layer's entry of the trainer's flags tensor) goes to both
// quantize calls.  With the flag at 0 they skip the LUQ rounding and
// write the operands themselves as the "codes", cast to bf16, with alpha
// 1, and the same launches give the squared norm of the unquantized
// x_b^T g_b: exact products of bf16 operands, summed in float32 (a
// float32 operand is rounded to bf16).  One CUDA graph of a ghost step
// launches this kernel for every layer whatever the flag; dp/ghost.py
// keeps the norm of a layer that is off from the float32 Grams a
// host-bool policy takes (torch.where), whose bits this sum does not
// give.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" long long repro_luq_quant_scratch(int rows, long long n);
extern "C" int repro_luq_quant(const void* x, int x_bf16, void* out,
                               int codes, int rows, long long n, uint32_t k0,
                               uint32_t k1, void* scratch, void* alpha_out,
                               const void* flag, void* stream);
extern "C" int repro_luq_round(const void* x, int x_bf16, void* out,
                               int codes, int rows, long long n, uint32_t k0,
                               uint32_t k1, const void* alpha_in,
                               void* alpha_out, long long blk, long long gblk,
                               long long off, const void* flag, void* stream);

namespace {

constexpr int kTile = 32;                    // Gram tile edge
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;                   // columns a warp takes a step
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Columns d .. d + 7 of `row` of the (T, D) codes q as 4 words of two
// bf16 (lower column in the lower half), zeros outside the matrix.
// kVec: D % 8 == 0, so d % 8 == 0 keeps the load 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ q,
                                       int row, int d, int T, int D) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= T || d >= D) return v;
  const __nv_bfloat16* p = q + (size_t)row * D + d;
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (d + j < D) w[j / 2] |= (uint32_t)__ldg(h + j) << (16 * (j % 2));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// c += A B for one m16n8k16 step of bf16 codes.  The tensor core sums the
// 16 products from zero (each a power of two in [2^-12, 1] or 0: the sum
// is a multiple of 2^-12 below 16, exact in float32 whatever the unit's
// internal rounding), and the step's sum is added to c with an IEEE float32
// add, so the tile is a float32 sum of exact terms however the unit rounds
// its own accumulator.  (On an H100 at the path's shapes, chaining the
// steps through the unit's accumulator gave the same bits.)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
  c[0] += d0;
  c[1] += d1;
  c[2] += d2;
  c[3] += d3;
}

// This warp's share of the 32 x 32 tile (i0, j0) of q q^T over the
// 32-column chunks warp, warp + kWarps, ... of D.  Thread (g, t) = (lane /
// 4, lane % 4) loads columns d0 + 8 t .. d0 + 8 t + 7 of rows g + 8 m, m =
// 0..3, of both row blocks; k slots 2t, 2t + 1, 2t + 8, 2t + 9 of the
// mma's k-half h are columns d0 + 8 t + 4 h + 0..3, the same map for A
// and B.  acc[mt][nt] is the m16n8 fragment of rows 16 mt.., columns 8 nt..
template <bool kVec>
__device__ __forceinline__ void gram_tile_warp(
    const __nv_bfloat16* __restrict__ q, int T, int D, int i0, int j0,
    float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool diag = i0 == j0;
#pragma unroll 2
  for (int d0 = warp * kChunk; d0 < D; d0 += kWarps * kChunk) {
    const int d = d0 + 8 * t;
    uint4 ra[4], rb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) ra[m] = load8<kVec>(q, i0 + g + 8 * m, d, T, D);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      rb[m] = diag ? ra[m] : load8<kVec>(q, j0 + g + 8 * m, d, T, D);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(acc[mt][nt], word(ra[2 * mt], 2 * h),
                   word(ra[2 * mt + 1], 2 * h), word(ra[2 * mt], 2 * h + 1),
                   word(ra[2 * mt + 1], 2 * h + 1), word(rb[nt], 2 * h),
                   word(rb[nt], 2 * h + 1));
        }
      }
    }
  }
}

// The warps' tiles of q q^T added in a fixed order; element e = tid + s
// kThreads of the row-major 32 x 32 tile lands in out[s].
template <bool kVec>
__device__ __forceinline__ void gram_tile(const __nv_bfloat16* __restrict__ q,
                                          int T, int D, int i0, int j0,
                                          float (*red)[kTile * kTile],
                                          float (&out)[4]) {
  float acc[2][4][4] = {};
  gram_tile_warp<kVec>(q, T, D, i0, j0, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = 16 * mt + g + 8 * (c / 2);
        const int col = 8 * nt + 2 * t + (c % 2);
        red[warp][row * kTile + col] = acc[mt][nt][c];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kTile * kTile / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    float v = red[0][e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][e];
    out[s] = v;
  }
  __syncthreads();
}

// partial[b, p] = (1 or 2) * sum over upper tile p of (Cx Cx^T) o (Cg Cg^T).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gram_tiles_kernel(const __nv_bfloat16* __restrict__ cx,
                  const __nv_bfloat16* __restrict__ cg,
                  float* __restrict__ partial, int B, int T, int Dx, int Dg,
                  int nt) {
  __shared__ float red[kWarps][kTile * kTile];
  __shared__ float warp_part[kWarps];
  const int P = gridDim.x;
  // upper tile p -> (ti, tj), ti <= tj, row by row
  int ti = 0, rest = blockIdx.x;
  while (rest >= nt - ti) {
    rest -= nt - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const int i0 = ti * kTile, j0 = tj * kTile;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float xx[kTile * kTile / kThreads], gg[kTile * kTile / kThreads];
    gram_tile<kVec>(cx + (size_t)b * T * Dx, T, Dx, i0, j0, red, xx);
    gram_tile<kVec>(cg + (size_t)b * T * Dg, T, Dg, i0, j0, red, gg);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kTile * kTile / kThreads; ++i) {
      s = fmaf(xx[i], gg[i], s);
    }
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += warp_part[w];
      partial[(size_t)b * P + blockIdx.x] = ti == tj ? v : 2.f * v;
    }
    __syncthreads();
  }
}

// out[b] = (ax[b] ag[b])^2 * (sum of example b's P partials, in order).
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ ax,
                                    const float* __restrict__ ag,
                                    float* __restrict__ out, int B, int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(size_t)b * P + p];
  const float scale = ax[b] * ag[b];
  out[b] = scale * scale * s;
}

// A region's size rounded up to 16 bytes, so that every region of the
// carved scratch starts 16-byte aligned.
long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// The regions of the scratch, in order: the bf16 codes Cx, Cg; the
// partials; alpha_x, alpha_g; the quantizer's partial maxima of x, of g.
struct Scratch {
  long long off[7];
  long long total;
};

Scratch carve(int B, int T, int Dx, int Dg, int P) {
  const long long nx = (long long)T * Dx, ng = (long long)T * Dg;
  const long long sizes[7] = {
      align16(2 * B * nx), align16(2 * B * ng), align16(4LL * B * P),
      align16(4LL * B), align16(4LL * B),
      align16(4 * repro_luq_quant_scratch(B, nx)),
      align16(4 * repro_luq_quant_scratch(B, ng))};
  Scratch sc;
  long long at = 0;
  for (int i = 0; i < 7; ++i) {
    sc.off[i] = at;
    at += sizes[i];
  }
  sc.total = at;
  return sc;
}

}  // namespace

// Number of partials per example (upper 32 x 32 tiles of a T x T Gram).
extern "C" int repro_ghost_norm_partials(int T) {
  const int nt = (T + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

// Bytes of scratch repro_ghost_norm needs for (B, T, Dx, Dg).
extern "C" long long repro_ghost_norm_scratch(int B, int T, int Dx, int Dg) {
  return carve(B, T, Dx, Dg, repro_ghost_norm_partials(T)).total;
}

// x: (B, T, Dx); g: (B, T, Dg); each float32 or bf16 (x_bf16, g_bf16),
// contiguous; (kx0, kx1), (kg0, kg1): the Philox keys of their draws;
// scratch: repro_ghost_norm_scratch(B, T, Dx, Dg) bytes, 16-byte aligned;
// out: (B,) float32; flag: one float32 (0: the operands unquantized) or
// null (always quantize).  All on the device.  Returns the cudaError_t of
// the launches.
namespace {

// One operand's codes and alphas: both passes of repro_luq_quant, or, with
// its alphas given, repro_luq_round under its index map.
int quantize_operand(const void* v, int v_bf16, __nv_bfloat16* codes, int B,
                     long long n, uint32_t k0, uint32_t k1, void* part,
                     float* alpha, const float* alpha_in, long long blk,
                     long long gblk, long long off, const void* flag,
                     cudaStream_t s) {
  if (alpha_in == nullptr) {
    return repro_luq_quant(v, v_bf16, codes, 1, B, n, k0, k1, part, alpha,
                           flag, (void*)s);
  }
  return repro_luq_round(v, v_bf16, codes, 1, B, n, k0, k1, alpha_in, alpha,
                         blk, gblk, off, flag, (void*)s);
}

}  // namespace

// repro_ghost_norm with either operand a shard of the examples' rows:
// alpha_x / alpha_g (B,) float32, its rows' alphas over every rank (null:
// the operand is whole, its alphas taken here), and its index map
// (blk, gblk, off) as repro_luq_round takes it.
extern "C" int repro_ghost_norm_mapped(
    const void* x, int x_bf16, const void* g, int g_bf16, uint32_t kx0,
    uint32_t kx1, uint32_t kg0, uint32_t kg1, void* scratch, void* out, int B,
    int T, int Dx, int Dg, const void* flag, const void* alpha_x,
    long long bx, long long gx, long long ox, const void* alpha_g,
    long long bg, long long gg, long long og, void* stream) {
  if (B < 1 || T < 1 || Dx < 1 || Dg < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)scratch & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int nt = (T + kTile - 1) / kTile;
  const int P = repro_ghost_norm_partials(T);
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const Scratch sc = carve(B, T, Dx, Dg, P);
  char* base = (char*)scratch;
  auto* qx = (__nv_bfloat16*)(base + sc.off[0]);
  auto* qg = (__nv_bfloat16*)(base + sc.off[1]);
  auto* partial = (float*)(base + sc.off[2]);
  auto* ax = (float*)(base + sc.off[3]);
  auto* ag = (float*)(base + sc.off[4]);
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = quantize_operand(x, x_bf16, qx, B, (long long)T * Dx, kx0, kx1,
                            base + sc.off[5], ax, (const float*)alpha_x, bx,
                            gx, ox, flag, s);
  if (rc != (int)cudaSuccess) return rc;
  rc = quantize_operand(g, g_bf16, qg, B, (long long)T * Dg, kg0, kg1,
                        base + sc.off[6], ag, (const float*)alpha_g, bg, gg,
                        og, flag, s);
  if (rc != (int)cudaSuccess) return rc;
  const dim3 grid(P, B < kMaxGridY ? B : kMaxGridY);
  if (Dx % 8 == 0 && Dg % 8 == 0) {
    gram_tiles_kernel<true><<<grid, kThreads, 0, s>>>(qx, qg, partial, B, T,
                                                      Dx, Dg, nt);
  } else {
    gram_tiles_kernel<false><<<grid, kThreads, 0, s>>>(qx, qg, partial, B, T,
                                                       Dx, Dg, nt);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(B + 127) / 128, 128, 0, s>>>(partial, ax, ag,
                                                      (float*)out, B, P);
  return (int)cudaGetLastError();
}

extern "C" int repro_ghost_norm(const void* x, int x_bf16, const void* g,
                                int g_bf16, uint32_t kx0, uint32_t kx1,
                                uint32_t kg0, uint32_t kg1, void* scratch,
                                void* out, int B, int T, int Dx, int Dg,
                                const void* flag, void* stream) {
  return repro_ghost_norm_mapped(x, x_bf16, g, g_bf16, kx0, kx1, kg0, kg1,
                                 scratch, out, B, T, Dx, Dg, flag, nullptr, 0,
                                 0, 0, nullptr, 0, 0, 0, stream);
}
