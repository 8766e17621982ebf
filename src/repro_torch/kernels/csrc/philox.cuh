// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the generator of Random123 and of cuRAND's Philox), the
// counter-based generator the kernels draw their uniforms with.  Its plain
// PyTorch twin is repro_torch.quant.philox, which gives the same words on
// CPU and CUDA tensors.
//
// Key: two 32-bit words.  Counter: four.  Ten rounds, each two 32x32->64
// multiplies and four XORs, the key bumped by the Weyl constants between
// rounds.  Stream layout used by every caller: element e of operand `op`
// (0 for a matmul's a, 1 for its b) takes lane e % 4 of the call with
// counter (e / 4 low word, e / 4 high word, op, 0), and its uniform is
// (word >> 8) * 2^-24, exact in float32, in [0, 1 - 2^-24].
//
// Host and device: the functions compile for both, so the arithmetic can
// be checked on a CPU against the published known-answer vectors.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define REPRO_HD __host__ __device__ __forceinline__
#else
#define REPRO_HD inline
#endif

namespace repro_philox {

constexpr uint32_t kM0 = 0xD2511F53u;        // multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;        // Weyl key bumps
constexpr uint32_t kW1 = 0xBB67AE85u;

struct Words {
  uint32_t w[4];
};

// The key of each of the 10 rounds: the key, then bumped by the Weyl
// constants.  A kernel draws with them precomputed (in its parameters)
// instead of bumping the key every call.
struct RoundKeys {
  uint32_t k[10][2];
};

REPRO_HD RoundKeys philox_round_keys(uint32_t k0, uint32_t k1) {
  RoundKeys rk;
  for (int i = 0; i < 10; ++i) {
    rk.k[i][0] = k0;
    rk.k[i][1] = k1;
    k0 += kW0;
    k1 += kW1;
  }
  return rk;
}

REPRO_HD Words philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                             uint32_t c3, const RoundKeys& rk) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t p0 = (uint64_t)kM0 * c0;
    const uint64_t p1 = (uint64_t)kM1 * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ rk.k[i][0];
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ rk.k[i][1];
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
  }
  Words out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// The four words of elements 4 g .. 4 g + 3 of operand `op`.
REPRO_HD Words philox_group(uint64_t g, uint32_t op, const RoundKeys& rk) {
  return philox4x32_10((uint32_t)g, (uint32_t)(g >> 32), op, 0u, rk);
}

// The uniform of a word: its top 24 bits m, times 2^-24.
REPRO_HD float uniform24(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace repro_philox
