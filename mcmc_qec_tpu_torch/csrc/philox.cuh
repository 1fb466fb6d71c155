// Philox4x32-10 counter-based generator (Salmon et al., SC'11; constants
// and round structure of Random123's philox4x32_R).  The same function is
// mcmc_qec_tpu_torch/ops/philox.py::philox4x32 in plain torch int64 ops, so
// a kernel and its plain PyTorch version draw identical bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mqt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 24-bit uniform in (0, 1): u = (bits >> 8) * 2^-24 + 1e-12, as the TPU
// kernel draws it (ops/pallas_ladder.py:408-417).  The product is exact, so
// a fused multiply-add rounds the same as the separate operations.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-8f + 1e-12f;
}

// The draws of one (window seed, syndrome row, step, use): element e is
// word e % 4 of Philox4x32-10 at counter (e / 4, use, step, row) under key
// (seed low, seed high).  Distinct (step, use, element) never share a
// counter.  Consecutive elements reuse the block of four.  Fixed mode makes
// every draw the word ``fixed_word`` (0 is what the Pallas TPU interpreter's
// stubbed PRNG returns; the parity tests stub it with other constants too);
// it is decided where a block is drawn, once per four elements, as the
// Philox call is.
struct DrawStream {
  uint32_t k0, k1, use, step, row;
  bool fixed;
  uint32_t fixed_word;
  int group;
  uint4 cur;

  __device__ __forceinline__ DrawStream(uint32_t k0_, uint32_t k1_, uint32_t use_,
                                        uint32_t step_, uint32_t row_, bool fixed_,
                                        uint32_t fixed_word_ = 0u)
      : k0(k0_), k1(k1_), use(use_), step(step_), row(row_), fixed(fixed_),
        fixed_word(fixed_word_), group(-1), cur(make_uint4(0u, 0u, 0u, 0u)) {}

  __device__ __forceinline__ uint32_t operator()(int e) {
    const int g = e >> 2;
    if (g != group) {
      group = g;
      cur = fixed ? make_uint4(fixed_word, fixed_word, fixed_word, fixed_word)
                  : philox4x32_10(make_uint4((uint32_t)g, use, step, row), k0, k1);
    }
    return word_of(cur, e & 3);
  }
};

}  // namespace mqt
