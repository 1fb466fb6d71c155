// One color of a conflict-free colored Metropolis sweep on one chain held
// as NW-word X/Z bit planes (bit q of X[q / 64] is the X component of
// qubit q).  The sweep kernel sweep.cu's, in both acceptance forms (the
// window kernel decides a color across lanes instead: ladder_window.cu).
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace mqt {

// ``stab`` holds the color's ``n`` stabilizers, each as three NW-word masks:
// support, X component of its op, Z component of its op.  Stabilizers of one
// color share no qubit, so visiting them one after another equals the TPU
// kernel's parallel accept of the whole color.  A flip changes the total
// error count by popc(new OR plane & supp) - popc(old OR plane & supp); it is
// accepted iff logf(u) < -(beta * dN) in f32 (equal per-Pauli betas,
// ops/pallas_ladder.py:440-452, ops/pallas_sweep.py:149-156).  Draw j of
// ``rng`` is the stabilizer's uniform.
template <int NW>
__device__ __forceinline__ void sweep_color(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                            const uint64_t* stab, int n, float beta,
                                            DrawStream& rng) {
  for (int j = 0; j < n; ++j) {
    const uint64_t* e = stab + 3 * NW * j;
    int dn = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint64_t s = e[w], xs = e[NW + w], zs = e[2 * NW + w];
      dn += __popcll(((X[w] ^ xs) | (Z[w] ^ zs)) & s) - __popcll((X[w] | Z[w]) & s);
    }
    const uint32_t bits = rng(j);
    const float logr = -(beta * (float)dn);
    // every uniform is < 1, so logf(u) < 0 and logr >= 0 accepts without
    // the logarithm: the same decision as the plain version's comparison
    if (logr >= 0.f || logf(uniform24(bits)) < logr) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        X[w] ^= e[NW + w];
        Z[w] ^= e[2 * NW + w];
      }
    }
  }
}

// The same color with general per-Pauli betas (ops/pallas_sweep.py:157-169):
// per stabilizer the changes dN_x, dN_y, dN_z of the X-only, Y and Z-only
// counts on its support, and logr = -((bx*dN_x + by*dN_y) + bz*dN_z) in f32
// with every product and sum rounded on its own (no contraction into a
// fused multiply-add), in the TPU kernel's order.  IEEE rules hold: an
// infinite beta times a zero change is NaN, and a NaN logr rejects (both
// comparisons are false), as in the TPU kernel.
template <int NW>
__device__ __forceinline__ void sweep_color_xyz(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                                const uint64_t* stab, int n, float bx,
                                                float by, float bz, DrawStream& rng) {
  for (int j = 0; j < n; ++j) {
    const uint64_t* e = stab + 3 * NW * j;
    int d1 = 0, d2 = 0, d3 = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint64_t s = e[w], x = X[w], z = Z[w];
      const uint64_t nx = x ^ e[NW + w], nz = z ^ e[2 * NW + w];
      d1 += __popcll(nx & ~nz & s) - __popcll(x & ~z & s);
      d2 += __popcll(nx & nz & s) - __popcll(x & z & s);
      d3 += __popcll(~nx & nz & s) - __popcll(~x & z & s);
    }
    const uint32_t bits = rng(j);
    const float logr = -__fadd_rn(__fadd_rn(__fmul_rn(bx, (float)d1), __fmul_rn(by, (float)d2)),
                                  __fmul_rn(bz, (float)d3));
    if (logr >= 0.f || logf(uniform24(bits)) < logr) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        X[w] ^= e[NW + w];
        Z[w] ^= e[2 * NW + w];
      }
    }
  }
}

}  // namespace mqt
