// One color of a conflict-free colored Metropolis sweep on one chain held
// as NW-word X/Z bit planes (bit q of X[q / 64] is the X component of
// qubit q).  Shared by the ladder-window kernel and, later, the standalone
// sweep kernel that replaces ops/pallas_sweep.py::make_pallas_sweep.
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
// ops/pallas_ladder.py:440-452).  Draw j of ``rng`` is the stabilizer's
// uniform.
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

}  // namespace mqt
