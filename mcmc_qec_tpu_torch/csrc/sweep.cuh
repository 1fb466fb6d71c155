// One proposal of a conflict-free colored Metropolis sweep on a chain held
// as NW-word X/Z bit planes (bit q of X[q / 64] is the X component of qubit
// q), read only on the words its stabilizer's support spans.  Shared by the
// sweep kernel (sweep.cu) and the window kernel (ladder_window.cu).
#pragma once

#include <cstdint>

namespace mqt {

// Word w of a chain's planes, w known only at run time: a select over the
// NW registers (no local-memory array).
template <int NW>
__device__ __forceinline__ uint64_t pick(const uint64_t (&a)[NW], int w) {
  if constexpr (NW == 1) return a[0];  // the word index is 0
  uint64_t v = a[0];
#pragma unroll
  for (int q = 1; q < NW; ++q)
    if (w == q) v = a[q];
  return v;
}

template <int NW>
__device__ __forceinline__ void xor_at(uint64_t (&a)[NW], int w, uint64_t v) {
  if constexpr (NW == 1) {
    a[0] ^= v;
    return;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q)
    if (w == q) a[q] ^= v;
}

// logr of flipping one stabilizer on the planes (X, Z).  ``e`` holds its
// ``S`` (support, X op, Z op) words on the words ``sp`` lists (packed by
// ops/ladder_window.py::_pack_span, zero-padded); the words and the op's
// masks come back in wm, xm, zm for the caller to XOR in if it accepts.
// Equal betas: the total count changes by popc(new OR plane & supp) -
// popc(old OR plane & supp) and logr = -(beta * dN)
// (ops/pallas_ladder.py:440-452, ops/pallas_sweep.py:149-156).  General
// betas: the X and Z totals change by cx - 2 popc(x & xs) and cz - 2 popc(z
// & zs) (cx, cz: the op's qubits in each plane), the Y count by popc(new x
// & new z & supp) - popc(x & z & supp), and logr = -((bx*dN_x + by*dN_y) +
// bz*dN_z), each product and sum rounded on its own (no contraction into a
// fused multiply-add), in the TPU kernels' order; an infinite beta times a
// zero change is NaN, which rejects (ops/pallas_sweep.py:157-169).
template <int NW, int S, bool EQ>
__device__ __forceinline__ float proposal_logr(const uint64_t (&X)[NW], const uint64_t (&Z)[NW],
                                               const uint64_t* e, uint32_t sp, float bx, float by,
                                               float bz, int (&wm)[S], uint64_t (&xm)[S],
                                               uint64_t (&zm)[S]) {
  int d0 = 0, tx = 0, tz = 0;  // dN (equal betas) or dN_y and the overlaps
#pragma unroll
  for (int m = 0; m < S; ++m) {
    wm[m] = (sp >> (12 + 4 * m)) & 15;
    const uint64_t su = e[3 * m];
    xm[m] = e[3 * m + 1];
    zm[m] = e[3 * m + 2];
    const uint64_t x = pick(X, wm[m]), z = pick(Z, wm[m]);
    if constexpr (EQ) {
      d0 += __popcll(((x ^ xm[m]) | (z ^ zm[m])) & su) - __popcll((x | z) & su);
    } else {
      tx += __popcll(x & xm[m]);
      tz += __popcll(z & zm[m]);
      d0 += __popcll((x ^ xm[m]) & (z ^ zm[m]) & su) - __popcll(x & z & su);
    }
  }
  if constexpr (EQ) {
    return -(bx * (float)d0);
  } else {
    const int cx = (int)((sp >> 4) & 15), cz = (int)((sp >> 8) & 15);
    const int d1 = (cx - 2 * tx) - d0, d3 = (cz - 2 * tz) - d0;
    return -__fadd_rn(__fadd_rn(__fmul_rn(bx, (float)d1), __fmul_rn(by, (float)d0)),
                      __fmul_rn(bz, (float)d3));
  }
}

// XOR the op masks a proposal returned into the flip words (fX, fZ).
template <int NW, int S>
__device__ __forceinline__ void add_flip(uint64_t (&fX)[NW], uint64_t (&fZ)[NW],
                                         const int (&wm)[S], const uint64_t (&xm)[S],
                                         const uint64_t (&zm)[S]) {
#pragma unroll
  for (int m = 0; m < S; ++m) {
    xor_at(fX, wm[m], xm[m]);
    xor_at(fZ, wm[m], zm[m]);
  }
}

// Hand every lane of an aligned group of L lanes the XOR of the group's
// flips and apply them.  Every lane of the warp calls this: the shuffles
// run on the whole warp, and offsets below L keep each exchange inside a
// group's lanes (shuffles masked per group let the warp split into one
// group after another).
template <int NW>
__device__ __forceinline__ void apply_flips(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                            uint64_t (&fX)[NW], uint64_t (&fZ)[NW], int L) {
  for (int k = 1; k < L; k <<= 1) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      fX[q] ^= __shfl_xor_sync(0xffffffffu, fX[q], k);
      fZ[q] ^= __shfl_xor_sync(0xffffffffu, fZ[q], k);
    }
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    X[q] ^= fX[q];
    Z[q] ^= fZ[q];
  }
}

}  // namespace mqt
