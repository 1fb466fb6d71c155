// One proposal of a conflict-free colored Metropolis sweep, in two forms
// shared by the sweep kernel (sweep.cu) and the window kernel
// (ladder_window.cu).  The register forms hold a chain as X/Z bit planes
// (bit q of X[q / 64] is the X component of qubit q) in NW registers and
// read a proposal on the words its stabilizer's support spans.  The large
// variants hold a chain in shared memory at 2 bits a qubit and read a
// proposal from its qubit-table entry (entry_*, load_block below).
#pragma once

#include <cstdint>

#include "philox.cuh"

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

// One spanned word of a proposal: the counts logr is made of, for equal
// betas dN, for general betas dN_y and the overlaps of x and z with the op.
template <bool EQ>
__device__ __forceinline__ void add_word(uint64_t x, uint64_t z, uint64_t su, uint64_t xm,
                                         uint64_t zm, int& d0, int& tx, int& tz) {
  if constexpr (EQ) {
    d0 += __popcll(((x ^ xm) | (z ^ zm)) & su) - __popcll((x | z) & su);
  } else {
    tx += __popcll(x & xm);
    tz += __popcll(z & zm);
    d0 += __popcll((x ^ xm) & (z ^ zm) & su) - __popcll(x & z & su);
  }
}

template <bool EQ>
__device__ __forceinline__ float logr_of(int d0, int tx, int tz, uint32_t sp, float bx, float by,
                                         float bz) {
  if constexpr (EQ) {
    return -(bx * (float)d0);
  } else {
    const int cx = (int)((sp >> 4) & 15), cz = (int)((sp >> 8) & 15);
    const int d1 = (cx - 2 * tx) - d0, d3 = (cz - 2 * tz) - d0;
    return -__fadd_rn(__fadd_rn(__fmul_rn(bx, (float)d1), __fmul_rn(by, (float)d0)),
                      __fmul_rn(bz, (float)d3));
  }
}

// logr of flipping one stabilizer on the planes (X, Z).  ``e`` holds its
// ``S`` (support, X op, Z op) words on the words ``sp`` lists (packed by
// ops/kernel_tables.py::_pack_span, zero-padded); the words and the op's
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
  int d0 = 0, tx = 0, tz = 0;
#pragma unroll
  for (int m = 0; m < S; ++m) {
    wm[m] = (sp >> (12 + 4 * m)) & 15;
    xm[m] = e[3 * m + 1];
    zm[m] = e[3 * m + 2];
    add_word<EQ>(pick(X, wm[m]), pick(Z, wm[m]), e[3 * m], xm[m], zm[m], d0, tx, tz);
  }
  return logr_of<EQ>(d0, tx, tz, sp, bx, by, bz);
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

// ---------------------------------------------------------------------------
// The large variants: a chain at 2 bits a qubit in shared memory
// ---------------------------------------------------------------------------

// Qubit k (0-3) of a qubit-table entry and the 2-bit ops of all four
// (ops/kernel_tables.py::qubit_table): qubit k in bits 14k..14k+13, its op
// (x | z << 1, 0 for no qubit) in bits 56 + 2k and 57 + 2k.
__device__ __forceinline__ int entry_qubit(uint64_t e, int k) {
  return (int)((e >> (14 * k)) & 0x3FFFu);
}

__device__ __forceinline__ uint32_t entry_ops(uint64_t e) { return (uint32_t)(e >> 56); }

// The 2-bit states (x | z << 1) of an entry's four qubits in a slot ``W``
// (qubit q in bits 2 (q % 16) and 2 (q % 16) + 1 of word q / 16), packed as
// the ops are: one 32-bit load a qubit, none of them waiting on another.
// A missing qubit reads qubit 0; its op is 0, so it changes no count.
__device__ __forceinline__ uint32_t entry_states(const uint32_t* W, uint64_t e) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = entry_qubit(e, k);
    s |= ((W[q >> 4] >> ((q & 15) << 1)) & 3u) << (2 * k);
  }
  return s;
}

// logr of flipping a stabilizer whose qubits are in states ``s`` under ops
// ``o`` (both packed 2 bits a qubit): the integers of add_word and logr_of,
// counted on the stabilizer's qubits instead of its spanned words.  Equal
// betas: dN = (qubits in error after) - (before).  General betas: tx, tz
// the overlaps of x and z with the op's X and Z parts, dN_y the Y count's
// change, cx, cz the op's X and Z qubits; the same expression, rounded
// alike.
template <bool EQ>
__device__ __forceinline__ float entry_logr(uint32_t s, uint32_t o, float bx, float by,
                                            float bz) {
  const uint32_t ns = s ^ o;
  if constexpr (EQ) {
    const int d0 = __popc((ns | (ns >> 1)) & 0x55u) - __popc((s | (s >> 1)) & 0x55u);
    return -(bx * (float)d0);
  } else {
    const int tx = __popc(s & o & 0x55u), tz = __popc(s & o & 0xAAu);
    const int d0 = __popc(ns & (ns >> 1) & 0x55u) - __popc(s & (s >> 1) & 0x55u);
    const int d1 = (__popc(o & 0x55u) - 2 * tx) - d0, d3 = (__popc(o & 0xAAu) - 2 * tz) - d0;
    return -__fadd_rn(__fadd_rn(__fmul_rn(bx, (float)d1), __fmul_rn(by, (float)d0)),
                      __fmul_rn(bz, (float)d3));
  }
}

// XOR an accepted entry's ops into the slot: one 32-bit shared atomic a
// qubit (ATOMS.XOR; lanes of a chain may flip other bits of the word).
__device__ __forceinline__ void entry_flip(uint32_t* W, uint64_t e) {
  const uint32_t o = entry_ops(e);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t ok = (o >> (2 * k)) & 3u;
    if (ok) {
      const int q = entry_qubit(e, k);
      atomicXor(W + (q >> 4), ok << ((q & 15) << 1));
    }
  }
}

// The states and ops of Philox block g of a color (stabilizers c0 + 4g ..
// c0 + 4g + 3; past the color's n an empty entry), stabilizer e's 8 bits at
// bits 8e of each: two registers a block, so a lane holds the next block's
// beside the current one within 64 registers.
__device__ __forceinline__ void load_block(const uint32_t* W, const uint64_t* qtab, int c0, int n,
                                           int g, uint32_t& st, uint32_t& ops) {
  st = ops = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint64_t ent = 4 * g + e < n ? qtab[c0 + 4 * g + e] : 0ull;
    st |= entry_states(W, ent) << (8 * e);
    ops |= entry_ops(ent) << (8 * e);
  }
}

// Which of a block's four stabilizers accept (bit e for stabilizer e), on
// the states and ops load_block packed and the block's Philox words ``v``.
// Every uniform is < 1, so log u < 0 and logr >= 0 accepts without the
// logarithm: the plain version's comparison decides alike.
template <bool EQ>
__device__ __forceinline__ unsigned block_accepts(uint32_t st, uint32_t ops, uint4 v, float bx,
                                                  float by, float bz) {
  unsigned acc = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float logr =
        entry_logr<EQ>((st >> (8 * e)) & 255u, (ops >> (8 * e)) & 255u, bx, by, bz);
    if (logr >= 0.f || logf(uniform24(word_of(v, e))) < logr) acc |= 1u << e;
  }
  return acc;
}

// Bit i of x to bit 2i, and back.
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__device__ __forceinline__ uint32_t compact16(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0xFFFFu;
}

}  // namespace mqt
