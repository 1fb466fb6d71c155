// Colored Metropolis sweeps over a batch of independent chains, on Hopper
// (sm_90a), in one launch: either a counting decoder's whole sampling loop
// with its recording, or ``n_sweeps`` sweeps with states in and states out.
//
// Replaces mcmc_qec_tpu/ops/pallas_sweep.py::make_pallas_sweep (the Pallas
// TPU kernel K1), both branches: equal per-Pauli betas (acceptance on the
// total error-count change) and general per-Pauli betas.  Per chain, per
// sweep, per color: every stabilizer of the color proposes its flip, the
// change in error count decides against a uniform, and the accepted flips
// are XORed in.  With recording (the template's REC, the counting
// decoders' sampler, decoders/counting.py::make_sampler) the launch runs
// ``steps`` steps of ``iters`` sweeps each and writes, after every step,
// the chain's content key (ops/pauli.py::pack_key's two 32-bit hashes) and
// its X, Y and Z counts, as the JAX package's ``lax.scan`` around the
// Pallas call records them.  The plain PyTorch versions are
// ops/sweep.py::sweep_reference and ::sample_reference; every version draws
// the same Philox4x32-10 bits (layout in the ops/sweep.py docstring), so
// they agree trajectory for trajectory.  The betas are one (3,) row for the
// launch (the counting decoders) or one row per chain (the PT ladder step of
// mcmc/ladder.py, where each chain runs at its rung's temperature: PTDC,
// PTRC, the unfused PTEQ window, ops/dense_sweep.py::make_dense_sweep).
//
// What bounds it on this card: at the counting decoders' main path (65,536
// chains of toric d=5, 450 steps of one sweep) the proposals' popcounts
// (1.47e9 proposals, two 64-bit popcounts each on the one word a
// stabilizer spans), then the Philox blocks (one per four stabilizers);
// the recorded stream (16 bytes of key and 12 of counts per chain and
// step, 826 MB) takes a sixth of that time at the memory's rate.  The one-
// launch-per-step loop this replaces paid a fixed ~20 us per launch (table
// and state staging, one thread packing bytes) and ran the recording as
// separate torch kernels over a 52 MB product per step.  The design:
//   - One launch for the whole loop: a chain is unpacked from its u8 row
//     once (coalesced copies through shared memory), stays in registers
//     for every step, and is packed once at the end.
//   - L lanes per chain, 32 / L chains per warp.  A color is decided at
//     once on the planes as they stood before it: lane l draws the color's
//     blocks g = l, l + L, ... and decides their four stabilizers each, and
//     a whole-warp XOR butterfly hands every lane the color's flips
//     (sweep.cuh).  Stabilizers of one color share no qubit, so this equals
//     the sequential visit, and a lane's proposals no longer wait on each
//     other's flips.  L (ops/sweep.py::lanes_per_chain) is a power of two,
//     up to one lane per Philox block of the widest color (4 at toric d=5)
//     for a small batch, and fewer once the batch fills the card: more
//     lanes hide latency on an idle card, fewer issue fewer instructions
//     (no idle lanes in the small colors, no butterflies); at the main
//     path's 65,536 chains one lane per chain is fastest.
//   - Only the words a stabilizer spans (the spanned-word table of
//     ops/kernel_tables.py::kernel_tables): two popcounts a word with equal
//     betas, four with general betas; up to 16 words per plane (toric d=21,
//     rotated and XZZX d=31) in registers, the template's NW.
//   - The recording on the chip: each lane sums m_q * v_q over its share
//     of the qubits (v = (x ^ z) + 2z, wraparound u32) and popcounts its
//     share of the words for the counts (packed 10 bits each), one warp
//     butterfly adds the lanes' parts, and lane 0 of each chain stages the
//     step in shared memory; every ``tile_steps`` steps the warp stores its
//     chains' tiles as contiguous rows of the (B, steps, 2) int64 keys and
//     (B, steps, 3) int32 counts the reduction reads.
//   - Above 16 words (the large variant, sweep_kernel_wide<EQ, REC>, up to
//     256 words or 16,384 qubits) the planes do not fit in registers and
//     the word count is a run-time value.  What keeps a kernel of this
//     shape from the bound is latency: with the chain in shared memory, a
//     lane that decides its proposals one after another waits on each
//     decision's loads and an accept's atomics, and a recording that walks
//     every qubit after every step costs as much as the sweeps.  The
//     design, K2's large variant's (ladder_window.cu):
//       * 2 bits a qubit.  Each chain sits in a slot of its warp's shared
//         memory, 16 qubits a 32-bit word (4 nw + 1 words with a padding
//         word).  A stabilizer is one 64-bit qubit-table entry
//         (ops/kernel_tables.py::qubit_table), so a proposal is one entry
//         and four 32-bit loads, and its count changes a few popcounts of
//         its qubits' 8 bits: the register form's integers, so the same
//         logr and decision (entry_logr, sweep.cuh).
//       * Decide, then apply.  A lane takes whole Philox blocks of a color
//         (g = l, l + L, ...; the register form's counters, the same
//         logf), issues its next block's loads before it decides the
//         current one, then XORs the accepted flips in, one 32-bit shared
//         atomic (ATOMS.XOR) a qubit.  A color's supports are disjoint and
//         a decision reads only its own qubits, so every order decides as
//         the slot before the color does; a __syncwarp closes the color.
//       * The recording kept up to date flip by flip.  pack_key is a
//         wraparound u32 sum and the counts are integers, so the unpack
//         computes each chain's hashes and counts once, and the lane that
//         flips a qubit adds m_q * (v_new - v_old) and the count changes
//         to its share; a step's record is the butterfly sum of the
//         chain's shares, with no pass over the qubits.
//       * A full SM in whole waves.  Up to 1024 threads a block at 64
//         registers a thread (its own launch bounds).  The chains an SM's
//         shared memory holds fix how many run at once, so the batch is
//         spread over the SMs in whole waves and lanes per chain are what
//         it takes to reach about 32 warps an SM
//         (ops/sweep.py::wide_block).
//     The unpack and pack go straight between device memory and the
//     slots, the whole warp on one chain's row at a time (32 qubits a
//     ballot).  The qubit table and the multipliers sit in shared memory
//     where the block leaves room (ops/sweep.py::sweep_plan), else the
//     kernel reads them from device memory.  The two forms and the plain
//     version agree bit for bit.
// No block barrier after the tables are loaded: each warp owns its chains
// and its part of shared memory, so a warp past the batch simply returns;
// a ragged warp runs its padding chains on empty planes and stores nothing
// for them.
//
// Built by mcmc_qec_tpu_torch/ops/_build.py (nvcc, no fast math, so logf is
// the same function torch.log calls) and bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "sweep.cuh"

namespace mqt {

constexpr int kSweepThreads = 256;  // ops/sweep.py::SWEEP_THREADS
constexpr int kWideThreads = 1024;  // most threads a block of the large variant
constexpr int kCountBits = 10;      // bits per packed count (nq < 1024)
constexpr int kRegWords = 16;       // most words of a register instantiation
constexpr int kWideWords = 256;     // most words of the large variant
constexpr int kWide = 0;            // the NW of the large variant's dispatch

// Must match ops/sweep.py::_Params field for field.
struct SweepParams {
  int32_t B, nq, nw, span, n_colors, n_stabs, steps, iters, equal_betas, record;
  int32_t lanes, chains_per_block, tile_steps, region_bytes, tab_in_smem, smem;
  uint32_t key0, key1;
  int32_t beta_stride;  // 0: one (3,) row for the launch; 3: a row per chain
  int32_t mults_in_smem;  // the hash multipliers in shared memory (else device)
  int32_t threads;        // threads a block: kSweepThreads, or up to kWideThreads
};

// Must match ops/sweep.py::_Buffers.
struct SweepBuffers {
  const uint8_t* state_in;  // (B, nq) Pauli values 0..3
  uint8_t* state_out;       // (B, nq)
  const float* betas;       // (3,) or (B, 3) beta_x, beta_y, beta_z
  const uint64_t* tab;      // (n_stabs, span, 3) spanned-word masks, by color
                            // (register instantiations)
  const int32_t* meta;      // color starts (n_colors + 1), then the packed spans
                            // (n_stabs) of a register instantiation
  const uint2* mults;       // (nq,) pack_key's two multipliers per qubit
  const int64_t* seeds;     // (steps,) each step's Philox key (recording)
  int64_t* keys;            // (B, steps, 2) the two hashes, in [0, 2**32)
  int32_t* counts;          // (B, steps, 3) X, Y and Z counts
  const uint64_t* qtab;     // (n_stabs,) qubit-table entries, by color (the
                            // large variant; ops/kernel_tables.py::qubit_table)
};

// Shared memory of one block, in bytes from its base; mirrored by
// ops/sweep.py::sweep_smem_bytes.
struct SweepLayout {
  size_t tab, mults, meta, warps, bytes;

  // entries of the kernel's meta: color starts, then a register
  // instantiation's spanned-word entries
  __host__ __device__ static int meta_len(const SweepParams& P) {
    return P.n_colors + 1 + (P.nw > kRegWords ? 0 : P.n_stabs);
  }

  // tab: the spanned-word table, or in the large variant the qubit table
  __host__ __device__ explicit SweepLayout(const SweepParams& P) {
    size_t off = 0;
    const size_t tab_words = P.nw > kRegWords ? (size_t)P.n_stabs
                                              : (size_t)P.n_stabs * 3 * P.span;
    tab = take(off, P.tab_in_smem ? 8 * tab_words : 0);
    mults = take(off, P.mults_in_smem ? 8 * (size_t)P.nq : 0);
    meta = take(off, 4 * (size_t)meta_len(P));
    off = (off + 15) & ~(size_t)15;
    warps = take(off, (size_t)P.region_bytes * (P.threads / 32));
    bytes = off;
  }

 private:
  __host__ __device__ static size_t take(size_t& off, size_t n) {
    const size_t at = off;
    off += n;
    return at;
  }
};

// One color of sweep ``t`` on a chain whose L lanes each hold its planes:
// lane l draws the color's Philox blocks g = l, l + L, ... (counter (g, c,
// t, b) under the step's key) and decides the block's four stabilizers
// 4g..4g+3 on the pre-color planes, then the butterfly applies every
// accepted flip.
template <int NW, int S, bool EQ>
__device__ __forceinline__ void sweep_color(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                            const uint64_t* stab, const int32_t* span, int c0,
                                            int n, int l, int L, float bx, float by, float bz,
                                            uint32_t k0, uint32_t k1, uint32_t c, uint32_t t,
                                            uint32_t b) {
  uint64_t fX[NW], fZ[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) fX[q] = fZ[q] = 0;
  const int nb = (n + 3) >> 2;
  for (int g = l; g < nb; g += L) {
    const uint4 v = philox4x32_10(make_uint4((uint32_t)g, c, t, b), k0, k1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * g + e;
      if (j >= n) break;
      const int s = c0 + j;
      int wm[S];
      uint64_t xm[S], zm[S];
      const float logr = proposal_logr<NW, S, EQ>(X, Z, stab + (size_t)s * 3 * S,
                                                  (uint32_t)span[s], bx, by, bz, wm, xm, zm);
      // every uniform is < 1, so logf(u) < 0 and logr >= 0 accepts without
      // the logarithm: the same decision as the plain version's comparison
      if (logr >= 0.f || logf(uniform24(word_of(v, e))) < logr)
        add_flip<NW, S>(fX, fZ, wm, xm, zm);
    }
  }
  apply_flips<NW>(X, Z, fX, fZ, L);
}

// A chain's key and counts after a step, in every lane of the chain: lane l
// sums m_q * v_q (v = (x ^ z) + 2z, the Pauli value 0..3) over the qubits
// 64w + k with k = l, l + L, ... and popcounts the words w = l, l + L, ...
// (X-only, Y, Z-only, 10 bits each), and a butterfly adds the lanes' parts
// in wraparound u32, which is pack_key's sum mod 2**32.  Bits past nq are
// zero in both planes, so the counts need no mask.
template <int NW>
__device__ __forceinline__ void record_step(const uint64_t (&X)[NW], const uint64_t (&Z)[NW],
                                            const uint2* mults, int nq, int l, int L,
                                            uint32_t& h0, uint32_t& h1, uint32_t& cnt) {
  h0 = h1 = cnt = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint64_t a = X[w] ^ Z[w], z = Z[w];
    if ((w & (L - 1)) == l) {
      cnt += (uint32_t)__popcll(X[w] & ~Z[w]) |
             ((uint32_t)__popcll(X[w] & Z[w]) << kCountBits) |
             ((uint32_t)__popcll(~X[w] & Z[w]) << (2 * kCountBits));
    }
    const int kend = min(64, nq - 64 * w);
    for (int k = l; k < kend; k += L) {
      const uint32_t v = (uint32_t)((a >> k) & 1u) + 2u * (uint32_t)((z >> k) & 1u);
      const uint2 m = mults[64 * w + k];
      h0 += m.x * v;
      h1 += m.y * v;
    }
  }
  for (int k = 1; k < L; k <<= 1) {
    h0 += __shfl_xor_sync(0xffffffffu, h0, k);
    h1 += __shfl_xor_sync(0xffffffffu, h1, k);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, k);
  }
}

// Blocks an SM should hold, which caps the registers a thread: planes of
// one or two words fit four (64 registers, no spills in the recording
// instantiations; measured 3-8% faster at 2,048-65,536 chains of toric
// d=5), three to six words two (128; 5-20% faster at toric d=9 and d=13
// than one block of up to 255), and 8 to 16 words keep one (capped at 128
// they spill 448-568 bytes and take twice as long at toric d=19).
template <int NW, int S, bool EQ, bool REC>
__global__ void __launch_bounds__(kSweepThreads, NW <= 2 ? 4 : (NW <= 6 ? 2 : 1))
    sweep_kernel(const SweepParams P, const SweepBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SweepLayout lay(P);
  const int tid = threadIdx.x;
  uint64_t* tab_copy = reinterpret_cast<uint64_t*>(smem_raw + lay.tab);
  uint2* mults = reinterpret_cast<uint2*>(smem_raw + lay.mults);
  int32_t* meta = reinterpret_cast<int32_t*>(smem_raw + lay.meta);
  if (P.tab_in_smem)
    for (int i = tid; i < P.n_stabs * 3 * S; i += blockDim.x) tab_copy[i] = buf.tab[i];
  if (REC)
    for (int i = tid; i < P.nq; i += blockDim.x) mults[i] = buf.mults[i];
  for (int i = tid; i < P.n_colors + 1 + P.n_stabs; i += blockDim.x) meta[i] = buf.meta[i];
  __syncthreads();  // the block's only barrier: from here on warps are independent
  const uint64_t* stab = P.tab_in_smem ? tab_copy : buf.tab;
  const int32_t* span = meta + P.n_colors + 1;

  const int L = P.lanes, nq = P.nq, T = P.tile_steps;
  const int lane = tid & 31, warp = tid >> 5;
  const int cpw = 32 / L;  // chains per warp
  const int cw = lane / L, l = lane & (L - 1);
  const size_t b0 = (size_t)blockIdx.x * P.chains_per_block + (size_t)warp * cpw;
  if (b0 >= (size_t)P.B) return;
  const int rows = (size_t)P.B - b0 < (size_t)cpw ? (int)((size_t)P.B - b0) : cpw;
  unsigned char* region = smem_raw + lay.warps + (size_t)warp * P.region_bytes;

  // unpack: the warp's rows through shared memory, each lane ORs in the
  // bits of its qubits k = l, l + L, ... and a butterfly merges the lanes
  {
    const uint8_t* src = buf.state_in + b0 * nq;
    for (int i = lane; i < rows * nq; i += 32) region[i] = src[i];
  }
  __syncwarp();
  uint64_t X[NW], Z[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    X[w] = Z[w] = 0;
    if (cw < rows) {
      const unsigned char* mine = region + cw * nq + 64 * w;
      for (int k = l; k < 64 && 64 * w + k < nq; k += L) {
        const uint32_t v = mine[k];
        X[w] |= (uint64_t)((v ^ (v >> 1)) & 1u) << k;
        Z[w] |= (uint64_t)((v >> 1) & 1u) << k;
      }
    }
  }
  for (int k = 1; k < L; k <<= 1) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      X[w] |= __shfl_xor_sync(0xffffffffu, X[w], k);
      Z[w] |= __shfl_xor_sync(0xffffffffu, Z[w], k);
    }
  }
  __syncwarp();  // the region now stages the recording

  const uint32_t b = (uint32_t)(b0 + cw);
  // the chain's betas, loaded once for the launch (a padding chain of a
  // ragged warp reads the warp's first row)
  const float* brow = buf.betas + (size_t)P.beta_stride * (cw < rows ? b0 + cw : b0);
  const float bx = brow[0], by = brow[1], bz = brow[2];
  // per chain of the warp: T steps of (h0, h1) and T packed counts, each
  // run padded by one word so that the chains' lane-0 writes of a step
  // fall in distinct banks
  const int kst = 2 * T + 1, cst = T + 1;
  uint32_t* st_key = reinterpret_cast<uint32_t*>(region);
  uint32_t* st_cnt = st_key + (size_t)cpw * kst;
  int slot = 0;  // the step's place in the tile
  for (int s = 0; s < P.steps; ++s) {
    uint32_t k0 = P.key0, k1 = P.key1;
    if (REC) {
      const uint64_t key = (uint64_t)buf.seeds[s];
      k0 = (uint32_t)key;
      k1 = (uint32_t)(key >> 32);
    }
    for (int t = 0; t < P.iters; ++t) {
      for (int c = 0; c < P.n_colors; ++c) {
        const int c0 = meta[c];
        sweep_color<NW, S, EQ>(X, Z, stab, span, c0, meta[c + 1] - c0, l, L, bx, by, bz, k0,
                               k1, (uint32_t)c, (uint32_t)t, b);
      }
    }
    if (REC) {
      uint32_t h0, h1, cnt;
      record_step<NW>(X, Z, mults, nq, l, L, h0, h1, cnt);
      if (l == 0) {
        st_key[cw * kst + 2 * slot] = h0;
        st_key[cw * kst + 2 * slot + 1] = h1;
        st_cnt[cw * cst + slot] = cnt;
      }
      if (++slot == T || s == P.steps - 1) {
        // store the tile: per chain a run of 2 * slot keys and one of
        // 3 * slot counts, the warp's lanes on consecutive entries
        __syncwarp();
        const size_t s0 = (size_t)(s + 1 - slot);
        const int nk = 2 * slot, nc = 3 * slot;
        for (int e = lane; e < rows * nk; e += 32) {
          const int c = e / nk, r = e - c * nk;
          buf.keys[((b0 + c) * P.steps + s0) * 2 + r] = (int64_t)st_key[c * kst + r];
        }
        for (int e = lane; e < rows * nc; e += 32) {
          const int c = e / nc, r = e - c * nc, i = r / 3;
          buf.counts[((b0 + c) * P.steps + s0) * 3 + r] = (int32_t)(
              (st_cnt[c * cst + i] >> (kCountBits * (r - 3 * i))) & ((1u << kCountBits) - 1u));
        }
        __syncwarp();
        slot = 0;
      }
    }
  }

  // pack: each lane writes the bytes of its qubits, then the warp copies
  // its rows out
  if (cw < rows) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      unsigned char* mine = region + cw * nq + 64 * w;
      for (int k = l; k < 64 && 64 * w + k < nq; k += L) {
        const uint32_t x = (uint32_t)(X[w] >> k) & 1u, z = (uint32_t)(Z[w] >> k) & 1u;
        mine[k] = (uint8_t)(x ^ (z * 3u));
      }
    }
  }
  __syncwarp();
  uint8_t* dst = buf.state_out + b0 * nq;
  for (int i = lane; i < rows * nq; i += 32) dst[i] = region[i];
}

// ---------------------------------------------------------------------------
// The large variant: more than 16 words per plane, 2 bits a qubit in shared
// memory
// ---------------------------------------------------------------------------

// A lane's share of its chain's recording: pack_key's two sums of m_q * v_q
// (wraparound u32) and the X, Y and Z counts, kCntShift bits apart in one
// 64-bit sum.  A total is at most 16,384 < 2**kCntShift and the lanes'
// shares (a share may go below zero) add in wraparound u64, so the packed
// sum of the shares is the packed totals.
constexpr int kCntShift = 21;

struct RecShare {
  uint32_t h0, h1;
  uint64_t cnt;
};

// Bit e set for each nonzero byte e of x, and back: all 8 bits of byte e
// for each bit e of m.
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t x) {
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) m |= ((x >> (8 * e)) & 255u) ? 1u << e : 0u;
  return m;
}

__device__ __forceinline__ uint32_t byte_mask(unsigned m) {
  uint32_t x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) x |= (m >> e) & 1u ? 255u << (8 * e) : 0u;
  return x;
}

// The Pauli values 0..3 (I, X, Y, Z: pack_key's v) of packed 2-bit states
// x | z << 1: v = s ^ (z into the x bit).
__device__ __forceinline__ uint32_t pauli_of(uint32_t s) { return s ^ ((s >> 1) & 0x55555555u); }

// The X-only, Y and Z-only qubits of packed 2-bit states, as one packed
// count (the fields of RecShare::cnt).
__device__ __forceinline__ uint64_t xyz_packed(uint32_t s) {
  const uint32_t x = s & 0x55555555u, z = (s >> 1) & 0x55555555u;
  return (uint64_t)__popc(x & ~z) | ((uint64_t)__popc(x & z) << kCntShift) |
         ((uint64_t)__popc(z & ~x) << (2 * kCntShift));
}

// Flip an accepted entry's qubits in the slot, one 32-bit shared atomic
// (ATOMS.XOR) a qubit, and while recording add each flipped qubit q's
// m_q * (v_new - v_old) to the lane's hash sums (``s``: the entry's states
// before the flip, as load_block packed them).  No branch a qubit: a
// missing qubit's op is 0, so it XORs 0 into qubit 0's word and adds 0.
template <bool REC>
__device__ __forceinline__ void flip_entry(uint32_t* W, uint64_t e, uint32_t s,
                                           const uint2* mults, RecShare& r) {
  const uint32_t o = entry_ops(e);
  // the four qubits' Pauli values before and after, 2 bits each
  const uint32_t v0 = pauli_of(s), v1 = pauli_of(s ^ o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = entry_qubit(e, k);
    atomicXor(W + (q >> 4), ((o >> (2 * k)) & 3u) << ((q & 15) << 1));
    if constexpr (REC) {
      const uint32_t dv = ((v1 >> (2 * k)) & 3u) - ((v0 >> (2 * k)) & 3u);
      const uint2 m = mults[q];
      r.h0 += m.x * dv;
      r.h1 += m.y * dv;
    }
  }
}

// One color of sweep ``t`` on a chain whose slot ``W`` (4 nw words of 16
// qubits) sits in shared memory: lane l takes the color's Philox blocks g
// = l, l + L, ... whole, at the register form's counters (g, c, t, b).  Per
// block it first issues the next block's loads (one qubit-table entry and
// four 32-bit slot words a stabilizer), then decides the block's four
// stabilizers on the states it loaded (block_accepts, sweep.cuh), then
// XORs the accepted flips in, one accepted stabilizer a turn (a warp runs
// as many turns as its busiest lane has flips, not four) and one 32-bit
// shared atomic a qubit, and, when recording, adds their changes to its
// share ``r``.  A color's supports are disjoint and a decision reads only
// its own qubits, which no other stabilizer of the color flips, so every
// order of loads and flips decides as the planes before the color do; the
// caller's __syncwarp closes the color.  A padded entry's ops are 0: it
// flips nothing.
template <bool EQ, bool REC>
__device__ __forceinline__ void sweep_color_wide(uint32_t* W, const uint64_t* qtab,
                                                 const uint2* mults, int c0, int n, int l, int L,
                                                 float bx, float by, float bz, uint32_t k0,
                                                 uint32_t k1, uint32_t c, uint32_t t, uint32_t b,
                                                 RecShare& r) {
  const int nb = (n + 3) >> 2;
  if (l >= nb) return;
  uint32_t st, ops;
  load_block(W, qtab, c0, n, l, st, ops);
  for (int g = l; g < nb; g += L) {
    uint32_t st_n, ops_n;
    load_block(W, qtab, c0, g + L < nb ? n : 0, g + L, st_n, ops_n);
    const uint4 v = philox4x32_10(make_uint4((uint32_t)g, c, t, b), k0, k1);
    // the accepted stabilizers that flip a qubit, one a turn
    unsigned todo = block_accepts<EQ>(st, ops, v, bx, by, bz) & nonzero_bytes(ops);
    if constexpr (REC) {
      r.cnt += xyz_packed(st ^ (ops & byte_mask(todo))) - xyz_packed(st);
    }
    while (todo) {
      const int e = __ffs(todo) - 1;
      todo &= todo - 1;
      flip_entry<REC>(W, qtab[c0 + 4 * g + e], st >> (8 * e), mults, r);
    }
    st = st_n;
    ops = ops_n;
  }
}

// The sweeps of sweep_kernel for codes above 16 words per plane, up to
// kWideThreads threads a block.  A warp's region holds its chains' slots
// (chain c at 32-bit word cs * c, cs = 4 nw + 1 from
// ops/sweep.py::plane_words: 16 qubits a word and a padding word, so that
// the chains of a warp start in different banks) and, while recording,
// their tiles.  The qubit table and the hash multipliers sit in shared
// memory where the plan found room (ops/sweep.py::sweep_plan), else the
// kernel reads them from device memory.
template <bool EQ, bool REC>
__global__ void __launch_bounds__(kWideThreads, 1)
    sweep_kernel_wide(const SweepParams P, const SweepBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SweepLayout lay(P);
  const int tid = threadIdx.x;
  uint64_t* qtab_copy = reinterpret_cast<uint64_t*>(smem_raw + lay.tab);
  uint2* mults_copy = reinterpret_cast<uint2*>(smem_raw + lay.mults);
  int32_t* meta = reinterpret_cast<int32_t*>(smem_raw + lay.meta);
  if (P.tab_in_smem)
    for (int i = tid; i < P.n_stabs; i += blockDim.x) qtab_copy[i] = buf.qtab[i];
  if (REC && P.mults_in_smem)
    for (int i = tid; i < P.nq; i += blockDim.x) mults_copy[i] = buf.mults[i];
  for (int i = tid; i < SweepLayout::meta_len(P); i += blockDim.x) meta[i] = buf.meta[i];
  __syncthreads();  // the block's only barrier: from here on warps are independent
  const uint2* mults = P.mults_in_smem ? mults_copy : buf.mults;

  const int L = P.lanes, nq = P.nq, nw = P.nw, T = P.tile_steps;
  const int cs = 4 * nw + 1;  // 32-bit words of one chain's slot
  const int lane = tid & 31, warp = tid >> 5;
  const int cpw = 32 / L;  // chains per warp
  const int cw = lane / L, l = lane & (L - 1);
  const size_t b0 = (size_t)blockIdx.x * P.chains_per_block + (size_t)warp * cpw;
  if (b0 >= (size_t)P.B) return;
  const int rows = (size_t)P.B - b0 < (size_t)cpw ? (int)((size_t)P.B - b0) : cpw;
  unsigned char* region = smem_raw + lay.warps + (size_t)warp * P.region_bytes;
  uint32_t* slots = reinterpret_cast<uint32_t*>(region);

  // unpack: the warp reads one chain's row at a time, 32 qubits a step;
  // lanes 0 and 1 store the two ballots as two slot words of 16 qubits.
  // While recording, each lane hashes and counts the qubits it read, and
  // the warp's sums become the share of the chain's lane 0 (the other lanes
  // start at 0).  A padding chain of a ragged warp gets an empty slot.
  RecShare r{0u, 0u, 0ull};
  for (int c = 0; c < cpw; ++c) {
    uint32_t* Wc = slots + (size_t)cs * c;
    uint32_t a0 = 0, a1 = 0, nx = 0, ny = 0, nz = 0;
    for (int k = 0; k < 2 * nw; ++k) {
      const int q = 32 * k + lane;
      const uint32_t v = (c < rows && q < nq) ? buf.state_in[(b0 + c) * nq + q] & 3u : 0u;
      const uint32_t xb = __ballot_sync(0xffffffffu, (v ^ (v >> 1)) & 1u);
      const uint32_t zb = __ballot_sync(0xffffffffu, (v >> 1) & 1u);
      if (lane < 2)
        Wc[2 * k + lane] = spread16(xb >> (16 * lane)) | (spread16(zb >> (16 * lane)) << 1);
      if (REC && v) {
        const uint2 m = mults[q];
        a0 += m.x * v;
        a1 += m.y * v;
        nx += v == 1u;
        ny += v == 2u;
        nz += v == 3u;
      }
    }
    if (REC) {
      a0 = __reduce_add_sync(0xffffffffu, a0);
      a1 = __reduce_add_sync(0xffffffffu, a1);
      nx = __reduce_add_sync(0xffffffffu, nx);
      ny = __reduce_add_sync(0xffffffffu, ny);
      nz = __reduce_add_sync(0xffffffffu, nz);
      if (cw == c && l == 0)
        r = RecShare{a0, a1,
                     (uint64_t)nx | ((uint64_t)ny << kCntShift) |
                         ((uint64_t)nz << (2 * kCntShift))};
    }
  }
  __syncwarp();
  uint32_t* W = slots + (size_t)cs * cw;

  const uint32_t b = (uint32_t)(b0 + cw);
  const float* brow = buf.betas + (size_t)P.beta_stride * (cw < rows ? b0 + cw : b0);
  const float bx = brow[0], by = EQ ? 0.f : brow[1], bz = EQ ? 0.f : brow[2];
  // per chain of the warp: T steps of (h0, h1) and of the three counts,
  // each run padded by one word
  const int kst = 2 * T + 1, cst = 3 * T + 1;
  uint32_t* st_key = slots + (size_t)cs * cpw;
  uint32_t* st_cnt = st_key + (size_t)cpw * kst;
  int slot = 0;
  for (int s = 0; s < P.steps; ++s) {
    uint32_t k0 = P.key0, k1 = P.key1;
    if (REC) {
      const uint64_t key = (uint64_t)buf.seeds[s];
      k0 = (uint32_t)key;
      k1 = (uint32_t)(key >> 32);
    }
    for (int t = 0; t < P.iters; ++t) {
      for (int c = 0; c < P.n_colors; ++c) {
        const int c0 = meta[c], n = meta[c + 1] - c0;
        // the tables' places are decided here, so each inlined sweep reads
        // them through pointers of one address space
        if (REC && P.tab_in_smem && P.mults_in_smem)
          sweep_color_wide<EQ, REC>(W, qtab_copy, mults_copy, c0, n, l, L, bx, by, bz, k0, k1,
                                    (uint32_t)c, (uint32_t)t, b, r);
        else if (P.tab_in_smem)
          sweep_color_wide<EQ, REC>(W, qtab_copy, mults, c0, n, l, L, bx, by, bz, k0, k1,
                                    (uint32_t)c, (uint32_t)t, b, r);
        else
          sweep_color_wide<EQ, REC>(W, buf.qtab, mults, c0, n, l, L, bx, by, bz, k0, k1,
                                    (uint32_t)c, (uint32_t)t, b, r);
        __syncwarp();  // every flip of the color is in before the next reads
      }
    }
    if (REC) {
      // the step's record: the sum of the chain's lanes' shares
      uint32_t h0 = r.h0, h1 = r.h1;
      uint64_t cnt = r.cnt;
      for (int k = 1; k < L; k <<= 1) {
        h0 += __shfl_xor_sync(0xffffffffu, h0, k);
        h1 += __shfl_xor_sync(0xffffffffu, h1, k);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, k);
      }
      if (l == 0) {
        st_key[cw * kst + 2 * slot] = h0;
        st_key[cw * kst + 2 * slot + 1] = h1;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          st_cnt[cw * cst + 3 * slot + i] =
              (uint32_t)(cnt >> (kCntShift * i)) & ((1u << kCntShift) - 1u);
      }
      if (++slot == T || s == P.steps - 1) {
        __syncwarp();
        const size_t s0 = (size_t)(s + 1 - slot);
        const int nk = 2 * slot, nc = 3 * slot;
        for (int e = lane; e < rows * nk; e += 32) {
          const int c = e / nk, i = e - c * nk;
          buf.keys[((b0 + c) * P.steps + s0) * 2 + i] = (int64_t)st_key[c * kst + i];
        }
        for (int e = lane; e < rows * nc; e += 32) {
          const int c = e / nc, i = e - c * nc;
          buf.counts[((b0 + c) * P.steps + s0) * 3 + i] = (int32_t)st_cnt[c * cst + i];
        }
        __syncwarp();
        slot = 0;
      }
    }
  }

  // pack: the warp writes one chain's row at a time
  __syncwarp();
  for (int c = 0; c < rows; ++c) {
    const uint32_t* Wc = slots + (size_t)cs * c;
    uint8_t* dst = buf.state_out + (b0 + c) * nq;
    for (int q = lane; q < nq; q += 32) {
      const uint32_t s = (Wc[q >> 4] >> ((q & 15) << 1)) & 3u;
      dst[q] = (uint8_t)((s & 1u) ^ ((s >> 1) * 3u));
    }
  }
}

// The launch's shape checks: the wrapper's plan must match the kernel's.
inline bool plan_ok(const SweepParams& P) {
  const int L = P.lanes;
  const bool wide = P.nw > kRegWords;
  if (L < 1 || L > 32 || (L & (L - 1))) return false;
  if (wide ? (P.threads < 32 || P.threads > kWideThreads || P.threads % 32)
           : P.threads != kSweepThreads)
    return false;
  if (P.chains_per_block * L != P.threads) return false;
  if (P.tile_steps < 1 || P.iters < 0 || P.steps < 1) return false;
  if (P.beta_stride != 0 && P.beta_stride != 3) return false;
  const size_t cpw = 32 / L;
  if (wide) {  // the large variant: its chains' slots and tiles
    if (P.nw > kWideWords || (size_t)P.nw * 64 < (size_t)P.nq) return false;
    const size_t tiles = P.record ? cpw * 4 * (5 * (size_t)P.tile_steps + 2) : 0;
    if ((size_t)P.region_bytes < cpw * 4 * (4 * (size_t)P.nw + 1) + tiles) return false;
  } else {
    if (!P.mults_in_smem) return false;
    if ((size_t)P.region_bytes < cpw * P.nq) return false;
    if (P.record && (size_t)P.region_bytes < cpw * 4 * (3 * (size_t)P.tile_steps + 2))
      return false;
  }
  if (P.mults_in_smem != 0 && P.mults_in_smem != 1) return false;
  return SweepLayout(P).bytes == (size_t)P.smem;
}

// The kernel of ``F<NW, S, EQ, REC>``: a register instantiation, or the
// large variant for NW == kWide (which reads no spanned words: S is 0).
template <int NW, int S, bool EQ, bool REC>
inline void (*kernel_of())(const SweepParams, const SweepBuffers) {
  if constexpr (NW == kWide)
    return sweep_kernel_wide<EQ, REC>;
  else
    return sweep_kernel<NW, S, EQ, REC>;
}

template <int NW, int S, bool EQ, bool REC>
cudaError_t set_smem(const SweepParams& P) {
  if (P.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_of<NW, S, EQ, REC>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
}

template <int NW, int S, bool EQ, bool REC>
struct Launch {
  static int run(const SweepParams& P, const SweepBuffers* buf, cudaStream_t st) {
    const cudaError_t err = set_smem<NW, S, EQ, REC>(P);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (P.B + P.chains_per_block - 1) / P.chains_per_block;
    if constexpr (NW == kWide)
      sweep_kernel_wide<EQ, REC><<<blocks, P.threads, P.smem, st>>>(P, *buf);
    else
      sweep_kernel<NW, S, EQ, REC><<<blocks, P.threads, P.smem, st>>>(P, *buf);
    return (int)cudaGetLastError();
  }
};

template <int NW, int S, bool EQ, bool REC>
struct Resident {
  static int run(const SweepParams& P) {
    if (set_smem<NW, S, EQ, REC>(P) != cudaSuccess) return -1;
    int n = -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_of<NW, S, EQ, REC>(),
                                                      P.threads, P.smem) != cudaSuccess)
      return -1;
    return n;
  }
};

template <template <int, int, bool, bool> class F, int NW, int S, class... A>
int dispatch_form(const SweepParams& P, A... args) {
  if (P.equal_betas)
    return P.record ? F<NW, S, true, true>::run(P, args...) : F<NW, S, true, false>::run(P, args...);
  return P.record ? F<NW, S, false, true>::run(P, args...) : F<NW, S, false, false>::run(P, args...);
}

// Run ``F<NW, S, EQ, REC>`` for the launch's words per plane and spanned
// words per stabilizer (ops/sweep.py::SWEEP_SHAPES; above 16 words
// the large variant, NW = kWide and S = 0, any word count up to kWideWords,
// every stabilizer of at most four qubits), acceptance form and recording
// switch, or return ``bad``.
template <template <int, int, bool, bool> class F, class... A>
int dispatch(const SweepParams& P, int bad, A... args) {
  if (P.nw > kRegWords) return dispatch_form<F, kWide, 0>(P, args...);
#define MQT_SHAPE(W, SP) \
  if (P.nw == W && P.span == SP) return dispatch_form<F, W, SP>(P, args...);
  MQT_SHAPE(1, 1)
  MQT_SHAPE(2, 2)
  MQT_SHAPE(3, 2)
  MQT_SHAPE(3, 4)
  MQT_SHAPE(4, 2)
  MQT_SHAPE(4, 4)
  MQT_SHAPE(6, 2)
  MQT_SHAPE(6, 4)
  MQT_SHAPE(8, 2)
  MQT_SHAPE(8, 4)
  MQT_SHAPE(12, 2)
  MQT_SHAPE(12, 4)
  MQT_SHAPE(16, 2)
  MQT_SHAPE(16, 4)
#undef MQT_SHAPE
  return bad;
}

}  // namespace mqt

// Launch the sweeps over the batch on ``stream``; returns the cudaError_t
// of the launch (0 on success).  Asynchronous: a fault during the run shows
// at the next synchronisation.
extern "C" int mqt_sweep(const mqt::SweepParams* P, const mqt::SweepBuffers* buf, void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  if (P->B <= 0 || P->nq <= 0 || P->n_colors <= 0 || !mqt::plan_ok(*P))
    return (int)cudaErrorInvalidValue;
  if (P->record && (buf->seeds == nullptr || buf->keys == nullptr || buf->counts == nullptr ||
                    buf->mults == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P->nw > mqt::kRegWords ? buf->qtab == nullptr : buf->tab == nullptr)
    return (int)cudaErrorInvalidValue;
  return mqt::dispatch<mqt::Launch>(*P, (int)cudaErrorInvalidValue, buf,
                                    static_cast<cudaStream_t>(stream));
}

// Blocks of the launch ``P`` describes that one SM holds at once (the
// occupancy calculator's answer for its registers and shared memory), or
// -1.
extern "C" int mqt_sweep_resident_blocks(const mqt::SweepParams* P) {
  (void)cudaGetLastError();
  if (!mqt::plan_ok(*P)) return -1;
  return mqt::dispatch<mqt::Resident>(*P, -1);
}
