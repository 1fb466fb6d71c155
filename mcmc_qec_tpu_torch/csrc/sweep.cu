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
//     ops/ladder_window.py::kernel_tables): two popcounts a word with equal
//     betas, four with general betas; up to 12 words per plane (toric d=19).
//     The tables sit in shared memory unless they would leave the SM fewer
//     than four blocks, when the kernel reads them from device memory.
//   - The recording on the chip: each lane sums m_q * v_q over its share
//     of the qubits (v = (x ^ z) + 2z, wraparound u32) and popcounts its
//     share of the words for the counts (packed 10 bits each), one warp
//     butterfly adds the lanes' parts, and lane 0 of each chain stages the
//     step in shared memory; every ``tile_steps`` steps the warp stores its
//     chains' tiles as contiguous rows of the (B, steps, 2) int64 keys and
//     (B, steps, 3) int32 counts the reduction reads.
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
constexpr int kCountBits = 10;      // bits per packed count (nq <= 768 < 1024)

// Must match ops/sweep.py::_Params field for field.
struct SweepParams {
  int32_t B, nq, nw, span, n_colors, n_stabs, steps, iters, equal_betas, record;
  int32_t lanes, chains_per_block, tile_steps, region_bytes, tab_in_smem, smem;
  uint32_t key0, key1;
  int32_t beta_stride;  // 0: one (3,) row for the launch; 3: a row per chain
};

// Must match ops/sweep.py::_Buffers.
struct SweepBuffers {
  const uint8_t* state_in;  // (B, nq) Pauli values 0..3
  uint8_t* state_out;       // (B, nq)
  const float* betas;       // (3,) or (B, 3) beta_x, beta_y, beta_z
  const uint64_t* tab;      // (n_stabs, span, 3) spanned-word masks, by color
  const int32_t* meta;      // color starts (n_colors + 1), packed spans (n_stabs)
  const uint2* mults;       // (nq,) pack_key's two multipliers per qubit
  const int64_t* seeds;     // (steps,) each step's Philox key (recording)
  int64_t* keys;            // (B, steps, 2) the two hashes, in [0, 2**32)
  int32_t* counts;          // (B, steps, 3) X, Y and Z counts
};

// Shared memory of one block, in bytes from its base; mirrored by
// ops/sweep.py::sweep_smem_bytes.
struct SweepLayout {
  size_t tab, mults, meta, warps, bytes;

  __host__ __device__ explicit SweepLayout(const SweepParams& P) {
    size_t off = 0;
    tab = take(off, P.tab_in_smem ? 8 * (size_t)P.n_stabs * 3 * P.span : 0);
    mults = take(off, 8 * (size_t)P.nq);
    meta = take(off, 4 * (size_t)(P.n_colors + 1 + P.n_stabs));
    off = (off + 15) & ~(size_t)15;
    warps = take(off, (size_t)P.region_bytes * (kSweepThreads / 32));
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
// than one block of up to 255), and 8 or 12 words keep one (capped at 128
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

// The launch's shape checks: the wrapper's plan must match the kernel's.
inline bool plan_ok(const SweepParams& P) {
  const int L = P.lanes;
  if (L < 1 || L > 32 || (L & (L - 1)) || P.chains_per_block * L != kSweepThreads) return false;
  if (P.tile_steps < 1 || P.iters < 0 || P.steps < 1) return false;
  if (P.beta_stride != 0 && P.beta_stride != 3) return false;
  const size_t cpw = 32 / L;
  if ((size_t)P.region_bytes < cpw * P.nq) return false;
  if (P.record && (size_t)P.region_bytes < cpw * 4 * (3 * (size_t)P.tile_steps + 2)) return false;
  return SweepLayout(P).bytes == (size_t)P.smem;
}

template <int NW, int S, bool EQ, bool REC>
cudaError_t set_smem(const SweepParams& P) {
  if (P.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sweep_kernel<NW, S, EQ, REC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
}

template <int NW, int S, bool EQ, bool REC>
struct Launch {
  static int run(const SweepParams& P, const SweepBuffers* buf, cudaStream_t st) {
    const cudaError_t err = set_smem<NW, S, EQ, REC>(P);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (P.B + P.chains_per_block - 1) / P.chains_per_block;
    sweep_kernel<NW, S, EQ, REC><<<blocks, kSweepThreads, P.smem, st>>>(P, *buf);
    return (int)cudaGetLastError();
  }
};

template <int NW, int S, bool EQ, bool REC>
struct Resident {
  static int run(const SweepParams& P) {
    if (set_smem<NW, S, EQ, REC>(P) != cudaSuccess) return -1;
    int n = -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sweep_kernel<NW, S, EQ, REC>,
                                                      kSweepThreads, P.smem) != cudaSuccess)
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
// words per stabilizer (ops/ladder_window.py::KERNEL_SHAPES), acceptance
// form and recording switch, or return ``bad``.
template <template <int, int, bool, bool> class F, class... A>
int dispatch(const SweepParams& P, int bad, A... args) {
#define MQT_SHAPE(W, SP) \
  if (P.nw == W && P.span == SP) return dispatch_form<F, W, SP>(P, args...);
  MQT_SHAPE(1, 1)
  MQT_SHAPE(2, 2)
  MQT_SHAPE(3, 2)
  MQT_SHAPE(3, 4)
  MQT_SHAPE(4, 4)
  MQT_SHAPE(6, 4)
  MQT_SHAPE(8, 4)
  MQT_SHAPE(12, 4)
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
