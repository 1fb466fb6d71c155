// One PTEQ parallel-tempering window in one launch, on Hopper (sm_90a).
//
// Replaces mcmc_qec_tpu/ops/pallas_ladder.py::make_pallas_ladder_window (the
// Pallas TPU kernel), every branch.  Per ladder step and syndrome:
//   1. ``iters`` colored Metropolis sweeps on every rung with the rung's
//      betas: on the total error-count change (equal per-Pauli betas, the
//      template's EQ form) or on the X/Y/Z count changes (general betas);
//   2. the top rung's logical mix: with zero top betas every gated random
//      logical is XORed in; otherwise ``iters`` Metropolis rounds, each a
//      gate, the XOR of all draws' masks and one accept on the top betas;
//   3. replica exchange on the per-rung counts taken after the mix (one
//      total count, or X/Y/Z counts in the general form), top->bottom or in
//      two phases of disjoint pairs (``even_odd``); an accepted pair swaps
//      chains, counts and flags;
//   4. the top flag is set; a flag reaching the bottom increments tops0;
//   5. the bottom rung is observed: burn gate, since_burn, burn_first, the
//      class histogram, per-chunk mean energies and, in trace mode, the
//      per-step class and 4-component chain hash.
// The plain PyTorch version is ops/ladder_window.py::ladder_window_reference;
// both draw the same Philox4x32-10 bits, so they agree trajectory for
// trajectory.
//
// What bounds it on this card: almost no bytes move (the state is read once
// and written once per window), so the bound is instruction issue: the
// popcounts of the proposals, ten Philox rounds per four draws and a
// precise logf per compared draw, over the window's steps.  What keeps a
// kernel from that bound is latency: a step is a chain of dependent phases
// (color after color, then the exchange), and one thread per chain left
// the SMs nearly empty (at B=2048 x Nc=5, 2.5 warps per SM) with each
// thread's proposals, draws and logf in one serial line.  The design:
//   - A group of threads per syndrome, ``lanes`` (L, a power of two) per
//     rung, padded to whole warps: toric d=5 (Nc=5, L=4) is one warp per
//     syndrome, xzzx d=13 (Nc=13, L=8) four.  A rung's lanes sit in one
//     warp.  The whole group synchronises three times a step (a
//     __syncwarp, or the named barrier ``bar.sync 1 + group`` of a
//     multi-warp group); nothing waits on the whole block after the tables
//     are loaded, so a group past the batch simply returns.
//   - A color decided at once, in registers: every lane of a rung holds the
//     rung's planes (``NW`` words each), decides its stabilizers (j = lane,
//     lane + L, ...) on the planes as they stood before the color, XORs
//     the accepted op masks into its own flip words, and an XOR butterfly
//     of shuffles over the rung's lanes hands every lane all the color's
//     flips.  Stabilizers of one color share no qubit, so this equals the
//     sequential visit (the TPU kernel's parallel accept).  No shared
//     memory, atomics or barriers inside a sweep.
//   - Draws off the serial path: at the start of a step all the group's
//     threads (padding lanes too) run every Philox block of the step (one
//     per four stabilizers of each color, per iteration and rung, and the
//     exchange's and the logical mix's) and store logf(u) in shared
//     memory.  Same logf (no fast math), so every comparison decides as
//     before; a NaN logr still rejects.
//   - Only the words a stabilizer spans: each stabilizer carries the (at
//     most four, one or two almost everywhere) 64-bit words its support
//     touches with its masks there (``span`` entries, zero-padded), so a
//     proposal popcounts those words, not the whole plane.  The general
//     form needs four popcounts a word: the X and Z totals change by
//     cx - 2 popc(x & xs) and cz - 2 popc(z & zs), and only the Y count
//     needs before and after.
//   - Exchange through shared memory once a step: lane 0 of each rung
//     publishes its chain and counts (double-buffered by step parity), one
//     thread runs the pairs, which depend on each other, on a permutation
//     with precomputed log-uniforms, and every lane loads the chain the
//     permutation sends its rung.  The class readout is on the bottom
//     rung's lane 0, the trace-mode chain hash over its lanes (component c
//     on lane c % L).
// The tables sit in shared memory unless they leave no room for a group,
// when they are read from device memory.
//
// The large variant (ladder_window_kernel_wide<EQ>) takes the ladders the
// registers cannot hold: codes of 6 words per plane and more, which have
// no register instantiation (toric and planar from d=12, rotated and XZZX
// from d=17, up to 256 words; ops/ladder_window.py::WINDOW_SHAPES),
// ladders whose group of published chains and staged draws leaves no room
// in 227 KB, and, where it is faster, codes the registers hold
// (ops/ladder_window.py::window_form).  The word count is a run-time value.
// What bounds it is what bounds the register form.  What keeps a kernel of
// this shape from that bound is latency: with the planes in shared memory,
// a lane that decides its proposals one after another waits on each
// decision's loads (about twenty in a spanned-word layout) and an accept's
// atomics, and one syndrome of a few warps per SM hides none of it.  The
// design:
//   - Per-qubit proposals.  A stabilizer is one 64-bit entry of the qubit
//     table (ops/kernel_tables.py::qubit_table): its (at most four) qubits,
//     14 bits each, and their ops, 2 bits each.  A rung's chain sits in a
//     slot of shared memory with 2 bits a qubit (x, z), 16 qubits a 32-bit
//     word, so a proposal is one entry and four 32-bit loads, its qubits'
//     states packed into 8 bits, and its count changes a few popcounts of
//     those 8 bits: the same integers as the register form's spanned-word
//     popcounts, so the same logr and decision.
//   - Decide, then apply.  A lane takes whole Philox blocks of a color
//     (blocks l, l + L, ...; the register form's counters, the same logf).
//     It issues the loads of its next block before it decides the current
//     one, decides the block's four stabilizers, then XORs the accepted
//     flips in, one 32-bit shared atomic (ATOMS.XOR) a qubit: lanes of a
//     rung share words.  A color's supports are disjoint and a decision
//     reads only its own qubits' bits, which no other stabilizer of the
//     color flips, so every order decides as the planes before the color
//     do; a __syncwarp closes the color.
//   - A full SM.  Up to 1024 threads a block at 64 registers a thread (its
//     own launch bounds), 32 lanes a rung where one syndrome takes an SM
//     (toric d=25 at B=128: 25 warps an SM) and fewer where the batch puts
//     several syndromes on an SM, so that up to 32 warps stay resident
//     (ops/ladder_window.py::wide_lanes).  Thread 0's exchange state and
//     the rung's betas are read from shared memory, so no thread spills.
// The exchange swaps the rungs' slot indices, not their planes.  The top
// rung's mix, the counts and the bottom rung's class and hash split the
// words over a rung's lanes and combine them with shuffles.  The qubit
// table sits in shared memory where it fits beside the groups, every other
// table in device memory.
// ops/ladder_window.py::window_form picks the form from shapes before any
// launch.
//
// Built by mcmc_qec_tpu_torch/ops/_build.py (nvcc, no fast math, so logf is
// the same function torch.log calls) and bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "sweep.cuh"

namespace mqt {

// Must match ops/ladder_window.py::_Params field for field.
struct WindowParams {
  int32_t B, Nc, nq, nw, K, n_bits, n_colors, n_draws;
  int32_t window, iters, tops_burn, energy_chunk, fixed, span;
  int32_t lanes, lane_shift, warps_per_group, groups_per_block;
  int32_t n_tab, n_meta, off_class, off_key, off_span;
  int32_t m_draw, m_lut, m_b2e, m_span, m_blk, m_bcol, n_blk;
  int32_t equal_betas, top_exact, even_odd, traces, tab_in_smem, smem;
  int32_t wide;    // the large variant (planes in shared memory); there
                   // n_tab counts the qubit table's entries (one per
                   // stabilizer, in shared memory if tab_in_smem) and
                   // n_meta the meta words copied to shared memory
  float p_logical, w0, w1, w2, inv_chunk;
  uint32_t key0, key1, fixed_word;
};

// Must match ops/ladder_window.py::_Buffers.
struct WindowBuffers {
  const uint8_t* state_in;
  uint8_t* state_out;
  const int32_t* flag_in;
  int32_t* flag_out;
  const int32_t* tops_in;
  int32_t* tops_out;
  const int32_t* eq_in;
  int32_t* eq_out;
  const int32_t* since_in;
  int32_t* since_out;
  float* energies;
  uint8_t* burn_any;
  int32_t* burn_first;
  int32_t* swap_acc;
  int32_t* eq_trace;    // (window, B) in trace mode
  int32_t* key_trace;   // (window, B, 4) in trace mode
  const float* betas;   // (Nc, 3)
  const uint64_t* tab;  // logical-draw (from 0), class, hash and spanned-word masks
  const int32_t* meta;  // color starts, draw starts, op LUT, spans, blocks, bits_to_eq
  const uint64_t* qtab;  // the large variant's qubit table, one entry per stabilizer
};

constexpr int kMaxThreads = 512;  // ops/ladder_window.py::MAX_THREADS
constexpr int kWideMaxThreads = 1024;  // the large variant: WIDE_MAX_THREADS
constexpr int kMaxBarriers = 15;  // named barriers 1..15
constexpr int kKeys = 4;          // hash components
constexpr int kKeyBits = 6;       // bits per hash coefficient
constexpr int kWide = 0;          // the NW of the large variant's dispatch
constexpr int kWideWords = 256;   // most words of the large variant

// Shared memory of one block, in bytes from its base; mirrored by
// ops/ladder_window.py::smem_bytes and group_bytes (wide_smem_bytes and
// wide_group_bytes for the large variant, WIDE).
template <bool EQ, bool WIDE = false>
struct Layout {
  static constexpr int kCnt = EQ ? 1 : 3;  // counts per rung
  // the large variant's scalars before the energy sums: burn flag, tops,
  // since_burn, burn_first, steps to the next energy row, energy row
  static constexpr int kScal = 6;
  // within a group
  size_t pub;     // u64 [2][Nc][X words | Z words]: chains published for
                  // the exchange, by step parity
  size_t draws;   // f32 [iters][Nc][4 * n_blk]: the step's sweep log u
  size_t xlogu;   // f32 [Nc - 1]: exchange log u
  size_t gate;    // f32 [iters]: gate u
  size_t mlogu;   // f32 [iters]: Metropolis-mix log u
  size_t dwords;  // u32 [3 * iters * n_draws]: logical-draw words
  size_t perm, flag, cnt;  // i32 per rung position: [Nc], [Nc], [Nc][kCnt];
                           // perm is the rung's slot in the large variant
  size_t swacc, eqc;       // i32 [Nc - 1], [K]
  size_t scal;             // i32 [kScal + kCnt], the large variant only: the
                           // step's burn flag and thread 0's exchange state
  size_t group_bytes;
  // in the block
  size_t tab, group, meta, beta, bytes;

  __host__ __device__ explicit Layout(const WindowParams& P) {
    size_t off = 0;
    if constexpr (WIDE) {  // u32 [Nc][4 * nw + 1]: 2 bits a qubit, a padding word
      pub = take(off, 4 * (size_t)P.Nc * (4 * P.nw + 1));
      draws = take(off, 0);
    } else {
      pub = take(off, 8 * (size_t)2 * P.Nc * 2 * P.nw);
      draws = take(off, 4 * (size_t)P.iters * P.Nc * 4 * P.n_blk);
    }
    xlogu = take(off, 4 * (size_t)(P.Nc - 1));
    gate = take(off, 4 * (size_t)P.iters);
    mlogu = take(off, 4 * (size_t)P.iters);
    dwords = take(off, 4 * (size_t)3 * P.iters * P.n_draws);
    perm = take(off, 4 * (size_t)P.Nc);
    flag = take(off, 4 * (size_t)P.Nc);
    cnt = take(off, 4 * (size_t)P.Nc * kCnt);
    swacc = take(off, 4 * (size_t)(P.Nc - 1));
    eqc = take(off, 4 * (size_t)P.K);
    scal = take(off, WIDE ? 4 * (size_t)(kScal + kCnt) : 0);
    group_bytes = (off + 7) & ~(size_t)7;
    off = 0;
    tab = take(off, P.tab_in_smem ? 8 * (size_t)P.n_tab : 0);
    group = take(off, group_bytes * P.groups_per_block);
    meta = take(off, 4 * (size_t)P.n_meta);
    beta = take(off, 4 * (size_t)3 * P.Nc);
    bytes = off;
  }

 private:
  __host__ __device__ static size_t take(size_t& off, size_t n) {
    const size_t at = off;
    off += n;
    return at;
  }
};

__device__ __forceinline__ uint4 draw_block(const WindowParams& P, uint32_t g, uint32_t use,
                                            uint32_t step, uint32_t row) {
  return P.fixed ? make_uint4(P.fixed_word, P.fixed_word, P.fixed_word, P.fixed_word)
                 : philox4x32_10(make_uint4(g, use, step, row), P.key0, P.key1);
}

__device__ __forceinline__ float log_uniform(uint32_t bits) { return logf(uniform24(bits)); }

// Every thread of the group: a warp barrier, or the group's named barrier.
__device__ __forceinline__ void group_sync(int warps, int grp) {
  if (warps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(32 * warps) : "memory");
  }
}

// A position in the step's (iteration, rung, block) draw items, in that
// order: item k is block kb of rung r's uses in iteration it.
struct DrawItem {
  int k, it, r, kb;

  // move ``dk`` items on; dq = dk / n_blk and dkb = dk % n_blk
  __device__ __forceinline__ void advance(int dk, int dq, int dkb, int nblk, int Nc) {
    k += dk;
    kb += dkb;
    if (kb >= nblk) {
      kb -= nblk;
      ++dq;
    }
    for (r += dq; r >= Nc; r -= Nc) ++it;
  }
};

// Philox block and log u of item ``d``, stored if the item exists: the
// four logf are computed whatever the color's size, so a batch of items is
// straight-line code the compiler can interleave.
__device__ __forceinline__ void draw_item(const WindowParams& P, const int32_t* meta,
                                          float* draws, const DrawItem& d, int n_sweep, int t,
                                          int b) {
  const bool live = d.k < n_sweep;
  const int kb = live ? d.kb : 0;
  const int c = meta[P.m_bcol + kb];
  const int g = kb - meta[P.m_blk + c];
  const int n = meta[c + 1] - meta[c];
  const uint4 v = draw_block(P, (uint32_t)g, (uint32_t)((d.it * P.n_colors + c) * P.Nc + d.r),
                             (uint32_t)t, (uint32_t)b);
  float lu[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) lu[e] = log_uniform(word_of(v, e));
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (live && 4 * g + e < n) draws[4 * d.k + e] = lu[e];
}

// The step's draws past the sweeps, a thread taking the blocks x_first,
// x_first + GT, ...: the exchange's log u, and for a logical mix its gates,
// logical-draw words and Metropolis log u (layout: ops/ladder_window.py).
__device__ __forceinline__ void draw_extras(const WindowParams& P, float* xlogu, float* gate,
                                            float* mlogu, uint32_t* dwords, int x_first, int GT,
                                            int t, int b) {
  const int Nc = P.Nc;
  const int n_x = (Nc - 1 + 3) / 4;
  int n_g = 0, n_d = 0, n_m = 0;
  if (P.p_logical > 0.f) {
    n_g = (P.iters + 3) / 4;
    n_d = (3 * P.iters * P.n_draws + 3) / 4;
    n_m = P.top_exact ? 0 : (P.iters + 3) / 4;
  }
  const uint32_t G = (uint32_t)(P.iters * P.n_colors * Nc);
  for (int x0 = x_first; x0 < n_x + n_g + n_d + n_m; x0 += GT) {
    int x = x0;
    uint32_t use;
    int n;
    float* fout = nullptr;
    uint32_t* wout = nullptr;
    bool take_log = true;
    if (x < n_x) {  // exchange
      use = G + 2;
      n = Nc - 1;
      fout = xlogu;
    } else if ((x -= n_x) < n_g) {  // gates
      use = G;
      n = P.iters;
      fout = gate;
      take_log = false;
    } else if ((x -= n_g) < n_d) {  // logical draws
      use = G + 1;
      n = 3 * P.iters * P.n_draws;
      wout = dwords;
    } else {  // Metropolis mix
      x -= n_d;
      use = G + 3;
      n = P.iters;
      fout = mlogu;
    }
    const uint4 v = draw_block(P, (uint32_t)x, use, (uint32_t)t, (uint32_t)b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * x + e;
      if (i >= n) break;
      const uint32_t w = word_of(v, e);
      if (wout) {
        wout[i] = w;
      } else {
        fout[i] = take_log ? log_uniform(w) : uniform24(w);
      }
    }
  }
}

// The step's draws, over all the group's threads (item k = gt, gt + GT,
// ...): ``draws`` [iters][Nc][4 * n_blk] gets log u of element j of color
// c's use in iteration it on rung r at (it * Nc + r) * 4 * n_blk +
// 4 * blk[c] + j (item k's four elements at 4 * k); then the exchange's
// log u, and for a logical mix its gates, logical-draw words and
// Metropolis log u (draw_extras).  ``first`` are the thread's first
// kDrawBatch items, gt, gt + GT, ...; it takes kDrawBatch at a time, moving
// kDrawBatch * GT = dq * n_blk + dkb items on; ``k0`` is its first item
// past the sweeps, where its extras start, one at a time.
constexpr int kDrawBatch = 2;

__device__ __forceinline__ void draw_phase(const WindowParams& P, const int32_t* meta,
                                           float* draws, float* xlogu, float* gate,
                                           float* mlogu, uint32_t* dwords,
                                           const DrawItem (&first)[kDrawBatch], int dq, int dkb,
                                           int k0, int GT, int t, int b) {
  const int nblk = P.n_blk, Nc = P.Nc;
  const int n_sweep = P.iters * Nc * nblk;
  DrawItem items[kDrawBatch];
#pragma unroll
  for (int i = 0; i < kDrawBatch; ++i) items[i] = first[i];
  while (items[0].k < n_sweep) {
#pragma unroll
    for (int i = 0; i < kDrawBatch; ++i) draw_item(P, meta, draws, items[i], n_sweep, t, b);
#pragma unroll
    for (int i = 0; i < kDrawBatch; ++i) items[i].advance(kDrawBatch * GT, dq, dkb, nblk, Nc);
  }
  draw_extras(P, xlogu, gate, mlogu, dwords, k0 - n_sweep, GT, t, b);
}

// One color on a rung whose L lanes each hold the rung's planes (X, Z).
// Lane l decides stabilizers j = l, l + L, ... < n on the planes as they
// stood before the color (sweep.cuh::proposal_logr) and XORs the accepted
// ones' op masks into its flips; an XOR butterfly of shuffles over the
// rung's lanes then gives every lane all the color's flips, which it
// applies.  Every lane of the warp calls this (a padding lane with n = 0):
// the shuffles run on the whole warp, and offsets below L keep each
// exchange inside a rung's aligned lanes.  The supports are disjoint, so
// this equals the sequential visit (the TPU kernel's parallel accept).
// ``stab`` holds per stabilizer ``S`` (support, X op, Z op) words on the
// words ``span`` lists (zero-padded); ``du`` the color's log u.
template <int NW, int S, bool EQ>
__device__ __forceinline__ void sweep_color(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                            const uint64_t* stab, const int32_t* span, int c0,
                                            int n, int l, int L, const float* du, float bx,
                                            float by, float bz) {
  uint64_t fX[NW], fZ[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) fX[q] = fZ[q] = 0;
  for (int j = l; j < n; j += L) {
    const int s = c0 + j;
    const float u = du[j];
    int wm[S];
    uint64_t xm[S], zm[S];
    const float logr = proposal_logr<NW, S, EQ>(X, Z, stab + (size_t)s * 3 * S,
                                                (uint32_t)span[s], bx, by, bz, wm, xm, zm);
    // every uniform is < 1, so log u < 0 and logr >= 0 accepts: the same
    // decision as the plain version's comparison; a padded entry's masks
    // are zero and flip nothing
    if (logr >= 0.f || u < logr) add_flip<NW, S>(fX, fZ, wm, xm, zm);
  }
  apply_flips<NW>(X, Z, fX, fZ, L);
}

// Word w of the XOR of mix round ``it``'s gated logical masks
// (ops/pallas_ladder.py:478-574): per logical draw an op (bits24 % 4,
// through the family's op LUT) and X/Z positions (bits24 % n_pos), draw
// element (it * n_draws + i) * 3 + k.
__device__ __forceinline__ void mix_masks(const WindowParams& P, const uint64_t* tab,
                                          const int32_t* meta, const uint32_t* dwords, int it,
                                          int w, uint64_t& mx, uint64_t& mz) {
  const int nw = P.nw;
  mx = mz = 0;
  for (int i = 0; i < P.n_draws; ++i) {
    const int e = (it * P.n_draws + i) * 3;
    const uint32_t opb = (dwords[e] >> 8) % 4u;
    const int p0 = meta[P.m_draw + i];
    const uint32_t npos = (uint32_t)(meta[P.m_draw + i + 1] - p0);
    const uint32_t posx = (dwords[e + 1] >> 8) % npos;
    const uint32_t posz = (dwords[e + 2] >> 8) % npos;
    const int32_t* lut = meta + P.m_lut + (i * 4 + (int)opb) * 2;
    // per position: [x-mask X plane | x-mask Z plane | z-mask X | z-mask Z]
    if (lut[0]) {
      const uint64_t* xm = tab + (size_t)(p0 + posx) * 4 * nw;
      mx ^= xm[w];
      mz ^= xm[nw + w];
    }
    if (lut[1]) {
      const uint64_t* zm = tab + (size_t)(p0 + posz) * 4 * nw;
      mx ^= zm[2 * nw + w];
      mz ^= zm[3 * nw + w];
    }
  }
}

// The top rung's logical mix, each of its lanes on its own copy of the
// planes: with zero top betas every gated round is XORed in; otherwise
// each gated round is accepted iff logf(u) < -((btx*dN_x + bty*dN_y) +
// btz*dN_z) in f32.  An ungated round changes nothing either way.
template <int NW>
__device__ __forceinline__ void top_mix(const WindowParams& P, uint64_t (&X)[NW],
                                        uint64_t (&Z)[NW], const uint64_t* tab,
                                        const int32_t* meta, const float* bt, const float* gate,
                                        const float* mlogu, const uint32_t* dwords) {
  for (int it = 0; it < P.iters; ++it) {
    if (!(gate[it] < P.p_logical)) continue;
    uint64_t mX[NW], mZ[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) mix_masks(P, tab, meta, dwords, it, w, mX[w], mZ[w]);
    bool accept = P.top_exact;
    if (!accept) {
      int dx = 0, dy = 0, dz = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t x = X[w], z = Z[w], nx = x ^ mX[w], nz = z ^ mZ[w];
        dx += __popcll(nx & ~nz) - __popcll(x & ~z);
        dy += __popcll(nx & nz) - __popcll(x & z);
        dz += __popcll(~nx & nz) - __popcll(~x & z);
      }
      const float logr = -__fadd_rn(
          __fadd_rn(__fmul_rn(bt[0], (float)dx), __fmul_rn(bt[1], (float)dy)),
          __fmul_rn(bt[2], (float)dz));
      accept = logr >= 0.f || mlogu[it] < logr;
    }
    if (accept) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        X[w] ^= mX[w];
        Z[w] ^= mZ[w];
      }
    }
  }
}

template <int NW>
__device__ __forceinline__ int class_of(const uint64_t (&X)[NW], const uint64_t (&Z)[NW],
                                        const WindowParams& P, const uint64_t* tab,
                                        const int32_t* meta) {
  int bits = 0;
  for (int f = 0; f < P.n_bits; ++f) {
    const uint64_t* a = tab + P.off_class + (size_t)f * 2 * NW;
    int par = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) par += __popcll(a[w] & X[w]) + __popcll(a[NW + w] & Z[w]);
    bits |= (par & 1) << f;
  }
  return meta[P.m_b2e + bits];
}

// Component c of the chain hash, sum_q v_q * coef_c[q] with v_q the Pauli
// value (X 1, Y 2, Z 3), from the coefficients' bit planes: bit k of every
// coefficient of component c is the mask at (c * kKeyBits + k).
template <int NW>
__device__ __forceinline__ int32_t chain_key(const uint64_t (&X)[NW], const uint64_t (&Z)[NW],
                                             const uint64_t* keytab, int c) {
  int32_t key = 0;
  for (int k = 0; k < kKeyBits; ++k) {
    const uint64_t* m = keytab + (size_t)(c * kKeyBits + k) * NW;
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s += __popcll(X[w] & ~Z[w] & m[w]) + 2 * __popcll(X[w] & Z[w] & m[w]) +
           3 * __popcll(~X[w] & Z[w] & m[w]);
    }
    key += s << k;
  }
  return key;
}

// Steps 3-5 of a ladder step, on the group's thread 0, after the rungs
// published their counts (``cnt``).  3) Replica exchange on a permutation
// of the rungs: pair i = (i, i + 1) with its own uniform, element i;
// sequential top->bottom, or even pairs then odd pairs (disjoint within a
// phase, so deciding them one by one equals deciding them together).  A
// swap exchanges the pair's ``perm`` entries, counts and flags (the
// register form starts ``perm`` at the identity each step; the large
// variant keeps its rungs' slots there).  4) Flags (src/mcmc.py:100-103):
// set the top, count arrivals at the bottom.  5) The bottom rung's burn
// gate, since_burn, burn_first and energy sums, a row of energies per
// chunk.  Returns whether the step is burned.
template <bool EQ>
__device__ __forceinline__ bool exchange_step(const WindowParams& P, const WindowBuffers& buf,
                                              const float* beta, const float* xlogu,
                                              int32_t* perm, int32_t* flag, int32_t* cnt,
                                              int32_t* swacc, int t, int b, int& tops,
                                              int& since, int& bfirst,
                                              int (&esum)[Layout<EQ>::kCnt], int& chunk_left,
                                              int& chunk) {
  constexpr int kCnt = Layout<EQ>::kCnt;
  const int Nc = P.Nc;
  const int n_pairs = Nc - 1;
  for (int k = 0; k < n_pairs; ++k) {
    int i;
    if (P.even_odd) {
      const int n_even = (n_pairs + 1) / 2;
      i = k < n_even ? 2 * k : 2 * (k - n_even) + 1;
    } else {
      i = n_pairs - 1 - k;
    }
    const float* bl = beta + 3 * i;
    const float* bh = beta + 3 * (i + 1);
    int32_t* cl = cnt + i * kCnt;
    int32_t* ch = cnt + (i + 1) * kCnt;
    float logr;
    if constexpr (EQ) {
      logr = (bh[0] - bl[0]) * (float)(ch[0] - cl[0]);
    } else {
      // (dbx*dN_x + dby*dN_y) + dbz*dN_z, each operation rounded alone
      logr = __fadd_rn(
          __fadd_rn(__fmul_rn(__fsub_rn(bh[0], bl[0]), (float)(ch[0] - cl[0])),
                    __fmul_rn(__fsub_rn(bh[1], bl[1]), (float)(ch[1] - cl[1]))),
          __fmul_rn(__fsub_rn(bh[2], bl[2]), (float)(ch[2] - cl[2])));
    }
    if (logr >= 0.f || xlogu[i] < logr) {
      int32_t v = perm[i];
      perm[i] = perm[i + 1];
      perm[i + 1] = v;
      v = flag[i];
      flag[i] = flag[i + 1];
      flag[i + 1] = v;
#pragma unroll
      for (int q = 0; q < kCnt; ++q) {
        v = cl[q];
        cl[q] = ch[q];
        ch[q] = v;
      }
      ++swacc[i];
    }
  }
  flag[Nc - 1] = 1;
  if (flag[0] == 1) {
    ++tops;
    flag[0] = 0;
  }
  const bool burned = tops >= P.tops_burn;
  since += burned;
  if (bfirst < 0 && burned) bfirst = t;
#pragma unroll
  for (int k = 0; k < kCnt; ++k) esum[k] += cnt[k];
  if (--chunk_left == 0) {
    float e;
    if constexpr (EQ) {
      e = (P.w0 * (float)esum[0]) * P.inv_chunk;
    } else {
      e = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(P.w0, (float)esum[0]),
                                        __fmul_rn(P.w1, (float)esum[1])),
                              __fmul_rn(P.w2, (float)esum[2])),
                    P.inv_chunk);
    }
    buf.energies[(size_t)chunk++ * P.B + b] = e;
    chunk_left = P.energy_chunk;
#pragma unroll
    for (int k = 0; k < kCnt; ++k) esum[k] = 0;
  }
  return burned;
}

template <int NW>
__device__ __forceinline__ void load_planes(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                            const uint64_t* src) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    X[w] = src[w];
    Z[w] = src[NW + w];
  }
}

template <int NW, int S, bool EQ>
__global__ void __launch_bounds__(kMaxThreads, 1) ladder_window_kernel(const WindowParams P,
                                                                       const WindowBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<EQ> lay(P);
  constexpr int kCnt = Layout<EQ>::kCnt;
  const int tid = threadIdx.x;
  uint64_t* tab_copy = reinterpret_cast<uint64_t*>(smem_raw + lay.tab);
  int32_t* meta = reinterpret_cast<int32_t*>(smem_raw + lay.meta);
  float* beta = reinterpret_cast<float*>(smem_raw + lay.beta);
  if (P.tab_in_smem)
    for (int i = tid; i < P.n_tab; i += blockDim.x) tab_copy[i] = buf.tab[i];
  for (int i = tid; i < P.n_meta; i += blockDim.x) meta[i] = buf.meta[i];
  for (int i = tid; i < 3 * P.Nc; i += blockDim.x) beta[i] = buf.betas[i];
  __syncthreads();  // the block's only barrier: from here on groups are independent
  const uint64_t* tab = P.tab_in_smem ? tab_copy : buf.tab;

  const int GT = 32 * P.warps_per_group;  // threads per group
  const int grp = tid / GT, gt = tid - grp * GT;
  const int b = blockIdx.x * P.groups_per_block + grp;
  if (b >= P.B) return;
  unsigned char* gbase = smem_raw + lay.group + grp * lay.group_bytes;
  uint64_t* pub = reinterpret_cast<uint64_t*>(gbase + lay.pub);
  float* draws = reinterpret_cast<float*>(gbase + lay.draws);
  float* xlogu = reinterpret_cast<float*>(gbase + lay.xlogu);
  float* gate = reinterpret_cast<float*>(gbase + lay.gate);
  float* mlogu = reinterpret_cast<float*>(gbase + lay.mlogu);
  uint32_t* dwords = reinterpret_cast<uint32_t*>(gbase + lay.dwords);
  int32_t* perm = reinterpret_cast<int32_t*>(gbase + lay.perm);
  int32_t* flag = reinterpret_cast<int32_t*>(gbase + lay.flag);
  int32_t* cnt = reinterpret_cast<int32_t*>(gbase + lay.cnt);
  int32_t* swacc = reinterpret_cast<int32_t*>(gbase + lay.swacc);
  int32_t* eqc = reinterpret_cast<int32_t*>(gbase + lay.eqc);

  const int Nc = P.Nc, nq = P.nq, L = P.lanes, K = P.K;
  const int r = gt >> P.lane_shift, l = gt & (L - 1);
  const bool in_rung = r < Nc;
  const int wpg = P.warps_per_group;
  const size_t chain = 2 * NW;  // u64 per published chain

  // load: the chains are built in the odd buffer (step 0 publishes to the
  // even one), bits ORed in by 32-bit halves
  uint64_t* start = pub + Nc * chain;
  for (int i = gt; i < Nc * (int)chain; i += GT) start[i] = 0;
  for (int i = gt; i < Nc; i += GT) flag[i] = buf.flag_in[(size_t)b * Nc + i];
  for (int i = gt; i < Nc - 1; i += GT) swacc[i] = 0;
  for (int i = gt; i < K; i += GT) eqc[i] = buf.eq_in[(size_t)b * K + i];
  group_sync(wpg, grp);
  {
    const uint8_t* src = buf.state_in + (size_t)b * Nc * nq;
    for (int i = gt; i < Nc * nq; i += GT) {
      const uint32_t v = src[i];
      if (!v) continue;
      const int rr = i / nq, q = i - rr * nq;
      unsigned* pl = reinterpret_cast<unsigned*>(start + rr * chain);
      const unsigned bit = 1u << (q & 31);
      if ((v ^ (v >> 1)) & 1u) atomicOr(pl + (q >> 5), bit);
      if ((v >> 1) & 1u) atomicOr(pl + 2 * NW + (q >> 5), bit);
    }
  }
  int tops = 0, since = 0, bfirst = -1;
  int esum[kCnt];
#pragma unroll
  for (int k = 0; k < kCnt; ++k) esum[k] = 0;
  if (gt == 0) {
    tops = buf.tops_in[b];
    since = buf.since_in[b];
  }
  float bx = 0.f, by = 0.f, bz = 0.f;
  if (in_rung) {
    bx = beta[3 * r];
    by = beta[3 * r + 1];
    bz = beta[3 * r + 2];
  }
  const uint64_t* stab = tab + P.off_span;
  const int32_t* span = meta + P.m_span;
  // this thread's first draw items of every step
  DrawItem first[kDrawBatch];
  first[0] = DrawItem{gt, gt / P.n_blk / Nc, (gt / P.n_blk) % Nc, gt % P.n_blk};
  for (int i = 1; i < kDrawBatch; ++i) {
    first[i] = first[i - 1];
    first[i].advance(GT, GT / P.n_blk, GT % P.n_blk, P.n_blk, Nc);
  }
  const int dq = kDrawBatch * GT / P.n_blk, dkb = kDrawBatch * GT % P.n_blk;
  const int n_sweep = P.iters * Nc * P.n_blk;
  const int k0 = gt < n_sweep ? gt + (n_sweep - gt + GT - 1) / GT * GT : gt;
  int chunk_left = P.energy_chunk, chunk = 0;  // steps to the next energy row
  group_sync(wpg, grp);
  uint64_t X[NW], Z[NW];  // rung r's chain, in every lane of the rung
#pragma unroll
  for (int w = 0; w < NW; ++w) X[w] = Z[w] = 0;
  if (in_rung) load_planes(X, Z, start + r * chain);

  for (int t = 0; t < P.window; ++t) {
    draw_phase(P, meta, draws, xlogu, gate, mlogu, dwords, first, dq, dkb, k0, GT, t, b);
    group_sync(wpg, grp);
    uint64_t* pub_t = pub + (t & 1) * Nc * chain;
    // 1) colored sweeps; use of color c in iteration it on rung r
    for (int it = 0; it < P.iters; ++it) {
      const float* du = draws + (size_t)(it * Nc + (in_rung ? r : 0)) * 4 * P.n_blk;
      for (int c = 0; c < P.n_colors; ++c) {
        const int c0 = meta[c];
        sweep_color<NW, S, EQ>(X, Z, stab, span, c0, in_rung ? meta[c + 1] - c0 : 0, l, L,
                               du + 4 * meta[P.m_blk + c], bx, by, bz);
      }
    }
    if (in_rung) {
      // 2) top-rung logical mix
      if (r == Nc - 1 && P.p_logical > 0.f)
        top_mix<NW>(P, X, Z, tab, meta, beta + 3 * r, gate, mlogu, dwords);
      // publish the chain and its counts after the mix
      if (l == 0) {
        int n[kCnt];
#pragma unroll
        for (int k = 0; k < kCnt; ++k) n[k] = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          pub_t[r * chain + w] = X[w];
          pub_t[r * chain + NW + w] = Z[w];
          if constexpr (EQ) {
            n[0] += __popcll(X[w] | Z[w]);
          } else {
            n[0] += __popcll(X[w] & ~Z[w]);
            n[1] += __popcll(X[w] & Z[w]);
            n[2] += __popcll(~X[w] & Z[w]);
          }
        }
#pragma unroll
        for (int k = 0; k < kCnt; ++k) cnt[r * kCnt + k] = n[k];
      }
    }
    group_sync(wpg, grp);
    int burned = 0;
    if (gt == 0) {
      for (int k = 0; k < Nc; ++k) perm[k] = k;
      burned = exchange_step<EQ>(P, buf, beta, xlogu, perm, flag, cnt, swacc, t, b, tops, since,
                                 bfirst, esum, chunk_left, chunk);
    }
    group_sync(wpg, grp);
    if (in_rung) load_planes(X, Z, pub_t + perm[r] * chain);
    // the bottom rung's class (thread 0) and, in trace mode, its chain
    // hash, component c on lane c % L
    if (r == 0) {
      const size_t row = (size_t)t * P.B + b;
      if (gt == 0 && (burned || P.traces)) {
        const int cls = class_of<NW>(X, Z, P, tab, meta);
        if (burned) ++eqc[cls];
        if (P.traces) buf.eq_trace[row] = cls;
      }
      if (P.traces)
        for (int c = l; c < kKeys; c += L)
          buf.key_trace[row * kKeys + c] = chain_key<NW>(X, Z, tab + P.off_key, c);
    }
  }
  group_sync(wpg, grp);

  if (in_rung) {
    uint8_t* dst = buf.state_out + ((size_t)b * Nc + r) * nq;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      for (int k = l; k < 64 && w * 64 + k < nq; k += L) {
        const uint32_t x = (uint32_t)(X[w] >> k) & 1u, z = (uint32_t)(Z[w] >> k) & 1u;
        dst[w * 64 + k] = (uint8_t)(x ^ (z * 3u));
      }
    }
  }
  for (int i = gt; i < Nc; i += GT) buf.flag_out[(size_t)b * Nc + i] = flag[i];
  for (int i = gt; i < K; i += GT) buf.eq_out[(size_t)b * K + i] = eqc[i];
  for (int i = gt; i < Nc - 1; i += GT) buf.swap_acc[(size_t)b * (Nc - 1) + i] = swacc[i];
  if (gt == 0) {
    buf.tops_out[b] = tops;
    buf.since_out[b] = since;
    buf.burn_any[b] = bfirst >= 0 ? 1 : 0;
    buf.burn_first[b] = bfirst > 0 ? bfirst : 0;
  }
}

// ---------------------------------------------------------------------------
// The large variant: planes in shared memory, 2 bits a qubit
// ---------------------------------------------------------------------------

// The per-qubit helpers (entry_*, load_block, block_accepts, spread16,
// compact16) are in sweep.cuh, shared with the sweep kernel's large variant.

// One color on a rung whose chain sits in slot ``W``: lane l takes the
// color's Philox blocks g = l, l + L, ... whole, at the counter the register
// form stages (use (it * n_colors + c) * Nc + r).  Per block it first
// issues the next block's loads, then decides its four stabilizers on the
// states it loaded, then XORs the accepted ones in (their entries read
// again).  The supports of a color are disjoint and a decision reads only
// its own qubits, which no other stabilizer of the color flips, so every
// order of loads and flips decides as the planes before the color do; the
// caller's __syncwarp closes the color.  A padded entry's ops are 0: it
// flips nothing and its entry is not read again.  The rung's betas ``br``
// are read from shared memory a block at a time, not held in registers
// across the window.
template <bool EQ>
__device__ __forceinline__ void sweep_color_wide(const WindowParams& P, uint32_t* W,
                                                 const uint64_t* qtab, int c0, int n, int l,
                                                 int L, uint32_t use, int t, int b,
                                                 const float* br) {
  const int nb = (n + 3) >> 2;
  if (l >= nb) return;
  uint32_t st, ops;
  load_block(W, qtab, c0, n, l, st, ops);
  for (int g = l; g < nb; g += L) {
    uint32_t st_n, ops_n;
    load_block(W, qtab, c0, g + L < nb ? n : 0, g + L, st_n, ops_n);
    const uint4 v = draw_block(P, (uint32_t)g, use, (uint32_t)t, (uint32_t)b);
    const unsigned acc = block_accepts<EQ>(st, ops, v, br[0], EQ ? 0.f : br[1],
                                           EQ ? 0.f : br[2]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (((acc >> e) & 1u) && ((ops >> (8 * e)) & 255u)) entry_flip(W, qtab[c0 + 4 * g + e]);
    st = st_n;
    ops = ops_n;
  }
}

// Sum of ``v`` over the L lanes of a rung (``mask``: its lanes).
__device__ __forceinline__ int rung_sum(int v, unsigned mask, int L) {
  for (int k = 1; k < L; k <<= 1) v += __shfl_xor_sync(mask, v, k);
  return v;
}

// The X and Z plane words w (qubits 64w .. 64w + 63) of a slot.
__device__ __forceinline__ void plane_words(const uint32_t* W, int w, uint64_t& x, uint64_t& z) {
  x = z = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t u = W[4 * w + h];
    x |= (uint64_t)compact16(u) << (16 * h);
    z |= (uint64_t)compact16(u >> 1) << (16 * h);
  }
}

// XOR plane words (mx, mz) into word w of a slot.
__device__ __forceinline__ void xor_plane_words(uint32_t* W, int w, uint64_t mx, uint64_t mz) {
#pragma unroll
  for (int h = 0; h < 4; ++h)
    W[4 * w + h] ^= spread16((uint32_t)(mx >> (16 * h))) |
                    (spread16((uint32_t)(mz >> (16 * h))) << 1);
}

// top_mix on the top rung's slot: lane l takes the plane words w = l, l +
// L, ...; a Metropolis round sums the count changes over the rung's lanes,
// so every lane takes the one decision alike.
__device__ __forceinline__ void top_mix_wide(const WindowParams& P, uint32_t* W,
                                             const uint64_t* tab, const int32_t* meta,
                                             const float* bt, const float* gate,
                                             const float* mlogu, const uint32_t* dwords, int l,
                                             int L, unsigned mask) {
  const int nw = P.nw;
  for (int it = 0; it < P.iters; ++it) {
    if (!(gate[it] < P.p_logical)) continue;
    bool accept = P.top_exact;
    if (!accept) {
      int dx = 0, dy = 0, dz = 0;
      for (int w = l; w < nw; w += L) {
        uint64_t mx, mz, x, z;
        mix_masks(P, tab, meta, dwords, it, w, mx, mz);
        plane_words(W, w, x, z);
        const uint64_t nx = x ^ mx, nz = z ^ mz;
        dx += __popcll(nx & ~nz) - __popcll(x & ~z);
        dy += __popcll(nx & nz) - __popcll(x & z);
        dz += __popcll(~nx & nz) - __popcll(~x & z);
      }
      dx = rung_sum(dx, mask, L);
      dy = rung_sum(dy, mask, L);
      dz = rung_sum(dz, mask, L);
      const float logr = -__fadd_rn(
          __fadd_rn(__fmul_rn(bt[0], (float)dx), __fmul_rn(bt[1], (float)dy)),
          __fmul_rn(bt[2], (float)dz));
      accept = logr >= 0.f || mlogu[it] < logr;
    }
    if (accept) {
      for (int w = l; w < nw; w += L) {
        uint64_t mx, mz;
        mix_masks(P, tab, meta, dwords, it, w, mx, mz);
        xor_plane_words(W, w, mx, mz);
      }
    }
  }
}

// class_of on a slot, the words split over the rung's lanes and their
// parities XORed together; every lane gets the class (``gmeta``: the meta
// in device memory, where bits_to_eq is).
__device__ __forceinline__ int class_of_wide(const uint32_t* W, const WindowParams& P,
                                             const uint64_t* tab, const int32_t* gmeta, int l,
                                             int L, unsigned mask) {
  const int nw = P.nw;
  int bits = 0;
  for (int w = l; w < nw; w += L) {
    uint64_t x, z;
    plane_words(W, w, x, z);
    for (int f = 0; f < P.n_bits; ++f) {
      const uint64_t* a = tab + P.off_class + (size_t)f * 2 * nw;
      bits ^= ((__popcll(a[w] & x) + __popcll(a[nw + w] & z)) & 1) << f;
    }
  }
  for (int k = 1; k < L; k <<= 1) bits ^= __shfl_xor_sync(mask, bits, k);
  return gmeta[P.m_b2e + bits];
}

// chain_key's four components on a slot, the words split over the rung's
// lanes and summed (the sums are exact integers, so the order is free).
__device__ __forceinline__ void chain_keys_wide(const uint32_t* W, int nw, const uint64_t* keytab,
                                                int l, int L, unsigned mask,
                                                int32_t (&key)[kKeys]) {
#pragma unroll
  for (int c = 0; c < kKeys; ++c) key[c] = 0;
  for (int w = l; w < nw; w += L) {
    uint64_t x, z;
    plane_words(W, w, x, z);
    const uint64_t ex = x & ~z, ey = x & z, ez = ~x & z;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      for (int k = 0; k < kKeyBits; ++k) {
        const uint64_t m = keytab[(size_t)(c * kKeyBits + k) * nw + w];
        key[c] += (__popcll(ex & m) + 2 * __popcll(ey & m) + 3 * __popcll(ez & m)) << k;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kKeys; ++c) key[c] = rung_sum(key[c], mask, L);
}

// ladder_window_kernel for the ladders of the large variant (the header).
// The word count is a run-time value.  Each rung's chain sits in a slot of
// its group's shared memory (4 * nw + 1 words of 32 bits, 2 bits a qubit,
// the last a padding word against bank conflicts between slots); a rung's
// L lanes sit in one warp and each decides its Philox blocks of a color
// (sweep_color_wide), so no draw is staged and shared memory does not grow
// with iters * Nc.  The exchange swaps slot indices (``slot`` holds each
// rung's slot across steps), not planes, and the state is written back
// through them at the end of the window.  Every other draw, the exchange,
// flags and readouts are the register form's.
template <bool EQ>
__global__ void __launch_bounds__(kWideMaxThreads, 1)
    ladder_window_kernel_wide(const WindowParams P, const WindowBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<EQ, true> lay(P);
  constexpr int kCnt = Layout<EQ>::kCnt;
  const int tid = threadIdx.x;
  uint64_t* qtab_copy = reinterpret_cast<uint64_t*>(smem_raw + lay.tab);
  int32_t* meta = reinterpret_cast<int32_t*>(smem_raw + lay.meta);
  float* beta = reinterpret_cast<float*>(smem_raw + lay.beta);
  if (P.tab_in_smem)
    for (int i = tid; i < P.n_tab; i += blockDim.x) qtab_copy[i] = buf.qtab[i];
  for (int i = tid; i < P.n_meta; i += blockDim.x) meta[i] = buf.meta[i];
  for (int i = tid; i < 3 * P.Nc; i += blockDim.x) beta[i] = buf.betas[i];
  __syncthreads();  // the block's only barrier: from here on groups are independent
  const uint64_t* tab = buf.tab;

  const int GT = 32 * P.warps_per_group;  // threads per group
  const int grp = tid / GT, gt = tid - grp * GT;
  const int b = blockIdx.x * P.groups_per_block + grp;
  if (b >= P.B) return;
  unsigned char* gbase = smem_raw + lay.group + grp * lay.group_bytes;
  uint32_t* planes = reinterpret_cast<uint32_t*>(gbase + lay.pub);
  float* xlogu = reinterpret_cast<float*>(gbase + lay.xlogu);
  float* gate = reinterpret_cast<float*>(gbase + lay.gate);
  float* mlogu = reinterpret_cast<float*>(gbase + lay.mlogu);
  uint32_t* dwords = reinterpret_cast<uint32_t*>(gbase + lay.dwords);
  int32_t* slot = reinterpret_cast<int32_t*>(gbase + lay.perm);
  int32_t* flag = reinterpret_cast<int32_t*>(gbase + lay.flag);
  int32_t* cnt = reinterpret_cast<int32_t*>(gbase + lay.cnt);
  int32_t* swacc = reinterpret_cast<int32_t*>(gbase + lay.swacc);
  int32_t* eqc = reinterpret_cast<int32_t*>(gbase + lay.eqc);
  // thread 0's exchange state sits in shared memory, not in every thread's
  // registers: burned, tops, since, bfirst, chunk_left, chunk, esum[kCnt]
  int32_t* scal = reinterpret_cast<int32_t*>(gbase + lay.scal);
  int(&esum)[kCnt] = *reinterpret_cast<int(*)[kCnt]>(scal + Layout<EQ>::kScal);

  const int Nc = P.Nc, nq = P.nq, nw = P.nw, L = P.lanes, K = P.K;
  const int r = gt >> P.lane_shift, l = gt & (L - 1);
  const bool in_rung = r < Nc;
  const int wpg = P.warps_per_group;
  const int n16 = 4 * nw;       // words of 16 qubits per chain
  const size_t cs = n16 + 1;    // u32 per slot
  // the rung's lanes within their warp, for the sums over them
  const unsigned mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << ((unsigned)(gt & 31) & ~(unsigned)(L - 1));

  // load: rung r's chain into slot r, a qubit's 2 bits ORed in
  for (size_t i = gt; i < (size_t)Nc * cs; i += GT) planes[i] = 0;
  for (int i = gt; i < Nc; i += GT) {
    flag[i] = buf.flag_in[(size_t)b * Nc + i];
    slot[i] = i;
  }
  for (int i = gt; i < Nc - 1; i += GT) swacc[i] = 0;
  for (int i = gt; i < K; i += GT) eqc[i] = buf.eq_in[(size_t)b * K + i];
  group_sync(wpg, grp);
  {
    const uint8_t* src = buf.state_in + (size_t)b * Nc * nq;
    for (int i = gt; i < Nc * nq; i += GT) {
      const uint32_t v = src[i];
      if (!v) continue;
      const int rr = i / nq, q = i - rr * nq;
      const uint32_t s = ((v ^ (v >> 1)) & 1u) | (v & 2u);  // x | z << 1
      atomicOr(planes + rr * cs + (q >> 4), s << ((q & 15) << 1));
    }
  }
  if (gt == 0) {
    scal[1] = buf.tops_in[b];
    scal[2] = buf.since_in[b];
    scal[3] = -1;
    scal[4] = P.energy_chunk;  // steps to the next energy row
    scal[5] = 0;
#pragma unroll
    for (int k = 0; k < kCnt; ++k) esum[k] = 0;
  }
  group_sync(wpg, grp);

  for (int t = 0; t < P.window; ++t) {
    draw_extras(P, xlogu, gate, mlogu, dwords, gt, GT, t, b);
    uint32_t* W = planes + (in_rung ? (size_t)slot[r] : 0) * cs;
    // 1) colored sweeps; use of color c in iteration it on rung r.  The
    // qubit table's place is decided here, so each inlined sweep reads it
    // through a pointer of one address space
    for (int it = 0; it < P.iters; ++it) {
      for (int c = 0; c < P.n_colors; ++c) {
        const int c0 = meta[c], n = in_rung ? meta[c + 1] - c0 : 0;
        const uint32_t use = (uint32_t)((it * P.n_colors + c) * Nc + r);
        if (P.tab_in_smem)
          sweep_color_wide<EQ>(P, W, qtab_copy, c0, n, l, L, use, t, b, beta + 3 * r);
        else
          sweep_color_wide<EQ>(P, W, buf.qtab, c0, n, l, L, use, t, b, beta + 3 * r);
        __syncwarp();  // every flip of the color is in before the next reads
      }
    }
    group_sync(wpg, grp);  // the step's extra draws are in
    if (in_rung) {
      // 2) top-rung logical mix
      if (r == Nc - 1 && P.p_logical > 0.f)
        top_mix_wide(P, W, tab, meta, beta + 3 * r, gate, mlogu, dwords, l, L, mask);
      // the rung's counts after the mix, over its lanes' words
      int n[kCnt];
#pragma unroll
      for (int k = 0; k < kCnt; ++k) n[k] = 0;
      for (int k = l; k < n16; k += L) {
        const uint32_t u = W[k], x = u & 0x55555555u, z = (u >> 1) & 0x55555555u;
        if constexpr (EQ) {
          n[0] += __popc(x | z);
        } else {
          n[0] += __popc(x & ~z);
          n[1] += __popc(x & z);
          n[2] += __popc(z & ~x);
        }
      }
#pragma unroll
      for (int k = 0; k < kCnt; ++k) n[k] = rung_sum(n[k], mask, L);
      if (l == 0)
#pragma unroll
        for (int k = 0; k < kCnt; ++k) cnt[r * kCnt + k] = n[k];
    }
    group_sync(wpg, grp);
    if (gt == 0)
      scal[0] = exchange_step<EQ>(P, buf, beta, xlogu, slot, flag, cnt, swacc, t, b, scal[1],
                                  scal[2], scal[3], esum, scal[4], scal[5]);
    group_sync(wpg, grp);
    // the bottom rung's class (counted on thread 0) and, in trace mode, its
    // chain hash, over the bottom rung's lanes
    if (r == 0) {
      const uint32_t* W0 = planes + (size_t)slot[0] * cs;
      const size_t row = (size_t)t * P.B + b;
      const bool now = scal[0] != 0;
      if (now || P.traces) {
        const int cls = class_of_wide(W0, P, tab, buf.meta, l, L, mask);
        if (gt == 0) {
          if (now) ++eqc[cls];
          if (P.traces) buf.eq_trace[row] = cls;
        }
      }
      if (P.traces) {
        int32_t key[kKeys];
        chain_keys_wide(W0, nw, tab + P.off_key, l, L, mask, key);
        if (l == 0)
#pragma unroll
          for (int c = 0; c < kKeys; ++c) buf.key_trace[row * kKeys + c] = key[c];
      }
    }
    __syncwarp();  // the bottom rung is read before its next sweep
  }
  group_sync(wpg, grp);

  // store: rung r's chain from its slot
  {
    uint8_t* dst = buf.state_out + (size_t)b * Nc * nq;
    for (int i = gt; i < Nc * nq; i += GT) {
      const int rr = i / nq, q = i - rr * nq;
      const uint32_t s = (planes[(size_t)slot[rr] * cs + (q >> 4)] >> ((q & 15) << 1)) & 3u;
      dst[i] = (uint8_t)((s & 1u) ^ ((s >> 1) * 3u));
    }
  }
  for (int i = gt; i < Nc; i += GT) buf.flag_out[(size_t)b * Nc + i] = flag[i];
  for (int i = gt; i < K; i += GT) buf.eq_out[(size_t)b * K + i] = eqc[i];
  for (int i = gt; i < Nc - 1; i += GT) buf.swap_acc[(size_t)b * (Nc - 1) + i] = swacc[i];
  if (gt == 0) {
    const int bfirst = scal[3];
    buf.tops_out[b] = scal[1];
    buf.since_out[b] = scal[2];
    buf.burn_any[b] = bfirst >= 0 ? 1 : 0;
    buf.burn_first[b] = bfirst > 0 ? bfirst : 0;
  }
}

// The kernel of ``F<NW, S, EQ>``: a register instantiation, or the large
// variant for NW == kWide (which reads no spanned words: S is 0 there).
template <int NW, int S, bool EQ>
inline void (*kernel_of())(const WindowParams, const WindowBuffers) {
  if constexpr (NW == kWide)
    return ladder_window_kernel_wide<EQ>;
  else
    return ladder_window_kernel<NW, S, EQ>;
}

template <int NW, int S, bool EQ>
cudaError_t launch(const WindowParams& P, const WindowBuffers& buf, cudaStream_t stream) {
  const int threads = 32 * P.warps_per_group * P.groups_per_block;
  if (P.lanes < 1 || P.lanes > 32 || (1 << P.lane_shift) != P.lanes ||
      P.Nc * P.lanes > 32 * P.warps_per_group ||
      threads > (NW == kWide ? kWideMaxThreads : kMaxThreads) ||
      (P.warps_per_group > 1 && P.groups_per_block > kMaxBarriers))
    return cudaErrorInvalidValue;
  if (P.traces && (buf.eq_trace == nullptr || buf.key_trace == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Layout<EQ, NW == kWide>(P).bytes;
  if (smem != (size_t)P.smem) return cudaErrorInvalidValue;  // the wrapper's plan differs
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of<NW, S, EQ>(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (P.B + P.groups_per_block - 1) / P.groups_per_block;
  if constexpr (NW == kWide)
    ladder_window_kernel_wide<EQ><<<blocks, threads, smem, stream>>>(P, buf);
  else
    ladder_window_kernel<NW, S, EQ><<<blocks, threads, smem, stream>>>(P, buf);
  return cudaGetLastError();
}

template <int NW, int S, bool EQ>
int resident_blocks(const WindowParams& P) {
  const size_t smem = Layout<EQ, NW == kWide>(P).bytes;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel_of<NW, S, EQ>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of<NW, S, EQ>(), 32 * P.warps_per_group * P.groups_per_block,
          smem) != cudaSuccess)
    return -1;
  return n;
}

template <int NW, int S, bool EQ>
struct Launch {
  static int run(const WindowParams& P, const WindowBuffers* buf, cudaStream_t st) {
    return (int)launch<NW, S, EQ>(P, *buf, st);
  }
};

template <int NW, int S, bool EQ>
struct Resident {
  static int run(const WindowParams& P) { return resident_blocks<NW, S, EQ>(P); }
};

// Run ``F<NW, S, EQ>`` for the launch's words per plane, spanned words per
// stabilizer (ops/ladder_window.py::WINDOW_SHAPES; in the large variant,
// NW = kWide and S = 0, any word count up to kWideWords, every stabilizer
// of at most four qubits) and sweep form, or return ``bad``.
template <template <int, int, bool> class F, class... A>
int dispatch(const WindowParams& P, int bad, A... args) {
  const bool eq = P.equal_betas != 0;
  if (P.wide) {
    if (P.nw > kWideWords || (size_t)P.nw * 64 < (size_t)P.nq) return bad;
    return eq ? F<kWide, 0, true>::run(P, args...) : F<kWide, 0, false>::run(P, args...);
  }
#define MQT_SHAPE(W, SP)                                            \
  if (P.nw == W && P.span == SP)                                   \
    return eq ? F<W, SP, true>::run(P, args...) : F<W, SP, false>::run(P, args...);
  MQT_SHAPE(1, 1)
  MQT_SHAPE(2, 2)
  MQT_SHAPE(3, 2)
  MQT_SHAPE(3, 4)
  MQT_SHAPE(4, 2)
  MQT_SHAPE(4, 4)
#undef MQT_SHAPE
  return bad;
}

}  // namespace mqt

// Launch one window on ``stream``; returns the cudaError_t of the launch
// (0 on success).  Asynchronous: a fault during the run shows at the next
// synchronisation.
extern "C" int mqt_ladder_window(const mqt::WindowParams* P, const mqt::WindowBuffers* buf,
                                 void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  if (P->B <= 0 || P->Nc <= 0 || P->groups_per_block <= 0) return (int)cudaErrorInvalidValue;
  return mqt::dispatch<mqt::Launch>(*P, (int)cudaErrorInvalidValue, buf,
                                    static_cast<cudaStream_t>(stream));
}

// Blocks of the launch ``P`` describes that one SM holds at once (the
// occupancy calculator's answer for its threads, registers and shared
// memory), or -1.
extern "C" int mqt_ladder_window_resident_blocks(const mqt::WindowParams* P) {
  (void)cudaGetLastError();
  return mqt::dispatch<mqt::Resident>(*P, -1);
}
