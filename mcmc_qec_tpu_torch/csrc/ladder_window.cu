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
//      planes, counts and flags;
//   4. the top flag is set; a flag reaching the bottom increments tops0;
//   5. the bottom rung is observed: burn gate, since_burn, burn_first, the
//      class histogram, per-chunk mean energies and, in trace mode, the
//      per-step class and 4-component chain hash.
// The plain PyTorch version is ops/ladder_window.py::ladder_window_reference;
// both draw the same Philox4x32-10 bits, so they agree trajectory for
// trajectory.
//
// What bounds it on this card: almost no bytes move (the state is read once
// and written once per window; at toric d=5 a rung is two 64-bit words), so
// the bound is instruction issue: integer and popc work for the proposals
// (two 64-bit popcounts per word in the equal form, six in the general
// one), the ten Philox rounds per four draws, and the precise logf of each
// proposal whose acceptance test can fail, all serialised over the
// window's steps.  At B=2048 x Nc=5 there are only 10,240 chains, one
// thread each: about 2.4 warps per SM, far too few to hide instruction
// latency, so one thread's chain of dependent steps sets the time (on an
// H100 the window takes about as long at B=64 as at B=2048).  The design
// keeps everything in registers (planes) and shared memory (tables,
// exchange, histogram), skips logf when the proposal cannot be rejected,
// and spreads the syndromes thinly over blocks so every SM gets work.
// Splitting a rung's proposals over several threads is the next step
// (PERF.md).
//
// Layout: one thread per (syndrome, rung); a block holds ``spb`` syndromes'
// Nc threads (thread s * Nc + r).  Replica exchange goes through shared
// memory: every rung publishes its planes, counts and flag, the bottom
// thread of each syndrome runs the exchange on a permutation, and every
// rung then reads the planes the permutation sends it.  Published slots are
// double-buffered by step parity, so two barriers per step suffice.  The
// bottom thread writes trace rows straight to device memory.  Planes are
// 1, 2, 3, 4, 6, 8 or 12 64-bit words (toric d=19 has nq = 722); the
// tables sit in shared memory unless they leave no room for the ladder
// (above about 200 KB, toric d=19), when they are read from device memory.
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
  int32_t window, iters, tops_burn, energy_chunk, fixed, spb;
  int32_t n_tab, n_meta, off_draw, off_class, off_key, m_draw, m_lut, m_b2e;
  int32_t equal_betas, top_exact, even_odd, traces, tab_in_smem;
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
  const uint64_t* tab;  // stabilizer, logical-draw, class and hash masks
  const int32_t* meta;  // color starts, draw starts, op LUT, bits_to_eq
};

// Threads per block at NW words per plane (ops/ladder_window.py::max_threads):
// wider planes need more registers per thread.
template <int NW>
constexpr int kMaxThreads = NW <= 2 ? 1024 : NW <= 4 ? 512 : 256;

constexpr int kKeys = 4;     // hash components
constexpr int kKeyBits = 6;  // bits per hash coefficient

// Shared memory of one block; ops/ladder_window.py::smem_bytes mirrors it.
template <int NW, bool EQ>
struct Smem {
  static constexpr int kCnt = EQ ? 1 : 3;  // counts published per slot
  uint64_t* tab_copy;  // the tables' shared copy, or nullptr
  const uint64_t* tab;  // where the kernel reads the tables
  uint64_t* planes;  // [2][slots][2 * NW]
  int32_t* meta;
  float* beta;       // [Nc][3]
  int32_t* cnt;      // [2][slots][kCnt]
  int32_t* flg;      // [2][slots]
  int32_t* perm;     // [slots]
  int32_t* swacc;    // [spb][Nc - 1]
  int32_t* eqc;      // [spb][K]
  size_t bytes;

  __host__ __device__ Smem(const WindowParams& P, unsigned char* base,
                           const uint64_t* tab_global) {
    const size_t slots = (size_t)P.spb * P.Nc;
    size_t off = 0;
    if (P.tab_in_smem) {
      tab_copy = reinterpret_cast<uint64_t*>(base + off);
      tab = tab_copy;
      off += sizeof(uint64_t) * P.n_tab;
    } else {
      tab_copy = nullptr;
      tab = tab_global;
    }
    planes = reinterpret_cast<uint64_t*>(base + off);
    off += sizeof(uint64_t) * 2 * slots * 2 * NW;
    meta = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * P.n_meta;
    beta = reinterpret_cast<float*>(base + off);
    off += sizeof(float) * 3 * P.Nc;
    cnt = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * 2 * slots * kCnt;
    flg = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * 2 * slots;
    perm = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * slots;
    swacc = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * P.spb * (P.Nc - 1);
    eqc = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * P.spb * P.K;
    bytes = off;
  }
};

// The gated logical masks of mix round ``it`` XORed into (X, Z)
// (ops/pallas_ladder.py:478-574): a gate u < p_logical and, per logical
// draw, an op (bits24 % 4, through the family's op LUT) and X/Z positions
// (bits24 % n_pos).  Draw element (it * n_draws + i) * 3 + k.
template <int NW>
__device__ __forceinline__ void xor_round(uint64_t (&X)[NW], uint64_t (&Z)[NW], int it,
                                          const WindowParams& P, const uint64_t* tab,
                                          const int32_t* meta, DrawStream& gate_rng,
                                          DrawStream& draw_rng) {
  const bool gate = uniform24(gate_rng(it)) < P.p_logical;
  for (int i = 0; i < P.n_draws; ++i) {
    const int e = (it * P.n_draws + i) * 3;
    const uint32_t opb = (draw_rng(e) >> 8) % 4u;
    const int p0 = meta[P.m_draw + i];
    const uint32_t npos = (uint32_t)(meta[P.m_draw + i + 1] - p0);
    const uint32_t posx = (draw_rng(e + 1) >> 8) % npos;
    const uint32_t posz = (draw_rng(e + 2) >> 8) % npos;
    if (!gate) continue;
    const int32_t* lut = meta + P.m_lut + (i * 4 + (int)opb) * 2;
    // per position: [x-mask X plane | x-mask Z plane | z-mask X | z-mask Z]
    const uint64_t* xm = tab + P.off_draw + (size_t)(p0 + posx) * 4 * NW;
    const uint64_t* zm = tab + P.off_draw + (size_t)(p0 + posz) * 4 * NW;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (lut[0]) {
        X[w] ^= xm[w];
        Z[w] ^= xm[NW + w];
      }
      if (lut[1]) {
        X[w] ^= zm[2 * NW + w];
        Z[w] ^= zm[3 * NW + w];
      }
    }
  }
}

// Top-rung logical mix with zero top betas (ops/pallas_ladder.py:478-518):
// every gated proposal is accepted, so the masks are XORed straight in.
template <int NW>
__device__ __forceinline__ void top_mix(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                        const WindowParams& P, const uint64_t* tab,
                                        const int32_t* meta, DrawStream& gate_rng,
                                        DrawStream& draw_rng) {
  for (int it = 0; it < P.iters; ++it) xor_round<NW>(X, Z, it, P, tab, meta, gate_rng, draw_rng);
}

// Top-rung logical mix with nonzero top betas (ops/pallas_ladder.py:519-574):
// ``iters`` sequential Metropolis rounds; the round's masks are accepted
// together iff logf(u) < -((btx*dN_x + bty*dN_y) + btz*dN_z) in f32, each
// product and sum rounded on its own.  Acceptance uniform: element ``it``
// of ``acc_rng``.
template <int NW>
__device__ __forceinline__ void top_mix_mh(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                           const WindowParams& P, const uint64_t* tab,
                                           const int32_t* meta, const float* bt,
                                           DrawStream& gate_rng, DrawStream& draw_rng,
                                           DrawStream& acc_rng) {
  for (int it = 0; it < P.iters; ++it) {
    uint64_t mX[NW], mZ[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) mX[w] = mZ[w] = 0;
    xor_round<NW>(mX, mZ, it, P, tab, meta, gate_rng, draw_rng);
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
    const uint32_t bits = acc_rng(it);
    if (logr >= 0.f || logf(uniform24(bits)) < logr) {
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

template <int NW, bool EQ>
__global__ void __launch_bounds__(kMaxThreads<NW>) ladder_window_kernel(const WindowParams P,
                                                                        const WindowBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<NW, EQ> S(P, smem_raw, buf.tab);
  constexpr int kCnt = Smem<NW, EQ>::kCnt;
  const int Nc = P.Nc;
  const int slots = P.spb * Nc;
  const int tid = threadIdx.x;
  if (S.tab_copy)
    for (int i = tid; i < P.n_tab; i += blockDim.x) S.tab_copy[i] = buf.tab[i];
  for (int i = tid; i < P.n_meta; i += blockDim.x) S.meta[i] = buf.meta[i];
  for (int i = tid; i < 3 * Nc; i += blockDim.x) S.beta[i] = buf.betas[i];

  const int s = tid / Nc, r = tid - s * Nc;
  const int b = blockIdx.x * P.spb + s;
  const bool active = b < P.B;
  const bool bottom = r == 0, top = r == Nc - 1;
  const uint32_t use_gate = (uint32_t)(P.iters * P.n_colors * Nc);

  uint64_t X[NW], Z[NW];
  int flag = 0, tops = 0, since = 0, bfirst = -1;
  int esum[kCnt];
#pragma unroll
  for (int k = 0; k < kCnt; ++k) esum[k] = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) X[w] = Z[w] = 0;
  if (active) {
    const uint8_t* src = buf.state_in + ((size_t)b * Nc + r) * P.nq;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      for (int k = 0; k < 64 && w * 64 + k < P.nq; ++k) {
        const uint32_t v = src[w * 64 + k];
        X[w] |= (uint64_t)((v ^ (v >> 1)) & 1u) << k;
        Z[w] |= (uint64_t)((v >> 1) & 1u) << k;
      }
    }
    flag = buf.flag_in[(size_t)b * Nc + r];
    if (bottom) {
      tops = buf.tops_in[b];
      since = buf.since_in[b];
      for (int k = 0; k < P.K; ++k) S.eqc[s * P.K + k] = buf.eq_in[(size_t)b * P.K + k];
      for (int i = 0; i < Nc - 1; ++i) S.swacc[s * (Nc - 1) + i] = 0;
    }
  }
  __syncthreads();
  const float bx = S.beta[3 * r], by = S.beta[3 * r + 1], bz = S.beta[3 * r + 2];

  for (int t = 0; t < P.window; ++t) {
    // the draws of use ``u`` at this step (layout: ops/ladder_window.py)
    const auto draws = [&](uint32_t u) {
      return DrawStream(P.key0, P.key1, u, (uint32_t)t, (uint32_t)b, P.fixed != 0,
                        P.fixed_word);
    };
    if (active) {
      // 1) colored sweeps; use of color c in iteration it on rung r
      for (int it = 0; it < P.iters; ++it) {
        for (int c = 0; c < P.n_colors; ++c) {
          DrawStream rng = draws((uint32_t)((it * P.n_colors + c) * Nc + r));
          const int c0 = S.meta[c], c1 = S.meta[c + 1];
          const uint64_t* stab = S.tab + (size_t)3 * NW * c0;
          if constexpr (EQ) {
            sweep_color<NW>(X, Z, stab, c1 - c0, bx, rng);
          } else {
            sweep_color_xyz<NW>(X, Z, stab, c1 - c0, bx, by, bz, rng);
          }
        }
      }
      // 2) top-rung logical mix
      if (top && P.p_logical > 0.f) {
        DrawStream gate_rng = draws(use_gate);
        DrawStream draw_rng = draws(use_gate + 1);
        if (P.top_exact) {
          top_mix<NW>(X, Z, P, S.tab, S.meta, gate_rng, draw_rng);
        } else {
          DrawStream acc_rng = draws(use_gate + 3);
          top_mix_mh<NW>(X, Z, P, S.tab, S.meta, S.beta + 3 * r, gate_rng, draw_rng, acc_rng);
        }
      }
    }
    // 3) replica exchange through shared memory
    const int pb = t & 1;
    if (active) {
      uint64_t* mine = S.planes + ((size_t)pb * slots + tid) * 2 * NW;
      int n[kCnt];
#pragma unroll
      for (int k = 0; k < kCnt; ++k) n[k] = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        mine[w] = X[w];
        mine[NW + w] = Z[w];
        if constexpr (EQ) {
          n[0] += __popcll(X[w] | Z[w]);
        } else {
          n[0] += __popcll(X[w] & ~Z[w]);
          n[1] += __popcll(X[w] & Z[w]);
          n[2] += __popcll(~X[w] & Z[w]);
        }
      }
#pragma unroll
      for (int k = 0; k < kCnt; ++k) S.cnt[((size_t)pb * slots + tid) * kCnt + k] = n[k];
      S.flg[pb * slots + tid] = flag;
    }
    __syncthreads();
    if (active && bottom) {
      int32_t* pm = S.perm + s * Nc;
      const int32_t* nn = S.cnt + ((size_t)pb * slots + s * Nc) * kCnt;
      for (int k = 0; k < Nc; ++k) pm[k] = k;
      DrawStream rng = draws(use_gate + 2);
      // pair i = (i, i + 1) with its own uniform, element i; sequential
      // top->bottom, or even pairs then odd pairs (disjoint within a phase,
      // so deciding them one by one equals deciding them together)
      const int n_pairs = Nc - 1;
      for (int k = 0; k < n_pairs; ++k) {
        int i;
        if (P.even_odd) {
          const int n_even = (n_pairs + 1) / 2;
          i = k < n_even ? 2 * k : 2 * (k - n_even) + 1;
        } else {
          i = n_pairs - 1 - k;
        }
        const int lo = pm[i], hi = pm[i + 1];
        const float* bl = S.beta + 3 * i;
        const float* bh = S.beta + 3 * (i + 1);
        float logr;
        if constexpr (EQ) {
          logr = (bh[0] - bl[0]) * (float)(nn[hi] - nn[lo]);
        } else {
          // (dbx*dN_x + dby*dN_y) + dbz*dN_z, each operation rounded alone
          const int32_t* ch = nn + hi * kCnt;
          const int32_t* cl = nn + lo * kCnt;
          logr = __fadd_rn(
              __fadd_rn(__fmul_rn(__fsub_rn(bh[0], bl[0]), (float)(ch[0] - cl[0])),
                        __fmul_rn(__fsub_rn(bh[1], bl[1]), (float)(ch[1] - cl[1]))),
              __fmul_rn(__fsub_rn(bh[2], bl[2]), (float)(ch[2] - cl[2])));
        }
        const uint32_t bits = rng(i);
        if (logr >= 0.f || logf(uniform24(bits)) < logr) {
          pm[i] = hi;
          pm[i + 1] = lo;
          ++S.swacc[s * (Nc - 1) + i];
        }
      }
    }
    __syncthreads();
    if (active) {
      const int src = s * Nc + S.perm[s * Nc + r];
      const uint64_t* theirs = S.planes + ((size_t)pb * slots + src) * 2 * NW;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        X[w] = theirs[w];
        Z[w] = theirs[NW + w];
      }
      flag = S.flg[pb * slots + src];
      // 4) flags (src/mcmc.py:100-103): set the top, count arrivals at the bottom
      if (top) flag = 1;
      if (bottom) {
        if (flag == 1) {
          ++tops;
          flag = 0;
        }
        // 5) bottom-rung observation
        const int burned = tops >= P.tops_burn;
        since += burned;
        if (bfirst < 0 && burned) bfirst = t;
        if (burned || P.traces) {
          const int cls = class_of<NW>(X, Z, P, S.tab, S.meta);
          if (burned) ++S.eqc[s * P.K + cls];
          if (P.traces) {
            const size_t row = (size_t)t * P.B + b;
            buf.eq_trace[row] = cls;
            for (int c = 0; c < kKeys; ++c)
              buf.key_trace[row * kKeys + c] = chain_key<NW>(X, Z, S.tab + P.off_key, c);
          }
        }
        const int32_t* n = S.cnt + ((size_t)pb * slots + src) * kCnt;
#pragma unroll
        for (int k = 0; k < kCnt; ++k) esum[k] += n[k];
        if ((t + 1) % P.energy_chunk == 0) {
          float e;
          if constexpr (EQ) {
            e = (P.w0 * (float)esum[0]) * P.inv_chunk;
          } else {
            e = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(P.w0, (float)esum[0]),
                                              __fmul_rn(P.w1, (float)esum[1])),
                                    __fmul_rn(P.w2, (float)esum[2])),
                          P.inv_chunk);
          }
          buf.energies[(size_t)(t / P.energy_chunk) * P.B + b] = e;
#pragma unroll
          for (int k = 0; k < kCnt; ++k) esum[k] = 0;
        }
      }
    }
  }

  if (!active) return;
  uint8_t* dst = buf.state_out + ((size_t)b * Nc + r) * P.nq;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (int k = 0; k < 64 && w * 64 + k < P.nq; ++k) {
      const uint32_t x = (uint32_t)(X[w] >> k) & 1u, z = (uint32_t)(Z[w] >> k) & 1u;
      dst[w * 64 + k] = (uint8_t)(x ^ (z * 3u));
    }
  }
  buf.flag_out[(size_t)b * Nc + r] = flag;
  if (bottom) {
    buf.tops_out[b] = tops;
    buf.since_out[b] = since;
    buf.burn_any[b] = bfirst >= 0 ? 1 : 0;
    buf.burn_first[b] = bfirst > 0 ? bfirst : 0;
    for (int k = 0; k < P.K; ++k) buf.eq_out[(size_t)b * P.K + k] = S.eqc[s * P.K + k];
    for (int i = 0; i < Nc - 1; ++i)
      buf.swap_acc[(size_t)b * (Nc - 1) + i] = S.swacc[s * (Nc - 1) + i];
  }
}

template <int NW, bool EQ>
cudaError_t launch(const WindowParams& P, const WindowBuffers& buf, cudaStream_t stream) {
  if (P.spb * P.Nc > kMaxThreads<NW>) return cudaErrorInvalidValue;
  if (P.traces && (buf.eq_trace == nullptr || buf.key_trace == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Smem<NW, EQ>(P, nullptr, nullptr).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ladder_window_kernel<NW, EQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (P.B + P.spb - 1) / P.spb;
  ladder_window_kernel<NW, EQ><<<blocks, P.spb * P.Nc, smem, stream>>>(P, buf);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_nw(const WindowParams& P, const WindowBuffers& buf, cudaStream_t stream) {
  return P.equal_betas ? launch<NW, true>(P, buf, stream) : launch<NW, false>(P, buf, stream);
}

}  // namespace mqt

// Launch one window on ``stream``; returns the cudaError_t of the launch
// (0 on success).  Asynchronous: a fault during the run shows at the next
// synchronisation.
extern "C" int mqt_ladder_window(const mqt::WindowParams* P, const mqt::WindowBuffers* buf,
                                 void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P->B <= 0 || P->Nc <= 0 || P->spb <= 0) return (int)cudaErrorInvalidValue;
  switch (P->nw) {
    case 1: return (int)mqt::launch_nw<1>(*P, *buf, st);
    case 2: return (int)mqt::launch_nw<2>(*P, *buf, st);
    case 3: return (int)mqt::launch_nw<3>(*P, *buf, st);
    case 4: return (int)mqt::launch_nw<4>(*P, *buf, st);
    case 6: return (int)mqt::launch_nw<6>(*P, *buf, st);
    case 8: return (int)mqt::launch_nw<8>(*P, *buf, st);
    case 12: return (int)mqt::launch_nw<12>(*P, *buf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
