// One PTEQ parallel-tempering window in one launch, on Hopper (sm_90a).
//
// Replaces mcmc_qec_tpu/ops/pallas_ladder.py::make_pallas_ladder_window (the
// Pallas TPU kernel) on its production branch: equal per-Pauli betas, zero
// top-rung betas (always-accept logical mix), sequential top->bottom replica
// exchange, no traces.  Per ladder step and syndrome:
//   1. ``iters`` colored Metropolis sweeps on every rung (per-rung beta);
//   2. the top rung XORs its gated random logicals (zero beta: all accept);
//   3. replica exchange top->bottom on the per-rung error counts taken after
//      the mix; an accepted pair swaps planes, counts and flags;
//   4. the top flag is set; a flag reaching the bottom increments tops0;
//   5. the bottom rung is observed: burn gate, since_burn, burn_first, the
//      class histogram and per-chunk mean energies.
// The plain PyTorch version is ops/ladder_window.py::ladder_window_reference;
// both draw the same Philox4x32-10 bits, so they agree trajectory for
// trajectory.
//
// What bounds it on this card: almost no bytes move (the state is read once
// and written once per window; at toric d=5 a rung is two 64-bit words), so
// the bound is instruction issue: integer and popc work for the proposals,
// the ten Philox rounds per four draws, and the precise logf of each
// proposal whose error count would rise, all serialised over the window's
// steps.  At B=2048 x Nc=5 there are only 10,240 chains, one thread each:
// about 2.4 warps per SM, far too few to hide instruction latency, so one
// thread's chain of dependent steps sets the time (on an H100 the window
// takes about as long at B=64 as at B=2048).  The design keeps everything
// in registers (planes) and shared memory (tables, exchange, histogram),
// skips logf when the proposal cannot be rejected, and spreads the
// syndromes thinly over blocks so every SM gets work.  Splitting a rung's
// proposals over several threads is the next step (PERF.md).
//
// Layout: one thread per (syndrome, rung); a block holds ``spb`` syndromes'
// Nc threads (thread s * Nc + r).  Replica exchange goes through shared
// memory: every rung publishes its planes, count and flag, the bottom
// thread of each syndrome runs the sequential sweep on a permutation, and
// every rung then reads the planes the permutation sends it.  Published
// slots are double-buffered by step parity, so two barriers per step
// suffice.
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
  int32_t window, iters, tops_burn, energy_chunk, zeros, spb;
  int32_t n_tab, n_meta, off_draw, off_class, m_draw, m_lut, m_b2e;
  float p_logical, w0, inv_chunk;
  uint32_t key0, key1;
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
  const float* betas;   // (Nc, 3); beta_x is used (equal betas)
  const uint64_t* tab;  // stabilizer, logical-draw and class masks
  const int32_t* meta;  // color starts, draw starts, op LUT, bits_to_eq
};

template <int NW>
struct Smem {
  uint64_t* tab;
  uint64_t* planes;  // [2][slots][2 * NW]
  int32_t* meta;
  float* beta;       // [Nc]
  int32_t* cnt;      // [2][slots]
  int32_t* flg;      // [2][slots]
  int32_t* perm;     // [slots]
  int32_t* swacc;    // [spb][Nc - 1]
  int32_t* eqc;      // [spb][K]
  size_t bytes;

  __host__ __device__ Smem(const WindowParams& P, unsigned char* base) {
    const size_t slots = (size_t)P.spb * P.Nc;
    size_t off = 0;
    tab = reinterpret_cast<uint64_t*>(base + off);
    off += sizeof(uint64_t) * P.n_tab;
    planes = reinterpret_cast<uint64_t*>(base + off);
    off += sizeof(uint64_t) * 2 * slots * 2 * NW;
    meta = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * P.n_meta;
    beta = reinterpret_cast<float*>(base + off);
    off += sizeof(float) * P.Nc;
    cnt = reinterpret_cast<int32_t*>(base + off);
    off += sizeof(int32_t) * 2 * slots;
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

// Top-rung logical mix with zero top betas (ops/pallas_ladder.py:478-518):
// for each of ``iters`` rounds a gate u < p_logical and, per logical draw,
// an op (bits24 % 4, through the family's op LUT) and X/Z positions
// (bits24 % n_pos).  Every gated proposal is accepted, so the masks are
// XORed straight in.  Draw element (it * n_draws + i) * 3 + k.
template <int NW>
__device__ __forceinline__ void top_mix(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                        const WindowParams& P, const Smem<NW>& S,
                                        DrawStream& gate_rng, DrawStream& draw_rng) {
  for (int it = 0; it < P.iters; ++it) {
    const bool gate = uniform24(gate_rng(it)) < P.p_logical;
    for (int i = 0; i < P.n_draws; ++i) {
      const int e = (it * P.n_draws + i) * 3;
      const uint32_t opb = (draw_rng(e) >> 8) % 4u;
      const int p0 = S.meta[P.m_draw + i];
      const uint32_t npos = (uint32_t)(S.meta[P.m_draw + i + 1] - p0);
      const uint32_t posx = (draw_rng(e + 1) >> 8) % npos;
      const uint32_t posz = (draw_rng(e + 2) >> 8) % npos;
      if (!gate) continue;
      const int32_t* lut = S.meta + P.m_lut + (i * 4 + (int)opb) * 2;
      // per position: [x-mask X plane | x-mask Z plane | z-mask X | z-mask Z]
      const uint64_t* xm = S.tab + P.off_draw + (size_t)(p0 + posx) * 4 * NW;
      const uint64_t* zm = S.tab + P.off_draw + (size_t)(p0 + posz) * 4 * NW;
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
}

template <int NW>
__device__ __forceinline__ int class_of(uint64_t (&X)[NW], uint64_t (&Z)[NW],
                                        const WindowParams& P, const Smem<NW>& S) {
  int bits = 0;
  for (int f = 0; f < P.n_bits; ++f) {
    const uint64_t* a = S.tab + P.off_class + (size_t)f * 2 * NW;
    int par = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) par += __popcll(a[w] & X[w]) + __popcll(a[NW + w] & Z[w]);
    bits |= (par & 1) << f;
  }
  return S.meta[P.m_b2e + bits];
}

template <int NW>
__global__ void __launch_bounds__(1024) ladder_window_kernel(const WindowParams P,
                                                             const WindowBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<NW> S(P, smem_raw);
  const int Nc = P.Nc;
  const int slots = P.spb * Nc;
  const int tid = threadIdx.x;
  for (int i = tid; i < P.n_tab; i += blockDim.x) S.tab[i] = buf.tab[i];
  for (int i = tid; i < P.n_meta; i += blockDim.x) S.meta[i] = buf.meta[i];
  for (int i = tid; i < Nc; i += blockDim.x) S.beta[i] = buf.betas[3 * i];

  const int s = tid / Nc, r = tid - s * Nc;
  const int b = blockIdx.x * P.spb + s;
  const bool active = b < P.B;
  const bool bottom = r == 0, top = r == Nc - 1;
  const uint32_t use_gate = (uint32_t)(P.iters * P.n_colors * Nc);

  uint64_t X[NW], Z[NW];
  int flag = 0, tops = 0, since = 0, bfirst = -1, esum = 0;
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
  const float beta_r = S.beta[r];

  for (int t = 0; t < P.window; ++t) {
    if (active) {
      // 1) colored sweeps; use of color c in iteration it on rung r
      for (int it = 0; it < P.iters; ++it) {
        for (int c = 0; c < P.n_colors; ++c) {
          DrawStream rng(P.key0, P.key1, (uint32_t)((it * P.n_colors + c) * Nc + r),
                         (uint32_t)t, (uint32_t)b, P.zeros != 0);
          const int c0 = S.meta[c], c1 = S.meta[c + 1];
          sweep_color<NW>(X, Z, S.tab + (size_t)3 * NW * c0, c1 - c0, beta_r, rng);
        }
      }
      // 2) top-rung logical mix
      if (top && P.p_logical > 0.f) {
        DrawStream gate_rng(P.key0, P.key1, use_gate, (uint32_t)t, (uint32_t)b, P.zeros != 0);
        DrawStream draw_rng(P.key0, P.key1, use_gate + 1, (uint32_t)t, (uint32_t)b,
                            P.zeros != 0);
        top_mix<NW>(X, Z, P, S, gate_rng, draw_rng);
      }
    }
    // 3) replica exchange through shared memory
    const int pb = t & 1;
    if (active) {
      uint64_t* mine = S.planes + ((size_t)pb * slots + tid) * 2 * NW;
      int n = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        mine[w] = X[w];
        mine[NW + w] = Z[w];
        n += __popcll(X[w] | Z[w]);
      }
      S.cnt[pb * slots + tid] = n;
      S.flg[pb * slots + tid] = flag;
    }
    __syncthreads();
    if (active && bottom) {
      int32_t* pm = S.perm + s * Nc;
      const int32_t* nn = S.cnt + pb * slots + s * Nc;
      for (int k = 0; k < Nc; ++k) pm[k] = k;
      DrawStream rng(P.key0, P.key1, use_gate + 2, (uint32_t)t, (uint32_t)b, P.zeros != 0);
      for (int i = Nc - 2; i >= 0; --i) {
        const int lo = pm[i], hi = pm[i + 1];
        const float logr = (S.beta[i + 1] - S.beta[i]) * (float)(nn[hi] - nn[lo]);
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
      const int n = S.cnt[pb * slots + src];
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
        if (burned) ++S.eqc[s * P.K + class_of<NW>(X, Z, P, S)];
        esum += n;
        if ((t + 1) % P.energy_chunk == 0) {
          buf.energies[(size_t)(t / P.energy_chunk) * P.B + b] =
              (P.w0 * (float)esum) * P.inv_chunk;
          esum = 0;
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

template <int NW>
cudaError_t launch(const WindowParams& P, const WindowBuffers& buf, cudaStream_t stream) {
  const size_t smem = Smem<NW>(P, nullptr).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ladder_window_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (P.B + P.spb - 1) / P.spb;
  ladder_window_kernel<NW><<<blocks, P.spb * P.Nc, smem, stream>>>(P, buf);
  return cudaGetLastError();
}

}  // namespace mqt

// Launch one window on ``stream``; returns the cudaError_t of the launch
// (0 on success).  Asynchronous: a fault during the run shows at the next
// synchronisation.
extern "C" int mqt_ladder_window(const mqt::WindowParams* P, const mqt::WindowBuffers* buf,
                                 void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P->B <= 0 || P->Nc <= 0 || P->spb <= 0 || P->spb * P->Nc > 1024)
    return (int)cudaErrorInvalidValue;
  switch (P->nw) {
    case 1: return (int)mqt::launch<1>(*P, *buf, st);
    case 2: return (int)mqt::launch<2>(*P, *buf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
