// ``n_sweeps`` colored Metropolis sweeps over a batch of chains in one
// launch, on Hopper (sm_90a).
//
// Replaces mcmc_qec_tpu/ops/pallas_sweep.py::make_pallas_sweep (the Pallas
// TPU kernel K1), both branches: equal per-Pauli betas (acceptance on the
// total error-count change) and general per-Pauli betas.  Per chain, per
// sweep, per color: every stabilizer of the color proposes its flip, the
// change in error count decides against a uniform, and the accepted flips
// are XORed in.  The plain PyTorch version is ops/sweep.py::sweep_reference;
// both draw the same Philox4x32-10 bits (layout in the ops/sweep.py
// docstring), so they agree trajectory for trajectory.
//
// What bounds it on this card: at the counting decoders' main path
// (65,536 chains of toric d=5, n_sweeps=1) one launch reads the (B, nq) u8
// state once and writes it once, about 6.5 MB, which is about 2 us at
// 3.35 TB/s; the proposals (50 per chain: two 64-bit popcounts and a
// quarter of a Philox block each) take about as long at the card's integer
// and popc rates.  So a launch with one sweep is bound by bytes and by the
// launch overhead of a few microseconds, not by its arithmetic.  The design
// keeps the work at one pass over memory: the block stages its rows of the
// state through shared memory with coalesced byte copies, each thread holds
// its chain as ceil(nq / 64) 64-bit words per plane in registers for all
// sweeps, the stabilizer masks sit in shared memory, and the logarithm is
// skipped when a proposal cannot be rejected.
//
// Layout: one thread per chain, kSweepThreads chains per block; any B works
// (the last block is ragged).  1, 2, 3, 4 or 6 words per plane, the word
// counts of the tables it shares with the ladder-window kernel
// (ops/ladder_window.py::kernel_words): toric d=13 has nq = 338.
//
// Built by mcmc_qec_tpu_torch/ops/_build.py (nvcc, no fast math, so logf is
// the same function torch.log calls) and bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "sweep.cuh"

namespace mqt {

constexpr int kSweepThreads = 128;

// Must match ops/sweep.py::_Params field for field.
struct SweepParams {
  int32_t B, nq, nw, n_colors, n_sweeps, equal_betas, n_tab;
  uint32_t key0, key1;
};

// Must match ops/sweep.py::_Buffers.
struct SweepBuffers {
  const uint8_t* state_in;     // (B, nq) Pauli values 0..3
  uint8_t* state_out;          // (B, nq)
  const float* betas;          // (3,) beta_x, beta_y, beta_z
  const uint64_t* tab;         // per stabilizer (by color): support, X, Z masks
  const int32_t* color_start;  // (n_colors + 1,) first stabilizer of each color
};

template <int NW, bool EQ>
__global__ void __launch_bounds__(kSweepThreads) sweep_kernel(const SweepParams P,
                                                              const SweepBuffers buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* tab = reinterpret_cast<uint64_t*>(smem_raw);
  int32_t* cstart = reinterpret_cast<int32_t*>(tab + P.n_tab);
  uint8_t* rows = reinterpret_cast<uint8_t*>(cstart + P.n_colors + 1);
  const int tid = threadIdx.x;
  for (int i = tid; i < P.n_tab; i += blockDim.x) tab[i] = buf.tab[i];
  for (int i = tid; i <= P.n_colors; i += blockDim.x) cstart[i] = buf.color_start[i];

  const size_t row0 = (size_t)blockIdx.x * blockDim.x;
  const size_t left = (size_t)P.B - row0;
  const int n_rows = left < (size_t)blockDim.x ? (int)left : (int)blockDim.x;
  const size_t n_bytes = (size_t)n_rows * P.nq;
  const uint8_t* src = buf.state_in + row0 * P.nq;
  for (size_t i = tid; i < n_bytes; i += blockDim.x) rows[i] = src[i];
  __syncthreads();

  if (tid < n_rows) {
    const uint32_t b = (uint32_t)(row0 + tid);
    uint8_t* mine = rows + (size_t)tid * P.nq;
    uint64_t X[NW], Z[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      X[w] = Z[w] = 0;
      for (int k = 0; k < 64 && w * 64 + k < P.nq; ++k) {
        const uint32_t v = mine[w * 64 + k];
        X[w] |= (uint64_t)((v ^ (v >> 1)) & 1u) << k;
        Z[w] |= (uint64_t)((v >> 1) & 1u) << k;
      }
    }
    const float bx = buf.betas[0], by = buf.betas[1], bz = buf.betas[2];
    for (int t = 0; t < P.n_sweeps; ++t) {
      for (int c = 0; c < P.n_colors; ++c) {
        // use c, step t, row b: element j is the j-th stabilizer's uniform
        DrawStream rng(P.key0, P.key1, (uint32_t)c, (uint32_t)t, b, false);
        const int c0 = cstart[c], n = cstart[c + 1] - c0;
        const uint64_t* stab = tab + (size_t)3 * NW * c0;
        if (EQ) {
          sweep_color<NW>(X, Z, stab, n, bx, rng);
        } else {
          sweep_color_xyz<NW>(X, Z, stab, n, bx, by, bz, rng);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      for (int k = 0; k < 64 && w * 64 + k < P.nq; ++k) {
        const uint32_t x = (uint32_t)(X[w] >> k) & 1u, z = (uint32_t)(Z[w] >> k) & 1u;
        mine[w * 64 + k] = (uint8_t)(x ^ (z * 3u));
      }
    }
  }
  __syncthreads();
  uint8_t* dst = buf.state_out + row0 * P.nq;
  for (size_t i = tid; i < n_bytes; i += blockDim.x) dst[i] = rows[i];
}

template <int NW, bool EQ>
cudaError_t launch(const SweepParams& P, const SweepBuffers& buf, cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * P.n_tab + sizeof(int32_t) * (P.n_colors + 1) +
                      (size_t)kSweepThreads * P.nq;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<NW, EQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (P.B + kSweepThreads - 1) / kSweepThreads;
  sweep_kernel<NW, EQ><<<blocks, kSweepThreads, smem, stream>>>(P, buf);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_nw(const SweepParams& P, const SweepBuffers& buf, cudaStream_t stream) {
  return P.equal_betas ? launch<NW, true>(P, buf, stream) : launch<NW, false>(P, buf, stream);
}

}  // namespace mqt

// Launch ``n_sweeps`` sweeps over the batch on ``stream``; returns the
// cudaError_t of the launch (0 on success).  Asynchronous: a fault during
// the run shows at the next synchronisation.
extern "C" int mqt_sweep(const mqt::SweepParams* P, const mqt::SweepBuffers* buf,
                         void* stream) {
  (void)cudaGetLastError();  // report only this launch's error
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P->B <= 0 || P->nq <= 0 || P->n_colors <= 0 || P->n_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  switch (P->nw) {
    case 1: return (int)mqt::launch_nw<1>(*P, *buf, st);
    case 2: return (int)mqt::launch_nw<2>(*P, *buf, st);
    case 3: return (int)mqt::launch_nw<3>(*P, *buf, st);
    case 4: return (int)mqt::launch_nw<4>(*P, *buf, st);
    case 6: return (int)mqt::launch_nw<6>(*P, *buf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
