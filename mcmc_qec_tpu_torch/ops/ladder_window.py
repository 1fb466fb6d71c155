"""One PTEQ parallel-tempering window: CUDA kernel and plain PyTorch version.

Counterpart of ``mcmc_qec_tpu/ops/pallas_ladder.py`` (the fused Pallas TPU
window).  ``make_ladder_window`` returns a function with the exact
``_get_window_fn`` contract of ``make_pallas_ladder_window``
(pallas_ladder.py:160-210).  It dispatches on the device of the state:

- a CUDA tensor launches ``csrc/ladder_window.cu`` (built with ``nvcc`` at
  first use, ``ops/_build.py``) once per window, or raises;
- a CPU tensor runs ``ladder_window_reference``, the plain version.

The kernel has two forms, picked from shapes before any launch
(``window_form``): the register form, each rung's planes in its lanes'
registers (``KERNEL_SHAPES``, up to 16 words per plane), and the large
variant, the planes in shared memory at 2 bits a qubit and the word count
a run-time value, for every ladder the registers cannot hold (codes above
16 words per plane, up to WIDE_WORDS; groups too large for the register
form's shared memory) and for the codes where it is the faster form
(``WIDE_FROM_WORDS``).  Both compute the same function.

Every branch of the TPU kernel is ported:

- the sweep: equal per-Pauli betas (acceptance on the total error count,
  ``equal_betas=True``) or general per-Pauli betas per rung;
- the top-rung logical mix: always accepted for exactly-zero top betas
  (``top_exact=True``) or ``iters`` sequential Metropolis rounds;
- the replica exchange: the reference's sequential top->bottom sweep or
  ``exchange="even_odd"`` (all even pairs on the pre-phase counts, then
  all odd pairs);
- ``track_traces``: per-step bottom-rung class and 4-component chain hash.

Randomness: every draw is Philox4x32-10 (``ops/philox.py``) word ``e % 4``
at counter ``(e // 4, use, step, row)`` under key ``(seed mod 2**32,
seed >> 32)``, where ``row`` is the syndrome's batch index, ``step`` the
window-local ladder step and ``e`` the element within the use.  Uses per
step, with ``G = iters * n_colors * Nc``:

- ``(it * n_colors + c) * Nc + r``: sweep ``it``, color ``c``, rung ``r``;
  element ``j`` is the uniform of the color's ``j``-th stabilizer;
- ``G``: top-mix gates, element ``it``;
- ``G + 1``: top-mix draws, element ``(it * n_draws + i) * 3 + k`` for
  (op, X position, Z position) of logical draw ``i``;
- ``G + 2``: exchange, element ``i`` for rung pair ``(i, i + 1)`` (both
  schedules);
- ``G + 3``: the Metropolis mix's acceptance uniforms, element ``it``.

No two draws share a counter, so no two are correlated (the overlap
ROADMAP.md §3 warns of).  ``rng="zeros"`` makes every draw 0: that is what
the Pallas TPU interpreter's PRNG returns on the CPU, so the zeros-mode
plain window reproduces ``make_pallas_ladder_window(..., interpret=True)``
output for output (tests/test_torch_ladder_window.py).  An integer ``rng``
makes every draw that 32-bit word: with the interpreter's PRNG stubbed to
the same constant, the logical mix proposes a nontrivial logical, which
zeros (op 0 is the identity in every family) never does
(tests/test_torch_ladder_branches.py).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import CodeSpec
from ..utils import profiling
from .dense_sweep import _color_tables
from .philox import MASK32, philox4x32

# 64-bit words per bit plane of the kernels' register instantiations (a
# code's word count is rounded up to the next; the extra words stay zero).
# 16 words (nq <= 1024) is the most, and the narrow spanned-word entry packs
# a word index in 4 bits.  Above 16 words the tables hold the code's exact
# word count and a wide entry, 8 bits a word index, which no kernel reads
# (the count of spanned words, utils/roofline.py, does); both kernels'
# large variants read ``qubit_table`` at any word count
KERNEL_WORDS = (1, 2, 3, 4, 6, 8, 12, 16)
# most words per plane an 8-bit word index of the wide entry names, and
# so the most the kernels' large variants take (nq <= 16384; a qubit-table
# entry's 14-bit qubit index reaches as far)
WIDE_WORDS = 256
# spanned-word entries per stabilizer of the tables above 16 words per
# plane (the window kernel's large variant reads the qubit table instead)
WIDE_SPANS = (1, 2, 4)
# (words per plane, spanned-word entries per stabilizer) both kernels are
# instantiated for (csrc/ladder_window.cu::dispatch, csrc/sweep.cu::dispatch):
# a stabilizer spanning 3 words is padded to 4 entries.  Rotated and XZZX
# codes span at most 2 words at every size, toric and planar codes 4 from
# d=9 on
KERNEL_SHAPES = ((1, 1), (2, 2), (3, 2), (3, 4), (4, 2), (4, 4), (6, 2), (6, 4),
                 (8, 2), (8, 4), (12, 2), (12, 4), (16, 2), (16, 4))
# threads per block of the window kernel (csrc/ladder_window.cu::kMaxThreads)
MAX_THREADS = 512
# threads per block of its large variant (kWideMaxThreads, its launch
# bounds: at most 64 registers a thread) and the warps an SM holds of it
WIDE_MAX_THREADS = 1024
WIDE_WARPS_PER_SM = 32
# codes of this many words per plane or more run the large variant wherever
# it holds the ladder, though the register form does too (``window_form``)
WIDE_FROM_WORDS = 12
# bits of a qubit index in an entry of ``qubit_table``
_QUBIT_BITS = 14
# named barriers a block has for multi-warp groups (id 0 is __syncthreads)
MAX_NAMED_BARRIERS = 15
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# bound on Philox blocks materialised at once by the plain version
_DRAW_BUDGET = 1 << 21
# Philox uses per step after the sweeps (gates, draws, exchange, MH accept)
_N_EXTRA_USES = 4
# components of the chain hash in trace mode, and bits per coefficient
N_KEY = 4
_KEY_BITS = 6

WindowOut = Tuple[torch.Tensor, ...]


class KernelCounter:
    """How often a kernel wrapper launched its kernel, how often it ran
    the plain version instead (CPU tensors), and the batch rows of those
    calls summed (``rows``: a window's syndrome rows, a sweep's chains).
    The wrappers count through ``add_launch`` and ``add_plain``, under a
    lock: the shards of ``parallel.map_shards`` launch from one host thread
    each."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls = 0
        self.rows = 0

    def add_launch(self, rows: int = 0) -> None:
        with self._lock:
            self.launches += 1
            self.rows += rows

    def add_plain(self, rows: int = 0) -> None:
        with self._lock:
            self.plain_calls += 1
            self.rows += rows

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self.rows = 0


# the ladder-window wrapper's counts (every function ``make_ladder_window``
# returns adds to it)
ladder_window_counts = KernelCounter()


def _rng_layout(spec: CodeSpec, Nc: int, iters: int) -> Tuple[int, int, int]:
    """(first non-sweep use G, Philox blocks per sweep use, Philox blocks
    per non-sweep use) of the layout above."""
    tables = _color_tables(spec)
    w_max = max(sel.shape[0] for sel, _, _ in tables)
    n_extra = max(iters, 3 * iters * len(spec.logical_draws), Nc - 1, 1)
    return iters * len(tables) * Nc, -(-w_max // 4), -(-n_extra // 4)


def key_coefficients(nq: int) -> np.ndarray:
    """(N_KEY, nq) int64 hash coefficients in [0, 64) of trace mode: the
    same draws as the TPU kernel's table (pallas_ladder.py:318-324)."""
    rng = np.random.RandomState(0x5EED ^ (nq * 7919))
    return np.stack([rng.randint(0, 64, size=nq) for _ in range(N_KEY)]).astype(
        np.int64
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


class _PlainTables:
    """Tables of the plain version on one device.  States are held as
    int64 Pauli values with one extra always-zero column ``nq`` that
    padded stabilizer slots point at."""

    def __init__(self, spec: CodeSpec, device: torch.device):
        nq = spec.nq
        q1 = nq + 1
        v = np.arange(4)
        # per color: Pauli op per qubit (q1,), flat lookups of the change in
        # "qubit in error" and in "qubit is X / Y / Z" at (support slot,
        # value) (W * deg * 4,) and (3, W * deg * 4), the flattened support
        # (W * deg,), and the owning slot per qubit (q1,)
        self.colors = []
        for sel, xop, zop in _color_tables(spec):
            n = sel.shape[0]
            op = np.zeros(q1, np.int64)
            op[:nq] = xop.astype(np.int64) ^ (3 * zop.astype(np.int64))
            new = v[None, :] ^ op[:, None]  # (q1, 4) value after the op
            dtab = (new != 0).astype(np.int64) - (v[None, :] != 0)
            dtab3 = np.stack([(new == k).astype(np.int64) - (v[None, :] == k)
                              for k in (1, 2, 3)])
            deg = int(sel.sum(axis=1).max())
            supp = np.full((n, deg), nq, np.int64)
            owner = np.full(q1, n, np.int64)
            for j in range(n):
                qs = np.flatnonzero(sel[j])
                supp[j, : len(qs)] = qs
                owner[qs] = j
            flat = supp.reshape(-1)
            dsupp = dtab[flat].reshape(-1)
            dsupp3 = dtab3[:, flat].reshape(3, -1)
            self.colors.append(tuple(
                torch.as_tensor(a, device=device)
                for a in (op, dsupp, dsupp3, flat, owner)
            ) + (n, deg))
        draws = spec.logical_draws
        n_pos = [d.x_masks.shape[0] for d in draws]
        xm = np.zeros((len(draws), max(n_pos), q1), np.int64)
        zm = np.zeros_like(xm)
        for i, d in enumerate(draws):
            xm[i, : n_pos[i], :nq] = d.x_masks
            zm[i, : n_pos[i], :nq] = d.z_masks
        lut = np.stack([np.asarray(d.op_lut, bool) for d in draws])  # (nd, 4, 2)
        self.xm = torch.as_tensor(xm, device=device)
        self.zm = torch.as_tensor(zm, device=device)
        self.n_pos = torch.as_tensor(n_pos, dtype=torch.int64, device=device)
        self.lut_x = torch.as_tensor(lut[..., 0], device=device)
        self.lut_z = torch.as_tensor(lut[..., 1], device=device)
        self.draw_id = torch.arange(len(draws), device=device)
        pad = np.zeros((spec.n_class_bits, 1), np.int64)
        self.class_a = torch.as_tensor(
            np.concatenate([spec.class_A.astype(np.int64), pad], 1), device=device
        )
        self.class_b = torch.as_tensor(
            np.concatenate([spec.class_B.astype(np.int64), pad], 1), device=device
        )
        self.bit_w = 1 << torch.arange(spec.n_class_bits, device=device)
        self.b2e = torch.as_tensor(spec.bits_to_eq.astype(np.int64), device=device)
        keyc = np.zeros((N_KEY, q1), np.int64)
        keyc[:, :nq] = key_coefficients(nq)
        self.keyc = torch.as_tensor(keyc, device=device)
        self.paulis = torch.arange(1, 4, device=device)  # X, Y, Z values


@functools.lru_cache(maxsize=None)
def _plain_tables(spec: CodeSpec, device: torch.device) -> _PlainTables:
    return _PlainTables(spec, device)


def _fixed_word(rng):
    """The word every draw equals (``rng="zeros"`` or an int), or None for
    Philox draws."""
    if rng == "philox":
        return None
    if rng == "zeros":
        return 0
    if isinstance(rng, int) and not isinstance(rng, bool) and 0 <= rng <= MASK32:
        return rng
    raise ValueError(f"rng={rng!r}: expected 'philox', 'zeros' or a 32-bit word")


def _draw_words(k0: int, k1: int, t0: int, t1: int, B: int, use0: int,
                n_uses: int, n_blocks: int, fixed, device) -> torch.Tensor:
    """Draws of uses [use0, use0 + n_uses) in steps [t0, t1):
    (t1 - t0, B, n_uses, 4 * n_blocks) int64 words in [0, 2**32), element
    e at [..., e]; every word is ``fixed`` unless it is None."""
    shape = (t1 - t0, B, n_uses, 4 * n_blocks)
    if fixed is not None:
        return torch.full(shape, fixed, dtype=torch.int64, device=device)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    c0 = ar(n_blocks).view(1, 1, 1, -1)
    c1 = ar(use0, use0 + n_uses).view(1, 1, -1, 1)
    c2 = ar(t0, t1).view(-1, 1, 1, 1)
    c3 = ar(B).view(1, -1, 1, 1)
    words = torch.stack(philox4x32(c0, c1, c2, c3, k0, k1), dim=-1)
    return words.reshape(shape)


def _class_ids(T: _PlainTables, s: torch.Tensor) -> torch.Tensor:
    """Class index of int64 Pauli states ``s`` (..., nq + 1)."""
    b0 = ((s & 1) ^ ((s >> 1) & 1)).unsqueeze(-2)
    b1 = ((s >> 1) & 1).unsqueeze(-2)
    feats = ((b0 & T.class_a).sum(-1) + (b1 & T.class_b).sum(-1)) & 1
    return T.b2e[(feats * T.bit_w).sum(-1)]


def _xyz_counts(T: _PlainTables, s: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 X, Y and Z counts of int64 Pauli states (..., nq + 1)."""
    return (s.unsqueeze(-2) == T.paulis.view(3, 1)).sum(-1)


def _weighted(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(w0 * n_x + w1 * n_y) + w2 * n_z in f32, each product and sum rounded
    on its own in the TPU kernel's order; ``n`` (..., 3) f32."""
    return (w[0] * n[..., 0] + w[1] * n[..., 1]) + w[2] * n[..., 2]


def ladder_window_reference(
    spec: CodeSpec,
    state: torch.Tensor,
    flag: torch.Tensor,
    tops0: torch.Tensor,
    eq_count: torch.Tensor,
    since_burn: torch.Tensor,
    seed: int,
    betas,
    weights,
    *,
    window: int,
    iters: int,
    p_logical: float,
    tops_burn: int,
    energy_chunk: int,
    top_exact: bool = False,
    equal_betas: bool = False,
    exchange: str = "sequential",
    track_traces: bool = False,
    rng: str = "philox",
) -> WindowOut:
    """Plain PyTorch version of one window of ``make_pallas_ladder_window``
    on the device of ``state``, every branch.

    Same inputs and outputs as the kernel wrapper (see
    ``make_ladder_window``).  Per step: every color of every sweep updates
    all (syndrome, rung) chains at once through per-qubit lookup tables,
    the top rung mixes in random logicals, the exchange runs on a
    per-syndrome rung permutation, and the class histogram and energy of
    the bottom rung are folded once per chunk.  Float expressions keep the
    TPU kernel's operation order, each product and sum rounded on its
    own."""
    device = state.device
    B, Nc, nq = state.shape
    T = _plain_tables(spec, device)
    C = energy_chunk
    f32 = torch.float32
    use_gate, n_blocks, n_xblocks = _rng_layout(spec, Nc, iters)
    n_draws = len(spec.logical_draws)
    k0, k1 = int(seed) & MASK32, (int(seed) >> 32) & MASK32
    fixed = _fixed_word(rng)

    S = torch.zeros((B, Nc, nq + 1), dtype=torch.int64, device=device)
    S[..., :nq] = state
    fl = flag.to(torch.int64)
    tops = tops0.to(torch.int64)
    eq = eq_count.to(torch.int64)
    since = since_burn.to(torch.int64)
    bfirst = torch.full((B,), -1, dtype=torch.int64, device=device)
    swaps = torch.zeros((B, max(Nc - 1, 0)), dtype=torch.int64, device=device)
    beta3 = torch.as_tensor(betas, dtype=f32, device=device).reshape(Nc, 3)
    beta_cols = [beta3[:, k].view(1, Nc, 1) for k in range(3)]
    dbeta = beta3[1:] - beta3[:-1]  # (Nc - 1, 3)
    beta_top = beta3[-1]
    w = torch.as_tensor(weights, dtype=f32, device=device).reshape(3)
    inv_c = torch.tensor(np.float32(1.0 / C), device=device)
    two_m24 = torch.tensor(2.0 ** -24, dtype=f32, device=device)
    eps = torch.tensor(1e-12, dtype=f32, device=device)
    top_only = torch.zeros((1, Nc, 1), dtype=torch.int64, device=device)
    top_only[0, -1, 0] = 1
    rung_ids = torch.arange(Nc, device=device).expand(B, Nc)
    no_hit = torch.zeros((B, Nc, 1), dtype=torch.bool, device=device)
    slot4 = [4 * torch.arange(n * deg, device=device)
             for *_, n, deg in T.colors]
    draw_e = (
        torch.arange(iters, device=device).view(-1, 1, 1) * n_draws
        + torch.arange(n_draws, device=device).view(1, -1, 1)
    ) * 3 + torch.arange(3, device=device)  # (iters, n_draws, 3)
    if exchange == "even_odd":
        pair_order = list(range(0, Nc - 1, 2)) + list(range(1, Nc - 1, 2))
    else:
        pair_order = list(reversed(range(Nc - 1)))
    energies = torch.empty((window // C, B), dtype=f32, device=device)
    if track_traces:
        eq_trace = torch.empty((window, B), dtype=torch.int32, device=device)
        key_trace = torch.empty((window, B, N_KEY), dtype=torch.int32,
                                device=device)
    chunk_s, chunk_g, chunk_n = [], [], []

    per_step = B * (use_gate * n_blocks + _N_EXTRA_USES * n_xblocks)
    span = max(1, _DRAW_BUDGET // max(per_step, 1))
    for t0 in range(0, window, span):
        t1 = min(window, t0 + span)
        sweep_bits = _draw_words(k0, k1, t0, t1, B, 0, use_gate, n_blocks,
                                 fixed, device) >> 8
        logu = torch.log(sweep_bits.to(f32) * two_m24 + eps)
        bits24 = _draw_words(k0, k1, t0, t1, B, use_gate, _N_EXTRA_USES,
                             n_xblocks, fixed, device) >> 8
        logu_sw = torch.log(bits24[:, :, 2].to(f32) * two_m24 + eps)
        for t in range(t0, t1):
            lt = t - t0
            # 1) colored sweeps on all (syndrome, rung) chains
            for it in range(iters):
                for c, (op, dsupp, dsupp3, supp, owner, n, deg) in enumerate(
                        T.colors):
                    base = (it * len(T.colors) + c) * Nc
                    lu = logu[lt, :, base : base + Nc, :n]
                    idx = S.index_select(-1, supp) + slot4[c]  # (B, Nc, n * deg)
                    if equal_betas:
                        dn = dsupp.take(idx).view(B, Nc, n, deg).sum(-1)
                        logr = -(beta_cols[0] * dn.to(f32))
                    else:
                        d = dsupp3[:, idx].view(3, B, Nc, n, deg).sum(-1).to(f32)
                        logr = -((beta_cols[0] * d[0] + beta_cols[1] * d[1])
                                 + beta_cols[2] * d[2])
                    acc = lu < logr
                    hit = torch.cat([acc, no_hit], -1).index_select(-1, owner)
                    S = torch.where(hit, S ^ op, S)
            # 2) top-rung logical mix
            if p_logical > 0.0:
                u_gate = bits24[lt, :, 0, :iters].to(f32) * two_m24 + eps
                gate = u_gate < p_logical  # (B, iters)
                d = bits24[lt, :, 1][:, draw_e]  # (B, iters, n_draws, 3)
                opb = d[..., 0] % 4
                posx = d[..., 1] % T.n_pos
                posz = d[..., 2] % T.n_pos
                dox = T.lut_x[T.draw_id, opb] & gate[..., None]
                doz = T.lut_z[T.draw_id, opb] & gate[..., None]
                m = (T.xm[T.draw_id, posx] * dox[..., None]) ^ (
                    T.zm[T.draw_id, posz] * doz[..., None]
                )  # (B, iters, n_draws, nq + 1) Pauli masks
                if top_exact:
                    # zero top betas: every gated proposal accepts
                    mx = (((m & 1) ^ ((m >> 1) & 1)).sum((1, 2))) & 1
                    mz = (((m >> 1) & 1).sum((1, 2))) & 1
                    S = S ^ ((mx ^ (3 * mz)).unsqueeze(1) * top_only)
                else:
                    # iters sequential Metropolis rounds on the top rung
                    logu_mix = torch.log(
                        bits24[lt, :, 3, :iters].to(f32) * two_m24 + eps
                    )
                    for it in range(iters):
                        mk = m[:, it, 0]
                        for i in range(1, n_draws):
                            mk = mk ^ m[:, it, i]
                        top = S[:, -1]
                        dn = (_xyz_counts(T, top ^ mk)
                              - _xyz_counts(T, top)).to(f32)
                        logr = -_weighted(beta_top, dn)
                        acc = logu_mix[:, it] < logr
                        S = S ^ (torch.where(acc[:, None], mk, 0).unsqueeze(1)
                                 * top_only)
            # 3) exchange on the counts after the mix, on a permutation
            if equal_betas:
                N = (S != 0).sum(-1, keepdim=True)  # (B, Nc, 1)
            else:
                N = _xyz_counts(T, S)  # (B, Nc, 3)
            cols = torch.cat([rung_ids.unsqueeze(-1), N, fl.unsqueeze(-1)], -1)
            lsw = logu_sw[lt]
            for i in pair_order:
                dn = (cols[:, i + 1, 1:-1] - cols[:, i, 1:-1]).to(f32)
                if equal_betas:
                    logr = dbeta[i, 0] * dn[:, 0]
                else:
                    logr = _weighted(dbeta[i], dn)
                acc = lsw[:, i] < logr
                pair = cols[:, i : i + 2]
                cols = cols.clone()
                cols[:, i : i + 2] = torch.where(
                    acc[:, None, None], pair.flip(1), pair
                )
                swaps[:, i] += acc
            perm, N, fl = cols[..., 0], cols[..., 1:-1], cols[..., -1]
            S = S.gather(1, perm.unsqueeze(-1).expand_as(S))
            # 4) flags (src/mcmc.py:100-103)
            fl = fl.clone()
            fl[:, -1] = 1
            arrived = fl[:, 0] == 1
            tops = tops + arrived
            fl[:, 0] = torch.where(arrived, 0, fl[:, 0])
            # 5) bottom-rung observation, folded per chunk
            burned = tops >= tops_burn
            since = since + burned
            bfirst = torch.where((bfirst < 0) & burned, t, bfirst)
            chunk_s.append(S[:, 0])
            chunk_g.append(burned)
            chunk_n.append(N[:, 0])
            if track_traces:
                eq_trace[t] = _class_ids(T, S[:, 0]).to(torch.int32)
                key_trace[t] = (S[:, 0].unsqueeze(1) * T.keyc).sum(-1).to(
                    torch.int32)
            if (t + 1) % C == 0:
                cls = _class_ids(T, torch.stack(chunk_s))  # (C, B)
                gated = torch.stack(chunk_g)[..., None]
                eq = eq + (F.one_hot(cls, spec.n_classes) * gated).sum(0)
                esum = torch.stack(chunk_n).sum(0).to(f32)  # (B, 1 or 3)
                if equal_betas:
                    energies[t // C] = (w[0] * esum[:, 0]) * inv_c
                else:
                    energies[t // C] = _weighted(w, esum) * inv_c
                chunk_s, chunk_g, chunk_n = [], [], []

    i32 = torch.int32
    out = (
        S[..., :nq].to(torch.uint8),
        fl.to(i32),
        tops.to(i32),
        eq.to(i32),
        since.to(i32),
        energies,
        bfirst >= 0,
        bfirst.clamp(min=0).to(i32),
        swaps.to(i32),
    )
    if track_traces:
        out = out + (eq_trace, key_trace)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/ladder_window.cu::WindowParams."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "Nc", "nq", "nw", "K", "n_bits", "n_colors", "n_draws",
        "window", "iters", "tops_burn", "energy_chunk", "fixed", "span",
        "lanes", "lane_shift", "warps_per_group", "groups_per_block",
        "n_tab", "n_meta", "off_class", "off_key", "off_span",
        "m_draw", "m_lut", "m_b2e", "m_span", "m_blk", "m_bcol", "n_blk",
        "equal_betas", "top_exact", "even_odd", "traces", "tab_in_smem",
        "smem", "wide",
    )] + [(n, ctypes.c_float) for n in (
        "p_logical", "w0", "w1", "w2", "inv_chunk",
    )] + [(n, ctypes.c_uint32) for n in ("key0", "key1", "fixed_word")]


class _Buffers(ctypes.Structure):
    """csrc/ladder_window.cu::WindowBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state_in", "state_out", "flag_in", "flag_out", "tops_in", "tops_out",
        "eq_in", "eq_out", "since_in", "since_out", "energies", "burn_any",
        "burn_first", "swap_acc", "eq_trace", "key_trace", "betas", "tab",
        "meta", "qtab",
    )]


def kernel_words(nq: int) -> int:
    """64-bit words per bit plane of the kernels' tables for ``nq``: the
    register instantiation's (the next of KERNEL_WORDS) up to 16 words,
    the exact count above."""
    need = -(-nq // 64)
    return next((nw for nw in KERNEL_WORDS if nw >= need), need)


def is_wide(spec: CodeSpec) -> bool:
    """Whether ``spec`` needs more than KERNEL_WORDS[-1] words per plane:
    the wide spanned-word entries, and the kernels' large variants (no
    register instantiation holds its planes)."""
    return -(-spec.nq // 64) > KERNEL_WORDS[-1]


def _words(mask: np.ndarray, nw: int) -> np.ndarray:
    """(nq,) 0/1 mask -> (nw,) uint64 bit words (bit q of word q // 64)."""
    out = np.zeros(nw, np.uint64)
    for q in np.flatnonzero(mask):
        out[q // 64] |= np.uint64(1) << np.uint64(q % 64)
    return out


def _xz(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """X- and Z-component planes of a Pauli-valued array."""
    m = m.astype(np.int64)
    return (m & 1) ^ ((m >> 1) & 1), (m >> 1) & 1


def _pack_span(words, cx: int, cz: int, nw: int) -> Tuple[int, int]:
    """A stabilizer's entries in the spanned-word table of a code of ``nw``
    words per plane: (narrow, wide).  The narrow entry holds the count of
    words its support spans (bits 0-3), the qubits its op flips in the X
    plane (bits 4-7) and in the Z plane (bits 8-11) and, up to 16 words
    per plane, the word indices, 4 bits each from bit 12 (0 there above
    16 words); both kernels' register instantiations read it.  The wide
    entry holds the word indices, 8 bits each, above 16 words (the count
    of spanned words, utils/roofline.py, reads it; the kernels' large
    variants read ``qubit_table``)."""
    if max(words, default=0) >= WIDE_WORDS:
        raise ValueError(f"word index {max(words)}: the wide entry holds "
                         f"indices below {WIDE_WORDS}")
    v = len(words) | (cx << 4) | (cz << 8)
    wide = 0
    for m, w in enumerate(words):
        if nw <= KERNEL_WORDS[-1]:
            v |= w << (12 + 4 * m)
        wide |= w << (8 * m)
    return v, wide


def unpack_span(v: int, wide: int | None = None):
    """(word indices, cx, cz) of a narrow spanned-word entry ``v``, the
    indices read from the wide entry ``wide`` where it is given (codes
    above 16 words per plane, whose narrow entry holds none)."""
    n = v & 15
    if wide is None:
        words = [(v >> (12 + 4 * m)) & 15 for m in range(n)]
    else:
        words = [(wide >> (8 * m)) & 255 for m in range(n)]
    return words, (v >> 4) & 15, (v >> 8) & 15


@functools.lru_cache(maxsize=None)
def kernel_tables(spec: CodeSpec):
    """(u64 table, int32 meta, offsets) the kernels read: per stabilizer
    (ordered by color) its support and op X/Z masks over all words (the
    sweep kernel's); per logical-draw position the X/Z planes of its x- and
    z-mask; per class bit its A/B masks; per hash component and coefficient
    bit the qubits whose coefficient has that bit; per stabilizer its
    support and op X/Z masks on only the words its support spans, ``span``
    triples each (zero-padded).  Meta: color starts, draw starts, op LUT,
    per stabilizer its packed spanned words (``unpack_span``), per color
    its first Philox block of a sweep use's draws (one block per four
    stabilizers), per such block its color, bits_to_eq, and above 16 words
    per plane (``m_wide``; None below) per stabilizer its wide entry.  The
    window kernel reads the table from ``off_draw`` on, in either form
    (``window_form``); above WIDE_WORDS words per plane no entry can name
    a word and the tables are not built."""
    nq = spec.nq
    nw = kernel_words(nq)
    tab, meta = [], []
    color_start = [0]
    spans = []  # per stabilizer: [(word, support, X op, Z op)], cx, cz
    for sel, xop, zop in _color_tables(spec):
        for row in sel:
            on = row.astype(bool)
            dense = (_words(on, nw), _words(on & (xop > 0), nw),
                     _words(on & (zop > 0), nw))
            tab += list(dense)
            spans.append(([(w, dense[0][w], dense[1][w], dense[2][w])
                           for w in range(nw) if dense[0][w]],
                          int((on & (xop > 0)).sum()), int((on & (zop > 0)).sum())))
        color_start.append(color_start[-1] + sel.shape[0])
    n_per_color = np.diff(color_start)
    off_draw = len(tab) * nw
    draw_start = [0]
    for d in spec.logical_draws:
        for p in range(d.x_masks.shape[0]):
            (xx, xz), (zx, zz) = _xz(d.x_masks[p]), _xz(d.z_masks[p])
            tab += [_words(xx, nw), _words(xz, nw), _words(zx, nw), _words(zz, nw)]
        draw_start.append(draw_start[-1] + d.x_masks.shape[0])
    off_class = len(tab) * nw
    for f in range(spec.n_class_bits):
        tab += [_words(spec.class_A[f], nw), _words(spec.class_B[f], nw)]
    off_key = len(tab) * nw
    for coef in key_coefficients(nq):
        tab += [_words((coef >> k) & 1, nw) for k in range(_KEY_BITS)]
    off_span = len(tab) * nw
    span = spanned_words(spec)
    for s, _, _ in spans:
        ent = np.zeros(3 * span, np.uint64)
        for m, (_, su, xs, zs) in enumerate(s):
            ent[3 * m: 3 * m + 3] = (su, xs, zs)
        tab.append(ent)
    meta += color_start
    m_draw = len(meta)
    meta += draw_start
    m_lut = len(meta)
    for d in spec.logical_draws:
        meta += [int(v) for v in np.asarray(d.op_lut).reshape(-1)]
    m_span = len(meta)
    packed = [_pack_span([w for w, *_ in s], cx, cz, nw) for s, cx, cz in spans]
    meta += [v for v, _ in packed]
    m_blk = len(meta)
    blk = np.concatenate([[0], np.cumsum(-(-n_per_color // 4))])
    meta += [int(v) for v in blk]
    m_bcol = len(meta)
    meta += [c for c, n in enumerate(np.diff(blk)) for _ in range(n)]
    m_b2e = len(meta)
    meta += [int(v) for v in spec.bits_to_eq]
    m_wide = None
    if is_wide(spec):
        m_wide = len(meta)
        meta += [w for _, w in packed]
    tab_np = np.concatenate(tab).view(np.int64)
    # a wide entry of four 8-bit indices may pass 2**31: its int32 bit pattern
    meta_np = np.asarray(meta, np.int64).astype(np.uint32).view(np.int32)
    offs = dict(n_tab=len(tab_np), n_meta=len(meta_np), off_draw=off_draw,
                off_class=off_class, off_key=off_key, off_span=off_span,
                span=span, m_draw=m_draw, m_lut=m_lut, m_span=m_span,
                m_blk=m_blk, m_bcol=m_bcol, n_blk=int(blk[-1]), m_b2e=m_b2e,
                m_wide=m_wide,
                n_colors=len(color_start) - 1, w_max=int(n_per_color.max()),
                nw=nw, n_stabs=len(spans))
    return tab_np, meta_np, offs


@functools.lru_cache(maxsize=None)
def qubit_table(spec: CodeSpec) -> np.ndarray:
    """(n_stabs,) int64 (the bits of a uint64) entries of the window
    kernel's large variant, one per stabilizer in ``kernel_tables``' color
    order: qubit k (k < 4) of its support in bits 14k .. 14k + 13 and its op
    there, x | z << 1 (X 1, Y 3, Z 2), in bits 56 + 2k and 57 + 2k; a
    stabilizer of fewer qubits leaves op 0 (and qubit 0) in the rest.  The
    kernel reads a proposal's qubits from its entry alone
    (csrc/ladder_window.cu::entry_states).  A ``ValueError`` for a code of
    more than 2**14 qubits or a stabilizer of more than four."""
    if spec.nq > 1 << _QUBIT_BITS:
        raise ValueError(f"nq={spec.nq}: a qubit-table entry names qubits "
                         f"below {1 << _QUBIT_BITS}")
    out = []
    for sel, xop, zop in _color_tables(spec):
        for row in sel:
            qs = np.flatnonzero(row)
            if len(qs) > 4:
                raise ValueError(f"a stabilizer of {len(qs)} qubits: the "
                                 f"qubit table holds at most four")
            e = 0
            for k, q in enumerate(qs):
                op = int(xop[q] > 0) | (int(zop[q] > 0) << 1)
                e |= (int(q) << (_QUBIT_BITS * k)) | (op << (56 + 2 * k))
            out.append(e)
    return np.asarray(out, np.uint64).view(np.int64)


def has_kernel_shape(spec: CodeSpec) -> bool:
    """Whether both kernels' register instantiations take ``spec``: at most
    KERNEL_WORDS[-1] words per plane, and its (words per plane, spanned
    words per stabilizer) in KERNEL_SHAPES.  Both kernels have a large
    variant beside them, which takes larger codes and, in the window
    kernel, ladders too large for the registers (``window_form``;
    ops/sweep.py::sweep_kernel_fits)."""
    if is_wide(spec):
        return False
    return (kernel_words(spec.nq), spanned_words(spec)) in KERNEL_SHAPES


def kernel_shape(spec: CodeSpec) -> Tuple[int, int]:
    """(words per plane, spanned-word entries per stabilizer) of the kernel
    that takes ``spec``: its register instantiation up to 16 words per
    plane, the large variant's (the code's own word count) above; a
    ``ValueError`` above WIDE_WORDS words, where neither is built."""
    need = -(-spec.nq // 64)
    if need > WIDE_WORDS:
        raise ValueError(
            f"nq={spec.nq} needs {need} words per plane; the kernels take at "
            f"most {WIDE_WORDS} (nq <= {64 * WIDE_WORDS}); the plain versions "
            f"on the CPU take any size")
    shape = (kernel_words(spec.nq), spanned_words(spec))
    if not is_wide(spec) and shape not in KERNEL_SHAPES:
        raise ValueError(f"no kernel for {shape[0]} words per plane and "
                         f"{shape[1]} spanned words per stabilizer")
    return shape


@functools.lru_cache(maxsize=None)
def spanned_words(spec: CodeSpec) -> int:
    """Entries per stabilizer of the spanned-word table (``kernel_tables``'
    ``span``, from the spec alone): the most 64-bit words one stabilizer's
    support spans, 3 padded to 4 (the kernels take 1, 2 and 4)."""
    stabs = np.unique(spec.color_stabs[spec.color_stabs < spec.n_stabs])
    w = np.sort(np.where(spec.stab_ops[stabs] != 0,
                         spec.stab_qubits[stabs] // 64, -1), axis=1)
    first = np.ones_like(w, bool)  # the first of each run of one word
    first[:, 1:] = w[:, 1:] != w[:, :-1]
    span = int(((w >= 0) & first).sum(1).max())
    return span + (span == 3)


def window_table_words(offs) -> int:
    """64-bit words of the table the window kernel reads (from
    ``off_draw`` on: the sweep kernel's dense stabilizer masks stay out)."""
    return offs["n_tab"] - offs["off_draw"]


def _group_scalars(Nc: int, K: int, equal_betas: bool, iters: int,
                   n_draws: int) -> int:
    """4-byte entries of a group's shared memory beside its chains and
    sweep draws, in either form: the exchange's log-uniforms, the mix's
    gates, log-uniforms and logical-draw words, and per rung its
    permutation entry, flag and counts, then the swap counts and the class
    histogram."""
    n_cnt = 1 if equal_betas else 3
    return ((Nc - 1) + 2 * iters + 3 * iters * n_draws + 2 * Nc + Nc * n_cnt
            + (Nc - 1) + K)


def group_bytes(offs, Nc: int, K: int, equal_betas: bool, iters: int,
                n_draws: int) -> int:
    """Shared memory of one syndrome's group in the register form
    (csrc/ladder_window.cu::Layout): its Nc chains published for the
    exchange, twice (by step parity), the step's log-uniforms of every
    sweep and ``_group_scalars``, rounded up to 8 bytes."""
    n4 = (iters * Nc * 4 * offs["n_blk"]
          + _group_scalars(Nc, K, equal_betas, iters, n_draws))
    return -(-(8 * 2 * Nc * 2 * offs["nw"] + 4 * n4) // 8) * 8


def wide_group_bytes(offs, Nc: int, K: int, equal_betas: bool, iters: int,
                     n_draws: int) -> int:
    """Shared memory of one syndrome's group in the large variant
    (csrc/ladder_window.cu::Layout<EQ, true>): its Nc chains, one slot
    each of 4 * nw + 1 words of 32 bits (2 bits a qubit, and a padding word
    against bank conflicts between slots), ``_group_scalars``, and the
    step's burn flag with thread 0's exchange state (tops, since_burn,
    burn_first, the energy row, its countdown and sums); no sweep draws
    (each lane draws its Philox blocks as it decides them), rounded up to 8
    bytes."""
    n4 = (Nc * (4 * offs["nw"] + 1)
          + _group_scalars(Nc, K, equal_betas, iters, n_draws)
          + 6 + (1 if equal_betas else 3))
    return -(-4 * n4 // 8) * 8


def _block_bytes(offs, Nc: int, groups: int, group: int,
                 tab_in_smem: bool) -> int:
    """A block's dynamic shared memory: the window's tables (or none),
    ``groups`` groups of ``group`` bytes, the meta and the betas."""
    return (8 * window_table_words(offs) * int(tab_in_smem) + groups * group
            + 4 * offs["n_meta"] + 4 * 3 * Nc)


def smem_bytes(offs, Nc: int, K: int, groups: int, equal_betas: bool,
               iters: int, n_draws: int, tab_in_smem: bool) -> int:
    """Dynamic shared memory of one block of ``groups`` groups in the
    register form (csrc/ladder_window.cu::Layout)."""
    return _block_bytes(offs, Nc, groups, group_bytes(
        offs, Nc, K, equal_betas, iters, n_draws), tab_in_smem)


def wide_smem_bytes(offs, Nc: int, K: int, groups: int, equal_betas: bool,
                    iters: int, n_draws: int, tab_in_smem: bool) -> int:
    """Dynamic shared memory of one block of ``groups`` groups in the
    large variant: the qubit table (or none), the groups, the meta up to
    the spanned-word entries (color starts, draw starts, op LUT) and the
    betas."""
    return (8 * offs["n_stabs"] * int(tab_in_smem)
            + groups * wide_group_bytes(offs, Nc, K, equal_betas, iters, n_draws)
            + 4 * offs["m_span"] + 4 * 3 * Nc)


def lanes_per_rung(offs, Nc: int) -> int:
    """Lanes that split a rung's proposals: a power of two, about one lane
    per four stabilizers of the widest color, at most 8 (toric d=5: 4, so
    a syndrome's five rungs fit one warp; xzzx d=13: 8)."""
    want = min(8, -(-offs["w_max"] // 4))
    return 1 << max(0, want - 1).bit_length()


class BlockShape(NamedTuple):
    lanes: int  # lanes per rung
    warps_per_group: int  # warps of one syndrome's group
    groups_per_block: int
    threads: int  # threads per block
    tab_in_smem: bool  # tables in shared memory (else device memory)
    smem: int  # dynamic shared memory per block, bytes


def _pack_groups(L: int, Nc: int, B: int, n_sm: int, smem,
                 tab_in_smem: bool, what: str,
                 max_threads: int = MAX_THREADS) -> BlockShape:
    """The launch of one window at ``L`` lanes per rung: a syndrome's
    Nc * L threads padded to whole warps, and groups per block spread so
    that the batch covers about every SM once, within the thread bound
    ``max_threads``, the named barriers of multi-warp groups and 227 KB of
    shared memory (``smem(groups, tab_in_smem)``)."""
    if L & (L - 1) or not 1 <= L <= 32:
        raise ValueError(f"lanes={L}: expected a power of two up to 32")
    wpg = -(-Nc * L // 32)
    cap = max_threads // (32 * wpg)
    if wpg > 1:
        cap = min(cap, MAX_NAMED_BARRIERS)
    if cap < 1:
        raise ValueError(f"Nc={Nc} x lanes={L} exceeds {max_threads} threads")
    gpb = max(1, min(cap, -(-B // n_sm)))
    while gpb > 1 and smem(gpb, tab_in_smem) > SMEM_LIMIT:
        gpb -= 1
    if smem(gpb, tab_in_smem) > SMEM_LIMIT:
        raise ValueError(f"one syndrome's ladder ({what}) does not fit in "
                         f"shared memory")
    return BlockShape(L, wpg, gpb, 32 * wpg * gpb, tab_in_smem,
                      smem(gpb, tab_in_smem))


def block_shape(offs, Nc: int, K: int, B: int, n_sm: int, equal_betas: bool,
                iters: int, n_draws: int) -> BlockShape:
    """The launch of one window in the register form: ``lanes_per_rung``
    lanes per rung, packed by ``_pack_groups``, the tables in shared
    memory when one group fits beside them, else read from device memory
    (toric d=19: 85 KB of tables fit beside a 19-rung group of 125 KB, not
    beside a 25-rung one)."""
    smem = functools.partial(smem_bytes, offs, Nc, K, equal_betas=equal_betas,
                             iters=iters, n_draws=n_draws)
    return _pack_groups(lanes_per_rung(offs, Nc), Nc, B, n_sm,
                        lambda g, t: smem(g, tab_in_smem=t),
                        smem(1, tab_in_smem=True) <= SMEM_LIMIT,
                        f"Nc={Nc}, {offs['nw']} words per plane")


def wide_lanes(offs, Nc: int, per_sm: int) -> int:
    """Lanes per rung of the large variant: the most, a power of two up to
    32, that keep a syndrome within a block's WIDE_MAX_THREADS threads and
    below twice the widest color's Philox blocks (one block a lane and
    round), and, down to 8, ``per_sm`` syndromes on an SM within
    WIDE_WARPS_PER_SM resident warps; at least 1.  One syndrome an SM takes
    32 (toric d=25 at B=128: 25 warps); a batch of several an SM takes 8,
    the rest waiting for a later wave: fewer lanes lengthen the loops a
    rung runs over its words each step (toric d=25, B=1024, a W=60 window
    in 38.2, 32.4 and 28.3 ms at 2, 4 and 8 lanes; chip_window_probe.py,
    NVIDIA H100 80GB HBM3 at 700 W)."""
    blocks = -(-offs["w_max"] // 4)
    L = 32
    while L > 1 and (Nc * L > WIDE_MAX_THREADS or L >= 2 * blocks
                     or (L > 8 and per_sm * -(-Nc * L // 32) > WIDE_WARPS_PER_SM)):
        L //= 2
    return L


def wide_block_shape(offs, Nc: int, K: int, B: int, n_sm: int,
                     equal_betas: bool, iters: int, n_draws: int
                     ) -> BlockShape:
    """The launch of one window in the large variant: ``wide_lanes`` lanes
    per rung, packed by ``_pack_groups`` within WIDE_MAX_THREADS threads,
    the qubit table in shared memory where it fits beside the groups
    (toric d=25: 10 KB), else read from device memory, as every other
    table is."""
    smem = functools.partial(wide_smem_bytes, offs, Nc, K,
                             equal_betas=equal_betas, iters=iters,
                             n_draws=n_draws)
    # the syndromes an SM runs at once: the batch's share, as far as their
    # groups fit its shared memory
    group = smem(2, tab_in_smem=False) - smem(1, tab_in_smem=False)
    fit = max(1, (SMEM_LIMIT - smem(0, tab_in_smem=False)) // group)
    per_sm = min(-(-max(B, 1) // n_sm), fit)
    shape = _pack_groups(wide_lanes(offs, Nc, per_sm), Nc, B, n_sm,
                         lambda g, t: smem(g, tab_in_smem=t), False,
                         f"Nc={Nc}, {offs['nw']} words per plane, large "
                         f"variant", WIDE_MAX_THREADS)
    with_tab = smem(shape.groups_per_block, tab_in_smem=True)
    if with_tab <= SMEM_LIMIT:
        return shape._replace(tab_in_smem=True, smem=with_tab)
    return shape


def window_form(spec: CodeSpec, Nc: int, equal_betas: bool,
                iters: int) -> Optional[str]:
    """Which form of the window kernel runs a window of ``Nc`` rungs of
    ``spec``, decided from shapes alone, before any build or launch:

    - ``"registers"``: the code has a register instantiation
      (``has_kernel_shape``) of fewer than WIDE_FROM_WORDS words per plane,
      one syndrome's Nc x ``lanes_per_rung`` threads fit a block and one
      group fits 227 KB of shared memory with the tables in device memory;
    - ``"large"`` failing that: the large variant, the planes in shared
      memory, takes at most WIDE_WORDS words per plane, Nc <=
      WIDE_MAX_THREADS rungs (at least one lane a rung) and one group in
      227 KB with the tables in device memory;
    - None beyond both, where PTEQ runs the unfused window
      (decoders/pteq.py::_get_window_fn), as the JAX package does where
      its fused kernel does not fit (pteq.py:306-309).

    The two forms give equal outputs, so the rule moves only time.  It
    rests on chip_window_probe.py's production windows (W=600, two sweeps
    a step) in both forms on an NVIDIA H100 80GB HBM3 at 700 W, large
    variant against register form: at 16 words 37.7 against 319.7 ms
    (toric d=21, B=64) and 39.5 against 256.1 (rotated d=29, B=128); at 12
    words 28.2 against 149.2 (toric d=17, B=64), 74.7 against 728.1
    (toric d=19, B=512), 35.6 against 110.9 (rotated d=27, B=128) and
    85.7 against 444.8 (xzzx d=25, B=512, general betas).  Below 12 words
    the forms split: the large variant is faster at toric d=15 and d=13
    (46.6 against 178.7 and 40.9 against 92.4 at B=512), slower at xzzx
    d=13 (24.3 against 20.9, B=512) and toric d=5 (21.8 against 7.7,
    B=2048), the production and study shapes the register form was
    designed for; ``WIDE_FROM_WORDS`` is where to move that line.
    ``block_shape`` and ``wide_block_shape`` find a launch at every batch
    of the form it names."""
    K, nd = spec.n_classes, len(spec.logical_draws)
    if has_kernel_shape(spec):
        offs = kernel_tables(spec)[2]
        threads = 32 * -(-Nc * lanes_per_rung(offs, Nc) // 32)
        if offs["nw"] < WIDE_FROM_WORDS and threads <= MAX_THREADS and smem_bytes(
                offs, Nc, K, 1, equal_betas, iters, nd,
                tab_in_smem=False) <= SMEM_LIMIT:
            return "registers"
    large = (-(-spec.nq // 64) <= WIDE_WORDS and 1 <= Nc <= WIDE_MAX_THREADS
             and wide_smem_bytes(kernel_tables(spec)[2], Nc, K, 1,
                                 equal_betas, iters, nd,
                                 tab_in_smem=False) <= SMEM_LIMIT)
    return "large" if large else None


def window_kernel_fits(spec: CodeSpec, Nc: int, equal_betas: bool,
                       iters: int) -> bool:
    """Whether either form of the window kernel runs a window of ``Nc``
    rungs of ``spec`` (``window_form`` is not None).  Where it is False,
    PTEQ runs the unfused window instead (decoders/pteq.py::_get_window_fn),
    as the JAX package does where its fused kernel does not fit."""
    return window_form(spec, Nc, equal_betas, iters) is not None


def window_limit(spec: CodeSpec, Nc: int) -> str:
    """Why no form of the window kernel holds ``Nc`` rungs of ``spec``,
    naming the large variant's limits."""
    return (f"no form of the window kernel holds Nc={Nc} rungs of nq="
            f"{spec.nq} ({-(-spec.nq // 64)} words per plane): the large "
            f"variant takes at most {WIDE_WORDS} words per plane (nq <= "
            f"{64 * WIDE_WORDS}), {WIDE_MAX_THREADS} rungs and one "
            f"syndrome's planes, 4 * Nc * (4 * words + 1) bytes, within "
            f"{SMEM_LIMIT} B of shared memory; the plain version on the CPU "
            f"takes any size")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, state on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The kernel's C entry point, built and loaded on first use."""
    from . import _build

    fn = _build.load("ladder_window").mqt_ladder_window
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _layout_fields(spec: CodeSpec, B: int, Nc: int, iters: int,
                   equal_betas: bool, device: torch.device):
    """(BlockShape, the ``_Params`` fields that set the kernel's form,
    shape and shared-memory layout) of a window launch on ``device``; a
    ``ValueError`` where no form holds the ladder (``window_form``)."""
    form = window_form(spec, Nc, equal_betas, iters)
    if form is None:
        raise ValueError(window_limit(spec, Nc))
    _, _, offs = kernel_tables(spec)
    K, n_draws = spec.n_classes, len(spec.logical_draws)
    plan = block_shape if form == "registers" else wide_block_shape
    shape = plan(offs, Nc, K, B, _sm_count(device), equal_betas, iters,
                 n_draws)
    base = offs["off_draw"]  # the window kernel's table starts there
    wide = form == "large"
    return shape, dict(
        B=B, Nc=Nc, nq=spec.nq, nw=offs["nw"], K=K, n_bits=spec.n_class_bits,
        n_colors=offs["n_colors"], n_draws=n_draws, iters=iters,
        span=offs["span"], lanes=shape.lanes,
        lane_shift=shape.lanes.bit_length() - 1,
        warps_per_group=shape.warps_per_group,
        groups_per_block=shape.groups_per_block,
        n_tab=offs["n_stabs"] if wide else window_table_words(offs),
        n_meta=offs["m_span"] if wide else offs["n_meta"],
        off_class=offs["off_class"] - base, off_key=offs["off_key"] - base,
        off_span=offs["off_span"] - base, m_draw=offs["m_draw"],
        m_lut=offs["m_lut"], m_b2e=offs["m_b2e"], m_span=offs["m_span"],
        m_blk=offs["m_blk"], m_bcol=offs["m_bcol"], n_blk=offs["n_blk"],
        equal_betas=int(equal_betas), tab_in_smem=int(shape.tab_in_smem),
        smem=shape.smem, wide=int(wide),
    )


@functools.lru_cache(maxsize=None)
def _resident_blocks(layout: tuple, device: torch.device) -> int:
    """Blocks of the launch ``layout`` (``_layout_fields``' fields but the
    batch, as sorted items) one SM of ``device`` holds at once: the
    occupancy calculator's answer for the built kernel's registers, threads
    and shared memory; asked once a shape."""
    from . import _build

    fn = _build.load("ladder_window").mqt_ladder_window_resident_blocks
    fn.argtypes = [ctypes.POINTER(_Params)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        n = fn(ctypes.byref(_Params(**dict(layout))))
    if n < 0:
        raise RuntimeError(f"occupancy query failed for {dict(layout)}")
    return n


def _shape_key(layout: dict) -> tuple:
    return tuple(sorted((k, v) for k, v in layout.items() if k != "B"))


def launch_plan(spec: CodeSpec, B: int, Nc: int, iters: int,
                equal_betas: bool, device="cuda"):
    """(BlockShape, blocks of it one SM holds at once) of a window launch
    at this shape on a CUDA ``device``, in the form ``window_form`` picks:
    the occupancy calculator's answer for the built kernel's registers,
    threads and shared memory."""
    device = torch.device(device)
    shape, layout = _layout_fields(spec, B, Nc, iters, equal_betas, device)
    return shape, _resident_blocks(_shape_key(layout), device)


def resident_rows(shape: BlockShape, blocks_per_sm: int, n_sm: int) -> int:
    """Syndrome rows a window launch of ``shape`` runs on the card at once:
    its groups a block, times the blocks an SM holds, times the SMs.  A
    launch of B rows runs in about B over this many waves."""
    return shape.groups_per_block * blocks_per_sm * n_sm


def _record_launch(shape: BlockShape, layout: dict, device: torch.device,
                   B: int) -> None:
    """The recorder's counters of one launch (``utils/profiling.py``, only
    while it records): ``k2.form.registers`` or ``k2.form.large``, one a
    launch; ``k2.resident_rows``, the rows its shape holds at once
    (``resident_rows``), and ``k2.waves_micro``, its rows over those in
    millionths of a wave, each summed over launches.  Off, the read of the
    recorder's flag is all it costs."""
    if not profiling.recording():
        return
    profiling.count("k2.form.large" if layout["wide"] else "k2.form.registers")
    held = resident_rows(shape, _resident_blocks(_shape_key(layout), device),
                         _sm_count(device))
    profiling.count("k2.resident_rows", held)
    profiling.count("k2.waves_micro", round(1e6 * B / held))


def _launch(spec, state, flag, tops0, eq_count, since_burn, seed, betas,
            weights, *, window, iters, p_logical, tops_burn, energy_chunk,
            top_exact, equal_betas, exchange, track_traces, fixed,
            device_tables) -> WindowOut:
    device = state.device
    B, Nc, nq = state.shape
    K = spec.n_classes
    if nq != spec.nq:
        raise ValueError(f"state has {nq} qubits, spec {spec.nq}")
    if window_form(spec, Nc, equal_betas, iters) is None:
        raise ValueError(window_limit(spec, Nc))
    _check(state, "state", (B, Nc, nq), torch.uint8, device)
    _check(flag, "flag", (B, Nc), torch.int32, device)
    _check(tops0, "tops0", (B,), torch.int32, device)
    _check(eq_count, "eq_count", (B, K), torch.int32, device)
    _check(since_burn, "since_burn", (B,), torch.int32, device)
    betas_d = torch.as_tensor(betas, dtype=torch.float32, device=device)
    _check(betas_d, "betas", (Nc, 3), torch.float32, device)
    w = [float(v) for v in
         np.asarray(torch.as_tensor(weights, dtype=torch.float32).cpu()).reshape(3)]

    tab_np, meta_np, offs = kernel_tables(spec)
    if device not in device_tables:
        device_tables[device] = (
            torch.as_tensor(tab_np[offs["off_draw"]:], device=device),
            torch.as_tensor(meta_np, device=device),
        )
    tab, meta = device_tables[device]

    out = (
        torch.empty_like(state), torch.empty_like(flag), torch.empty_like(tops0),
        torch.empty_like(eq_count), torch.empty_like(since_burn),
        torch.empty((window // energy_chunk, B), dtype=torch.float32, device=device),
        torch.empty((B,), dtype=torch.bool, device=device),
        torch.empty((B,), dtype=torch.int32, device=device),
        torch.empty((B, Nc - 1), dtype=torch.int32, device=device),
    )
    if track_traces:
        out = out + (
            torch.empty((window, B), dtype=torch.int32, device=device),
            torch.empty((window, B, N_KEY), dtype=torch.int32, device=device),
        )
    if B == 0:
        return out
    shape, layout = _layout_fields(spec, B, Nc, iters, equal_betas, device)
    qtab = None  # only the large variant reads the qubit table
    if layout["wide"]:
        if (device, "qubits") not in device_tables:
            device_tables[device, "qubits"] = torch.as_tensor(
                qubit_table(spec), device=device)
        qtab = device_tables[device, "qubits"]
    P = _Params(
        **layout, window=window, tops_burn=tops_burn,
        energy_chunk=energy_chunk, fixed=int(fixed is not None),
        top_exact=int(top_exact), even_odd=int(exchange == "even_odd"),
        traces=int(track_traces), p_logical=p_logical, w0=w[0], w1=w[1], w2=w[2],
        inv_chunk=float(np.float32(1.0 / energy_chunk)),
        key0=int(seed) & MASK32, key1=(int(seed) >> 32) & MASK32,
        fixed_word=fixed or 0,
    )
    traces = out[9:] if track_traces else (None, None)
    bufs = _Buffers(*(t.data_ptr() if t is not None else None for t in (
        state, out[0], flag, out[1], tops0, out[2], eq_count, out[3],
        since_burn, out[4], out[5], out[6], out[7], out[8], *traces, betas_d,
        tab, meta, qtab,
    )))
    entry = _kernel_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(ctypes.byref(P), ctypes.byref(bufs), stream)
    if err != 0:
        raise RuntimeError(
            f"ladder_window kernel launch failed: cudaError {err} "
            f"(B={B}, Nc={Nc}, nq={nq}, nw={offs['nw']}, {shape})"
        )
    ladder_window_counts.add_launch(B)
    _record_launch(shape, layout, device, B)
    return out


def make_ladder_window(
    spec: CodeSpec,
    Nc: int,
    window: int,
    iters: int,
    p_logical: float,
    tops_burn: int,
    energy_chunk: int = 1,
    top_exact: bool = False,
    equal_betas: bool = False,
    track_traces: bool = False,
    exchange: str = "sequential",
    rng: str = "philox",
):
    """Build ``fn(state, flag, tops0, eq_count, since_burn, seed, betas,
    weights)`` running one PTEQ window of ``window`` ladder steps.

    As in ``make_pallas_ladder_window``, the caller asserts with
    ``top_exact=True`` that the top rung's betas are exactly zero (the
    logical mix always accepts; otherwise it runs ``iters`` Metropolis
    rounds) and with ``equal_betas=True`` that every rung has beta_x ==
    beta_y == beta_z and the weights are uniform (acceptance, exchange and
    energy on total counts; otherwise per Pauli).  ``exchange`` is
    ``"sequential"`` (top->bottom) or ``"even_odd"``.

    Shapes (B = syndrome batch):
      state (B, Nc, nq) u8, flag (B, Nc) i32, tops0 (B,) i32,
      eq_count (B, K) i32, since_burn (B,) i32, seed int,
      betas (Nc, 3) f32, weights (3,) f32 energy weights.
    Returns (state, flag, tops0, eq_count, since_burn,
             energies (window // energy_chunk, B) f32 chunk means,
             burn_any (B,) bool, burn_first (B,) i32,
             swap_acc (B, Nc-1) i32 accepted swaps per rung pair), and with
    ``track_traces`` also eq_trace (window, B) i32, the bottom rung's class
    per step, and key_trace (window, B, 4) i32, its chain hash
    sum_q v_q * c_q per component (``key_coefficients``).

    The device of ``state`` decides: CUDA launches the kernel (one launch
    per call, counted in ``ladder_window_counts.launches``), CPU runs
    ``ladder_window_reference`` (counted in ``plain_calls``); any other
    device raises.  Only the kernel is bounded by the code's size: the CUDA
    branch runs the register form or the large variant (``window_form``)
    and raises a ``ValueError`` before it launches where neither holds the
    ladder (``window_limit``; ``window_kernel_fits`` says so up front);
    the plain version takes any code.
    ``rng="zeros"`` makes every random draw 0 and an integer ``rng`` makes
    every draw that 32-bit word (parity tests and the chip smoke check
    only)."""
    if window % energy_chunk != 0:
        raise ValueError(
            f"window ({window}) must be divisible by energy_chunk ({energy_chunk})"
        )
    fixed = _fixed_word(rng)
    if exchange not in ("sequential", "even_odd"):
        raise ValueError(
            f"exchange={exchange!r}: expected 'sequential' or 'even_odd'"
        )
    kw = dict(window=window, iters=iters, p_logical=float(p_logical),
              tops_burn=tops_burn, energy_chunk=energy_chunk,
              top_exact=top_exact, equal_betas=equal_betas, exchange=exchange,
              track_traces=track_traces)
    device_tables = {}

    def fn(state, flag, tops0, eq_count, since_burn, seed, betas, weights):
        if state.shape[1] != Nc:
            raise ValueError(f"state has {state.shape[1]} rungs, window {Nc}")
        if state.device.type == "cuda":
            return _launch(spec, state, flag, tops0, eq_count, since_burn,
                           seed, betas, weights, fixed=fixed,
                           device_tables=device_tables, **kw)
        if state.device.type == "cpu":
            ladder_window_counts.add_plain(state.shape[0])
            return ladder_window_reference(
                spec, state, flag, tops0, eq_count, since_burn, seed, betas,
                weights, rng=rng, **kw,
            )
        raise ValueError(f"no ladder window for device {state.device}")

    return fn
