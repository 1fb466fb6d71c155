"""One PTEQ parallel-tempering window: CUDA kernel and plain PyTorch version.

Counterpart of ``mcmc_qec_tpu/ops/pallas_ladder.py`` (the fused Pallas TPU
window).  ``make_ladder_window`` returns a function with the exact
``_get_window_fn`` contract of ``make_pallas_ladder_window``
(pallas_ladder.py:160-210).  It dispatches on the device of the state:

- a CUDA tensor launches ``csrc/ladder_window.cu`` (built with ``nvcc`` at
  first use, ``ops/_build.py``) once per window, or raises;
- a CPU tensor runs ``ladder_window_reference``, the plain version.

The kernel has two forms, picked at each launch from its shape
(``window_form``): the register form, each rung's planes in its lanes'
registers (``WINDOW_SHAPES``, up to 4 words per plane), and the large
variant, the planes in shared memory at 2 bits a qubit and the word count
a run-time value, for every ladder the registers cannot hold (codes of 6
words per plane and more, up to WIDE_WORDS; groups too large for the
register form's shared memory) and for the launches where it is the
faster form (the waves of each and ``wave_cost``).  Both compute the same
function.  A register-form launch that fills less than a wave runs more
lanes a rung where that was measured faster (``window_lanes``).  The
tables both kernels read are ``ops/kernel_tables.py``'s.

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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import CodeSpec
from ..utils import profiling
from .dense_sweep import _color_tables
from .kernel_tables import (
    _DRAW_BUDGET,
    N_KEY,
    SMEM_LIMIT,
    WIDE_MAX_THREADS,
    WIDE_WARPS_PER_SM,
    WIDE_WORDS,
    KernelCounter,
    _check,
    _draw_words,
    _plain_tables,
    _PlainTables,
    _sm_count,
    is_wide,
    kernel_tables,
    kernel_words,
    lanes_per_rung,
    qubit_table,
    spanned_words,
)
from .philox import MASK32

# (words per plane, spanned-word entries per stabilizer) the register form
# is instantiated for (csrc/ladder_window.cu::dispatch; a stabilizer
# spanning 3 words is padded to 4 entries): the shapes where
# ``window_form`` can pick it.  From 6 words per plane on the large variant
# holds every ladder the register form holds, and the rule picks it at
# every batch (``window_form``'s table), so those shapes have no register
# build
WINDOW_SHAPES = ((1, 1), (2, 2), (3, 2), (3, 4), (4, 2), (4, 4))
# threads per block of the window kernel (csrc/ladder_window.cu::kMaxThreads)
MAX_THREADS = 512
# what one SM of the card (Hopper, sm_90) holds of a launch: shared memory,
# of which the runtime keeps 1 KB a block, and blocks; its registers are
# counted through each form's launch bounds (``blocks_per_sm``)
SM_SMEM = 233472
SMEM_RESERVED = 1024
SM_BLOCKS = 32
# how ``window_form`` models a launch's time: a wave of the register form
# costs a + b * (words per plane) + c * (spanned words per stabilizer)
# waves of the large variant over the same rows, and a wave that puts r
# rows on each SM takes r ** ROWS_EXPONENT times as long as one row alone;
# fitted by least squares to the log of the two forms' time ratio over
# chip_window_probe.py --grid's 113 pairs
WAVE_COST = (-0.03, 0.215, 0.135)
ROWS_EXPONENT = 0.57
# named barriers a block has for multi-warp groups (id 0 is __syncthreads)
MAX_NAMED_BARRIERS = 15
# the lanes per rung a register-form launch under a wave widens to
# (``window_lanes``), per ladder chip_window_probe.py --lanes measured:
# (words per plane, spanned words per stabilizer, Nc, equal betas, iters)
# -> ((lanes, the most rows an SM, ceil(B / SMs), at which they were the
# fastest measured), ...), widest first
WIDER_LANES = {
    (1, 1, 5, True, 10): ((16, 4), (8, 8)),  # toric d=5, the d=5 cells
    (1, 1, 5, True, 2): ((16, 4), (8, 8)),
    (2, 2, 7, True, 10): ((32, 1),),  # toric d=7
    (2, 2, 7, True, 2): ((32, 1),),
    (3, 2, 13, False, 10): ((16, 1),),  # xzzx d=13, general betas
    (3, 2, 13, False, 2): ((16, 1),),
}
# Philox uses per step after the sweeps (gates, draws, exchange, MH accept)
_N_EXTRA_USES = 4

WindowOut = Tuple[torch.Tensor, ...]


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


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


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


def has_window_shape(spec: CodeSpec) -> bool:
    """Whether the window kernel's register form is built for ``spec``: its
    (words per plane, spanned words per stabilizer) in WINDOW_SHAPES.  The
    large variant beside it takes every other code up to WIDE_WORDS words
    per plane, and the ladders too large for the registers
    (``window_forms``)."""
    if is_wide(spec):
        return False
    return (kernel_words(spec.nq), spanned_words(spec)) in WINDOW_SHAPES


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
                iters: int, n_draws: int, lanes: Optional[int] = None
                ) -> BlockShape:
    """The launch of one window in the register form: ``lanes`` lanes per
    rung (``lanes_per_rung``'s by default), packed by ``_pack_groups``, the
    tables in shared memory when one group fits beside them, else read
    from device memory (toric d=19: 85 KB of tables fit beside a 19-rung
    group of 125 KB, not beside a 25-rung one)."""
    smem = functools.partial(smem_bytes, offs, Nc, K, equal_betas=equal_betas,
                             iters=iters, n_draws=n_draws)
    return _pack_groups(lanes or lanes_per_rung(offs, Nc), Nc, B, n_sm,
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


def blocks_per_sm(shape: BlockShape, max_threads: int) -> int:
    """Blocks of ``shape`` one SM holds at once, from its shared memory
    (SM_SMEM, SMEM_RESERVED a block), SM_BLOCKS and its registers: a kernel
    launched under ``__launch_bounds__(max_threads, 1)`` takes at most the
    registers of ``max_threads`` threads an SM, so an SM holds ``max_threads
    // threads`` of its blocks (ptxas gives the register form 122-128
    registers a thread at MAX_THREADS, the large variant 64 at
    WIDE_MAX_THREADS).  Where this is more than one wave needs, the
    occupancy calculator may say fewer (``_resident_blocks``); the waves
    stay the same."""
    return min(SM_SMEM // (shape.smem + SMEM_RESERVED),
               max_threads // shape.threads, SM_BLOCKS)


@functools.lru_cache(maxsize=None)
def window_forms(spec: CodeSpec, Nc: int, equal_betas: bool,
                 iters: int) -> Tuple[str, ...]:
    """The forms of the window kernel that hold a window of ``Nc`` rungs of
    ``spec``, from shapes alone, whatever the batch:

    - ``"registers"``: the code has a register instantiation
      (``has_window_shape``), one syndrome's Nc x ``lanes_per_rung``
      threads fit a block and one group fits 227 KB of shared memory with
      the tables in device memory;
    - ``"large"``: the large variant, the planes in shared memory, takes at
      most WIDE_WORDS words per plane, Nc <= WIDE_MAX_THREADS rungs (at
      least one lane a rung) and one group in 227 KB with the tables in
      device memory.

    None of them: PTEQ runs the unfused window
    (decoders/pteq.py::_get_window_fn), as the JAX package does where its
    fused kernel does not fit (pteq.py:306-309).  ``block_shape`` and
    ``wide_block_shape`` find a launch at every batch of each form named."""
    K, nd = spec.n_classes, len(spec.logical_draws)
    forms = []
    if has_window_shape(spec):
        offs = kernel_tables(spec)[2]
        threads = 32 * -(-Nc * lanes_per_rung(offs, Nc) // 32)
        if threads <= MAX_THREADS and smem_bytes(
                offs, Nc, K, 1, equal_betas, iters, nd,
                tab_in_smem=False) <= SMEM_LIMIT:
            forms.append("registers")
    if (-(-spec.nq // 64) <= WIDE_WORDS and 1 <= Nc <= WIDE_MAX_THREADS
            and wide_smem_bytes(kernel_tables(spec)[2], Nc, K, 1, equal_betas,
                                iters, nd, tab_in_smem=False) <= SMEM_LIMIT):
        forms.append("large")
    return tuple(forms)


def wave_cost(offs) -> float:
    """The register form's time for one wave of rows over the large
    variant's, at the code's words per plane and spanned words per
    stabilizer (WAVE_COST): 0.32 at 1 word, 0.89 at 3 words spanning 2,
    1.16 at 3 words spanning 4, 1.80 at 6 words spanning 4, 2.82 and more
    from 12 words on."""
    a, b, c = WAVE_COST
    return a + b * offs["nw"] + c * offs["span"]


@functools.lru_cache(maxsize=4096)
def window_form(spec: CodeSpec, Nc: int, equal_betas: bool, iters: int,
                B: int, n_sm: int) -> Optional[str]:
    """Which form of the window kernel runs a window of ``Nc`` rungs of
    ``spec`` over ``B`` syndrome rows on a card of ``n_sm`` SMs, decided
    from shapes alone, before any build or launch: of ``window_forms``, the
    one of the lower modelled time, or None where neither holds the ladder.
    The two forms give equal outputs, so the rule moves only time, and the
    form may change between the windows of one decode as compaction
    shrinks the batch.

    The model: a launch runs in ceil(B / held) waves, ``held`` the rows its
    shape holds at once (groups a block x ``blocks_per_sm`` x n_sm, from
    ``block_shape`` and ``wide_block_shape``); a wave that puts r = min(B,
    held) / n_sm rows on each SM takes r ** ROWS_EXPONENT times one row's
    time, as rows hide each other's latency in part; and a wave of the
    register form costs ``wave_cost`` waves of the large variant, as its
    lanes each hold and exchange the whole planes while the large
    variant's touch only their own qubits.  So the register form keeps the
    codes of 1 and 2 words a plane and those of 3 words spanning 2 while
    its waves are few; the large variant takes the rest, and every launch
    at iters=10 whose staged sweep draws leave the register form one group
    an SM.

    The measurements it rests on (chip_window_probe.py --grid fit and
    check: one W=600 window, C=12, Nc=d, a zero top rung, both forms each
    forced on the same inputs, all nine outputs equal at every shape;
    NVIDIA H100 80GB HBM3 at 700 W, 132 SMs), register form / large variant
    in ms, e = equal betas, g = general (``PTEQ_alpha``'s at eta=10,
    p=0.276), toric, planar and rotated at p=0.19:

    ====================  =====  ====================  ====================
    code (words, span)    B      iters=2               iters=10
    ====================  =====  ====================  ====================
    toric d=5 (1, 1)      16     5.58 / 14.48          22.18 / 64.84
                          512    5.61 / 14.48          22.26 / 65.16
                          1024   6.20 / 16.50          24.75 / 75.10
                          2048   7.66 / 21.83          31.45 / 101.09
                          2603   15.22 / 25.38         62.78 / 117.85
                          4096   15.39 / 38.14         63.32 / 179.27
    toric d=7 (2, 2)      64     8.54 / 14.36          37.27 / 66.52
                          512    9.71 / 16.25          43.14 / 76.31
                          1024   12.89 / 21.35         118.26 / 102.52
                          2048   25.33 / 71.55         175.96 / 352.39
                          4096   51.05 / 108.14        295.95 / 532.82
    xzzx d=9 (2, 2) e     512    8.66 / 13.97          35.11 / 62.10
    xzzx d=11 (2, 2) g    512    12.74 / 22.02         110.78 / 102.35
    rotated d=11 (2, 2)   512    11.15 / 19.78         96.98 / 92.62
    xzzx d=13 (3, 2) g    132    12.88 / 13.68         55.11 / 59.74
                          512    20.93 / 24.92         129.91 / 117.54
                          2048   83.18 / 90.10         519.10 / 442.62
    xzzx d=13 (3, 2) e    512    19.25 / 22.72         121.18 / 106.90
    toric d=9 (3, 4)      64     15.99 / 14.72         70.72 / 66.60
                          512    23.99 / 23.40         220.49 / 112.26
                          2048   116.20 / 84.57        659.23 / 412.72
    planar d=9 (3, 4)     512    19.52 / 14.85         91.15 / 69.03
    xzzx d=15 (4, 2) g    512    30.42 / 28.72         314.09 / 134.57
    rotated d=15 (4, 2)   512    28.19 / 25.55         276.07 / 121.08
    toric d=11 (4, 4)     64     24.95 / 16.36         116.49 / 75.80
                          512    40.17 / 27.09         465.81 / 129.92
                          2048   202.39 / 100.88       1860.31 / 495.67
    toric d=13 (6, 4)     64     37.52 / 20.54         178.21 / 95.37
                          256    51.77 / 30.51         358.98 / 146.69
                          512    91.53 / 42.80         711.94 / 209.15
                          1024   184.44 / 66.20        1434.10 / 328.12
                          2048   366.02 / 131.25       2844.52 / 650.65
    planar d=13 (6, 4)    512    78.22 / 31.83         606.55 / 153.79
    xzzx d=17 (6, 2) g    132    28.37 / 20.23         131.46 / 89.45
                          512    89.64 / 38.91         524.45 / 186.11
    toric d=15 (8, 4)     512    177.58 / 50.40        (large only) 247.98
                          2048   714.01 / 160.31       (large only) 794.56
    xzzx d=21 (8, 2) g    512    130.01 / 62.20        (large only) 300.99
    toric d=17 (12, 4)    64     149.2 / 28.2          --
    toric d=19 (12, 4)    512    728.1 / 74.7          --
    rotated d=27 (12, 2)  128    110.9 / 35.6          --
    xzzx d=25 (12, 2) g   512    444.8 / 85.7          --
    toric d=21 (16, 4)    64     319.7 / 37.7          --
    rotated d=29 (16, 2)  128    256.1 / 39.5          --
    ====================  =====  ====================  ====================

    Rotated d=9, 13 and 17 read as xzzx codes of the same size and betas
    within 2%, general betas 6-13% slower than equal ones in both forms,
    toric d=5 at B=64 to 300 as at B=16 and toric d=7 to d=15 at B=132 as
    at B=64.  The rule picks the faster form at 112 of the 113 pairs of
    both grids; at the other, xzzx d=13 at B=2048 and iters=2, the large
    variant it picks takes 8% longer.  The 12- and 16-word rows are
    chip_window_probe.py's both-forms line at p=0.05 on the same card
    model; the rule picks the large variant there at every batch.  The
    rows from 6 words a plane on, where the large variant won every pair
    and the rule never picks the register form, are why those shapes have
    no register build (WINDOW_SHAPES)."""
    forms = window_forms(spec, Nc, equal_betas, iters)
    if len(forms) < 2:
        return forms[0] if forms else None
    offs = kernel_tables(spec)[2]
    K, nd = spec.n_classes, len(spec.logical_draws)
    rows = max(B, 1)
    args = (offs, Nc, K, rows, n_sm, equal_betas, iters, nd)

    def modelled(shape: BlockShape, max_threads: int) -> float:
        held = resident_rows(shape, blocks_per_sm(shape, max_threads), n_sm)
        return -(-rows // held) * (min(rows, held) / n_sm) ** ROWS_EXPONENT

    registers = modelled(block_shape(*args), MAX_THREADS) * wave_cost(offs)
    large = modelled(wide_block_shape(*args), WIDE_MAX_THREADS)
    return "registers" if registers < large else "large"


@functools.lru_cache(maxsize=4096)
def window_lanes(spec: CodeSpec, Nc: int, equal_betas: bool, iters: int,
                 B: int, n_sm: int) -> int:
    """Lanes per rung of a register-form launch of ``B`` rows, once
    ``window_form`` has picked that form (from ``block_shape``'s launch at
    ``lanes_per_rung``'s lanes): wider where the launch fills less than a
    wave, so that a syndrome's serial step, its draws and its proposals,
    splits over more threads.

    Of WIDER_LANES' entries for the ladder (words per plane, spanned words,
    Nc, betas form, iters), widest first, the first at 2 or 4 times
    ``lanes_per_rung``'s lanes whose measured rows an SM reach ceil(B /
    n_sm) and whose launch still holds every row at once
    (``block_shape`` at those lanes, ``blocks_per_sm`` at MAX_THREADS; the
    named barriers and shared memory bound its groups a block); else
    ``lanes_per_rung``'s, and always so at one wave or more and at ladders
    the table does not name.  Draws are keyed by Philox block, step and
    row, not by thread, so the outputs are the same at every lane count.

    Below a wave a window's time is one syndrome's serial step: its draws
    (all the group's threads), its proposals (a rung's lanes) and the
    exchange; more lanes split the first two while the SMs keep warp
    slots free, until the wider groups hold fewer rows than the batch.
    The measurements (chip_window_probe.py --lanes: one W=600 window, C=12,
    Nc=d, a zero top rung, the register form forced at each lane count,
    all nine outputs equal to the default lanes' at every shape; NVIDIA H100
    80GB HBM3 at 700 W, 132 SMs), ms at 4, 8, 16 and 32 lanes a rung (8,
    16 and 32 at d=7 and 13), * where the launch runs more than one wave;
    toric at p=0.15 (p=0.19 within 0.5%), xzzx at ``PTEQ_alpha``'s general
    betas, eta=10, p=0.276:

    ===============  ====  ===========================  ===========================
    ladder           B     iters=10                     iters=2
    ===============  ====  ===========================  ===========================
    toric d=5 Nc=5   16    22.37 17.87 16.40 18.14      5.61 4.50 4.16 4.79
    (1, 1) equal     64    22.39 17.86 16.40 18.17      5.70 4.53 4.17 4.80
                     132   22.40 17.89 16.43 18.21      5.63 4.54 4.19 4.82
                     264   22.34 17.89 17.41 19.91      5.68 4.58 4.45 5.24
                     512   22.47 19.59 19.42 43.85*     5.70 4.94 4.84 11.10*
                     660   24.82 21.49 21.50 43.86*     6.19 5.29 5.23 11.11*
                     821   24.88 23.94 42.67* 65.51*    6.20 5.80 10.37* 16.43*
                     1056  24.90 23.99 42.74* 65.70*    6.21 5.79 10.39* 16.58*
                     1500  27.94 47.78* 63.94* 87.57*   6.93 11.49* 15.51* 22.07*
                     2048  31.72 47.87* 85.15* 131.1*   7.75 11.50* 20.59* 32.94*
                     2603  63.22* 71.62* 85.37* 153.1*  15.32* 17.14* 20.63* 38.45*
    toric d=7 Nc=7   132   37.55 29.65 28.80            8.59 7.23 7.01
    (2, 2) equal     512   43.50 45.19 72.14*           9.82 10.39 16.51*
                     2048  177.45* 180.34* 287.98*      25.58* 40.98* 65.29*
    xzzx d=13 Nc=13  132   55.06 44.50 49.08            13.06 11.13 11.95
    (3, 2) general   512   129.86* 121.45* 195.96*      20.96 28.12* 47.24*
                     2048  519.64* 485.37* 782.80*      83.22* 111.86* 188.41*
    ===============  ====  ===========================  ===========================

    So at toric d=5 16 lanes up to 4 rows an SM (1.36x at B <= 132, 1.16x
    at 512), 8 from 5 to 8 (1.15x at 660, 1.04x at 821-1056, where 16
    lanes need a second wave), 32 nowhere (a rung's 10 proposals a color
    leave 22 of its lanes idle); at toric d=7 and xzzx d=13 the widest
    faster count only at one row an SM.  xzzx d=13 at 512 and 2048 rows
    and iters=10 runs the large variant (``window_form``); 16 lanes there
    are 7% faster in the same waves, which the rule, keeping the default
    from one wave on, leaves unused."""
    offs = kernel_tables(spec)[2]
    base = lanes_per_rung(offs, Nc)
    wider = WIDER_LANES.get((offs["nw"], offs["span"], Nc, equal_betas, iters))
    if not wider:
        return base
    rows = max(B, 1)
    args = (offs, Nc, spec.n_classes, rows, n_sm, equal_betas, iters,
            len(spec.logical_draws))

    def held(lanes: int) -> int:
        shape = block_shape(*args, lanes=lanes)
        return resident_rows(shape, blocks_per_sm(shape, MAX_THREADS), n_sm)

    if rows >= held(base):
        return base
    per_sm = -(-rows // n_sm)
    for lanes, most in wider:
        if (lanes in (2 * base, 4 * base) and per_sm <= most
                and held(lanes) >= rows):
            return lanes
    return base


def window_kernel_fits(spec: CodeSpec, Nc: int, equal_betas: bool,
                       iters: int) -> bool:
    """Whether either form of the window kernel runs a window of ``Nc``
    rungs of ``spec`` at any batch (``window_forms``).  Where it is False,
    PTEQ runs the unfused window instead (decoders/pteq.py::_get_window_fn),
    as the JAX package does where its fused kernel does not fit."""
    return bool(window_forms(spec, Nc, equal_betas, iters))


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
    form = window_form(spec, Nc, equal_betas, iters, B, _sm_count(device))
    if form is None:
        raise ValueError(window_limit(spec, Nc))
    _, _, offs = kernel_tables(spec)
    K, n_draws = spec.n_classes, len(spec.logical_draws)
    n_sm = _sm_count(device)
    args = (offs, Nc, K, B, n_sm, equal_betas, iters, n_draws)
    wide = form == "large"
    if wide:
        shape = wide_block_shape(*args)
    else:
        shape = block_shape(*args, lanes=window_lanes(
            spec, Nc, equal_betas, iters, B, n_sm))
    base = offs["off_draw"]  # the window kernel's table starts there
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
                   B: int, equal_betas: bool) -> None:
    """The recorder's counters of one launch (``utils/profiling.py``, only
    while it records): ``k2.form.registers`` or ``k2.form.large``, one a
    launch, and ``k2.rows.registers`` or ``k2.rows.large``, its rows; for
    the register form ``k2.lanes.<L>``, one a launch at L lanes per rung
    (``window_lanes``); ``k2.betas.general``, one a launch with per-Pauli
    betas; ``k2.resident_rows``, the rows its shape holds at once
    (``resident_rows``), and ``k2.waves_micro``, its rows over those in
    millionths of a wave, each summed over launches.  Off, the read of the
    recorder's flag is all it costs."""
    if not profiling.recording():
        return
    form = "large" if layout["wide"] else "registers"
    profiling.count(f"k2.form.{form}")
    profiling.count(f"k2.rows.{form}", B)
    if not layout["wide"]:
        profiling.count(f"k2.lanes.{shape.lanes}")
    if not equal_betas:
        profiling.count("k2.betas.general")
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
    if not window_kernel_fits(spec, Nc, equal_betas, iters):
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
    _record_launch(shape, layout, device, B, equal_betas)
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
