"""Colored Metropolis sweeps over a batch of chains, and the counting
decoders' recording sampler: CUDA kernel and plain PyTorch versions.

Counterpart of ``mcmc_qec_tpu/ops/pallas_sweep.py`` (the Pallas TPU kernel
K1).  One kernel, ``csrc/sweep.cu``, serves two wrappers:

- ``make_sweep(spec, n_sweeps, equal_betas)`` returns a function with the
  contract of ``make_pallas_sweep``'s ``raw`` (pallas_sweep.py:191):
  ``fn(states (B, nq) u8, seed int, betas (3,) or (B, 3) f32) -> states``;
- ``make_recording_sweep(spec, steps, iters_per_step, equal_betas)`` returns
  ``fn(states (B, nq) u8, seeds (steps,) int64, betas) -> (states, keys
  (B, steps, 2) int64, counts (B, steps, 3) int32)``: ``steps`` steps of
  ``iters_per_step`` sweeps, each followed by the chains' content keys
  (``ops/pauli.py::pack_key``) and X, Y and Z counts
  (``count_errors_xyz``), the whole sampling loop of
  ``decoders/counting.py::make_sampler`` (the JAX package's ``lax.scan``
  around the Pallas call, mcmc_qec_tpu/decoders/counting.py:95-107).

Both dispatch on the device of the states: a CUDA tensor launches the
kernel (built with ``nvcc`` at first use, ``ops/_build.py``) once per call,
or raises; a CPU tensor runs the plain version (``sweep_reference``,
``sample_reference``); any other device raises.  Every launch adds one to
``sweep_counts.launches``, every plain call one to ``plain_calls``.

Each sweep visits the colors of ``_color_tables(spec)`` in order; every
stabilizer of a color proposes its flip, and the flip is accepted iff
``log u < logr`` in f32, with ``logr = -(beta_x * dN)`` on the total
error-count change (``equal_betas``, the fast branch valid when the three
betas are equal) or ``logr = -((beta_x dN_x + beta_y dN_y) + beta_z dN_z)``
on the per-Pauli changes.  An infinite beta times a zero change is NaN,
which rejects, as in the TPU kernel.  The betas are one (3,) row shared by
every chain, as the TPU kernel takes them, or a (B, 3) row per chain: the
PT ladder's sweep, where each chain runs at its rung's temperature
(``mcmc/ladder.py``, ``ops/dense_sweep.py``).

Code sizes: up to 16 words per bit plane (nq <= 1024) a register
instantiation ``sweep_kernel<words, spanned words, equal betas,
recording>`` holds a chain's planes in registers; above it the large
variant ``sweep_kernel_wide<equal betas, recording>`` takes the word count
at run time and holds each chain in shared memory at 2 bits a qubit, up to
MAX_WORDS words (nq <= 16384; a qubit-table entry names a qubit in 14
bits), with its own launch (``wide_block``).  ``sweep_kernel_fits`` says
from shapes alone whether the card takes a code; above the limit the CUDA
branches raise a ``ValueError`` before any work.  The plain versions take
any size.

Randomness: the uniform of stabilizer ``j`` of color ``c`` in sweep ``t``
for chain ``b`` is ``u = (w >> 8) * 2**-24 + 1e-12`` (the compiled TPU
path's form, pallas_sweep.py:130-134), where ``w`` is word ``j % 4`` of
Philox4x32-10 (``ops/philox.py``) at counter ``(j // 4, c, t, b)`` under key
``(seed mod 2**32, seed >> 32)``.  In the recording sampler ``t`` counts
the sweeps within a step and step ``s`` takes ``seeds[s]`` as its seed, so
it draws what ``steps`` calls of ``make_sweep(spec, iters_per_step)`` with
those seeds draw.  Distinct (chain, sweep, color, stabilizer) of one seed
never share a draw.  The Pallas interpreter on the CPU instead injects
``log(jax.random.uniform(...))`` in its own layout; ``sweep_reference``
accepts such a ``logu`` of shape ``(n_sweeps, n_colors, B, W_max)`` so that
the two can be compared bit for bit (tests/test_torch_sweep.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.base import CodeSpec
from .dense_sweep import _color_tables
from .kernel_tables import (
    _DRAW_BUDGET,
    SMEM_LIMIT,
    WIDE_MAX_THREADS,
    WIDE_WARPS_PER_SM,
    WIDE_WORDS,
    KernelCounter,
    _check,
    _draw_words,
    _plain_tables,
    _sm_count,
    is_wide,
    kernel_tables,
    kernel_words,
    lanes_per_rung,
    qubit_table,
    spanned_words,
)
from .pauli import count_errors_xyz, make_hash_mults, pack_key
from .philox import MASK32

# (words per plane, spanned-word entries per stabilizer) the register
# instantiations are built for (csrc/sweep.cu::dispatch): every code up to
# KERNEL_WORDS[-1] words per plane (nq <= 1024).  A stabilizer spanning 3
# words is padded to 4 entries; rotated and XZZX codes span at most 2
# words at every size, toric and planar codes 4 from d=9 on
SWEEP_SHAPES = ((1, 1), (2, 2), (3, 2), (3, 4), (4, 2), (4, 4), (6, 2), (6, 4),
                (8, 2), (8, 4), (12, 2), (12, 4), (16, 2), (16, 4))
# most 64-bit words per bit plane the kernel takes (nq <= 16384: toric and
# planar d=89, rotated and XZZX d=127), in its large variant above
# KERNEL_WORDS[-1] (nq > 1024: toric and planar d >= 23, rotated and XZZX
# d >= 33); a code's count is ``kernel_words(nq)``
MAX_WORDS = WIDE_WORDS
# threads per block of a register instantiation (csrc/sweep.cu::
# kSweepThreads); the large variant's blocks take up to WIDE_MAX_THREADS
# (kWideThreads, ``wide_block``)
SWEEP_THREADS = 256
# recording steps a warp stages per chain before it stores them: 16 steps
# are 256 contiguous bytes of keys and 192 of counts per chain (whole
# 32-byte sectors of the stream, 28 bytes per chain and step: 826 MB at
# 65,536 chains x 450 steps)
TILE_STEPS = 16
# blocks one SM must still hold beside tables in shared memory, else a
# register instantiation reads its tables from device memory
MIN_BLOCKS_PER_SM = 4
# warps per SM a batch must still give before the plan halves the lanes per
# chain (``lanes_per_chain``)
MIN_WARPS_PER_SM = 8

# the sweep kernel's counts (every function ``make_sweep`` and
# ``make_recording_sweep`` return adds to it)
sweep_counts = KernelCounter()


def stab_width(spec: CodeSpec) -> int:
    """Most stabilizers in one color (the last axis of an injected logu)."""
    return max(sel.shape[0] for sel, _, _ in _color_tables(spec))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _beta_columns(betas, B: int, device):
    """(beta_x, beta_y, beta_z) of (3,) betas as f32 scalars, or of (B, 3)
    betas as (B, 1) columns, to broadcast over a color's (B, W) changes."""
    b = torch.as_tensor(betas, dtype=torch.float32, device=device)
    if tuple(b.shape) == (3,):
        return b.unbind()
    if tuple(b.shape) == (B, 3):
        return b.split(1, dim=1)
    raise ValueError(f"betas must have shape (3,) or ({B}, 3), got "
                     f"{tuple(b.shape)}")


def sweep_reference(spec: CodeSpec, states: torch.Tensor, seed: int, betas,
                    n_sweeps: int, equal_betas: bool = False,
                    logu: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``n_sweeps`` sweeps on the device of
    ``states`` (B, nq) u8.  Per color, every chain's stabilizers are
    evaluated at once through per-qubit lookups and the accepted flips are
    XORed in.  ``betas`` is (3,), or (B, 3) with a row per chain.  ``logu``
    (n_sweeps, n_colors, B, W_max) f32, if given, replaces the Philox
    uniforms' logarithms (parity tests only)."""
    device = states.device
    B, nq = states.shape
    T = _plain_tables(spec, device)
    n_colors = len(T.colors)
    f32 = torch.float32
    i64 = torch.int64
    bx, by, bz = _beta_columns(betas, B, device)
    k0, k1 = int(seed) & MASK32, (int(seed) >> 32) & MASK32
    n_blocks = -(-stab_width(spec) // 4)
    two_m24 = torch.tensor(2.0 ** -24, dtype=f32, device=device)
    eps = torch.tensor(1e-12, dtype=f32, device=device)
    no_hit = torch.zeros((B, 1), dtype=torch.bool, device=device)
    slot4 = [4 * torch.arange(n * deg, device=device) for *_, n, deg in T.colors]

    S = torch.zeros((B, nq + 1), dtype=i64, device=device)
    S[:, :nq] = states
    span = max(1, _DRAW_BUDGET // max(B * n_colors * n_blocks, 1))
    for t0 in range(0, n_sweeps, span):
        t1 = min(n_sweeps, t0 + span)
        if logu is None:
            bits = _draw_words(k0, k1, t0, t1, B, 0, n_colors, n_blocks, None,
                               device) >> 8  # (t1 - t0, B, n_colors, 4 * n_blocks)
            lu_all = torch.log(bits.to(f32) * two_m24 + eps)
        for t in range(t0, t1):
            for c, (op, dsupp, dsupp3, supp, owner, n, deg) in enumerate(T.colors):
                if logu is None:
                    lu = lu_all[t - t0, :, c, :n]
                else:
                    lu = logu[t, c, :, :n]
                # (B, n * deg) values, and their lookup slots
                vals = S.index_select(-1, supp) + slot4[c]
                if equal_betas:
                    dn = dsupp.take(vals).view(B, n, deg).sum(-1)
                    logr = -(bx * dn.to(f32))
                else:
                    d1, d2, d3 = dsupp3[:, vals].view(3, B, n, deg).sum(-1).to(
                        f32).unbind()
                    logr = -((bx * d1 + by * d2) + bz * d3)
                acc = lu < logr
                hit = torch.cat([acc, no_hit], -1).index_select(-1, owner)
                S = torch.where(hit, S ^ op, S)
    return S[:, :nq].to(torch.uint8)


def sample_reference(spec: CodeSpec, states: torch.Tensor, seeds, betas,
                     iters_per_step: int = 1, equal_betas: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the recording sampler on the device of
    ``states`` (B, nq) u8: per seed of ``seeds`` (steps,), ``sweep_reference``
    with ``iters_per_step`` sweeps, then the chains' ``pack_key`` and
    ``count_errors_xyz``; ``betas`` (3,) or (B, 3).  Returns (states, keys
    (B, steps, 2) int64, counts (B, steps, 3) int32)."""
    device = states.device
    seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu().tolist()
    B, steps = states.shape[0], len(seeds)
    m = torch.as_tensor(make_hash_mults(spec).astype(np.int64), device=device)
    keys = torch.empty((B, steps, 2), dtype=torch.int64, device=device)
    counts = torch.empty((B, steps, 3), dtype=torch.int32, device=device)
    for s, seed in enumerate(seeds):
        states = sweep_reference(spec, states, seed, betas, iters_per_step,
                                 equal_betas)
        keys[:, s] = pack_key(spec, states, m)
        counts[:, s] = count_errors_xyz(states)
    return states, keys, counts


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def lanes_per_chain(offs, B: int, n_sm: int) -> int:
    """Lanes that split a chain's proposals in a register instantiation
    (the large variant's come from ``wide_block``): at most the window
    kernel's rule (about one lane per Philox block, four stabilizers, of
    the widest color, a power of two up to 8: toric d=5 4, toric d >= 7 8),
    halved while the batch still gives every one of the ``n_sm`` SMs
    MIN_WARPS_PER_SM warps.  Fewer lanes issue fewer instructions (no idle
    lanes in the small colors, no butterflies); more lanes put more warps
    on a card that a small batch leaves idle."""
    L = lanes_per_rung(offs, 1)
    while L > 1 and B * (L // 2) >= 32 * n_sm * MIN_WARPS_PER_SM:
        L //= 2
    return L


class SweepPlan(NamedTuple):
    lanes: int  # lanes per chain
    chains_per_warp: int
    chains_per_block: int
    threads: int  # threads per block
    tile_steps: int  # recording steps staged per store
    region_bytes: int  # shared memory of one warp (its rows, or its tiles)
    tab_in_smem: bool  # tables in shared memory (else device memory)
    smem: int  # dynamic shared memory per block, bytes
    mults_in_smem: bool  # hash multipliers in shared memory (else device)


def tile_bytes(tile_steps: int, wide: bool = False) -> int:
    """Shared memory of one chain's staged tile: per step two 32-bit hashes
    and the counts (packed in one word, three words in the large variant),
    each run padded by one word (csrc/sweep.cu)."""
    return 4 * ((2 + (3 if wide else 1)) * tile_steps + 2)


def plane_words(spec: CodeSpec) -> int:
    """32-bit words of one chain's slot in the large variant's shared
    memory: 2 bits a qubit, 16 qubits a word (4 words per 64-bit plane word
    of X and Z), padded by one word so that the chains of a warp start in
    different banks."""
    return 4 * kernel_words(spec.nq) + 1


def sweep_smem_bytes(spec: CodeSpec, region_bytes: int, tab_in_smem: bool,
                     mults_in_smem: bool = True,
                     warps: int = SWEEP_THREADS // 32) -> int:
    """Dynamic shared memory of one block of ``warps`` warps
    (csrc/sweep.cu::SweepLayout): the table if it sits there (the
    spanned-word table, or the large variant's qubit table, 8 bytes a
    stabilizer), the hash multipliers if they do, the color starts and a
    register instantiation's spanned-word entries, then each warp's
    region, 16-byte aligned."""
    n_colors = len(spec.color_stabs)
    wide = is_wide(spec)
    tab = (8 * spec.n_stabs * (1 if wide else 3 * spanned_words(spec))
           if tab_in_smem else 0)
    head = (tab + 8 * spec.nq * int(mults_in_smem)
            + 4 * (n_colors + 1 + (0 if wide else spec.n_stabs)))
    return -(-head // 16) * 16 + region_bytes * warps


def _block_bytes(spec: CodeSpec, record: bool, lanes: int,
                 warps: int | None = None):
    """(bytes of one warp's region, tables in shared memory, multipliers in
    shared memory, dynamic shared memory of one block) at ``lanes`` lanes
    per chain and ``warps`` warps a block (``sweep_plan``; by default a
    register instantiation's SWEEP_THREADS // 32, the large variant's
    smallest block of one warp).  A register instantiation's region holds
    the warp's rows of u8 state or its tiles, and the multipliers always
    sit in shared memory; the tables go there when MIN_BLOCKS_PER_SM blocks
    still fit an SM beside them.  The large variant's region holds its
    chains' slots and tiles; the qubit table goes to shared memory when the
    block still fits with it, then, while recording, the multipliers."""
    cpw = 32 // lanes
    if is_wide(spec):
        warps = 1 if warps is None else warps
        region = cpw * 4 * plane_words(spec) + record * cpw * tile_bytes(
            TILE_STEPS, True)
        region = -(-region // 16) * 16
        smem = functools.partial(sweep_smem_bytes, spec, region, warps=warps)
        in_smem = smem(True, False) <= SMEM_LIMIT
        mults = record and smem(in_smem, True) <= SMEM_LIMIT
        return region, in_smem, mults, smem(in_smem, mults)
    region = cpw * spec.nq
    if record:
        region = max(region, cpw * tile_bytes(TILE_STEPS))
    region = -(-region // 16) * 16
    smem = functools.partial(sweep_smem_bytes, spec, region)
    in_smem = MIN_BLOCKS_PER_SM * smem(True) <= SMEM_LIMIT
    return region, in_smem, True, smem(in_smem)


def has_sweep_shape(spec: CodeSpec) -> bool:
    """Whether a register instantiation of the kernel is built for
    ``spec``: its (words per plane, spanned words per stabilizer) in
    SWEEP_SHAPES."""
    if is_wide(spec):
        return False
    return (kernel_words(spec.nq), spanned_words(spec)) in SWEEP_SHAPES


def _instantiated(spec: CodeSpec) -> bool:
    """Whether the kernel is built for ``spec``'s shape: a register
    instantiation up to 16 words per plane (``has_sweep_shape``), the large
    variant up to MAX_WORDS words."""
    if is_wide(spec):
        return -(-spec.nq // 64) <= MAX_WORDS
    return has_sweep_shape(spec)


def sweep_kernel_fits(spec: CodeSpec, record: bool) -> bool:
    """Whether the sweep kernel takes ``spec``, from shapes alone, before
    any build or launch: it is built for the code's shape, and a block of
    one chain a warp (32 lanes per chain) fits shared memory, so that
    ``sweep_plan`` finds a launch.  The CUDA branches raise a ``ValueError``
    before any work where it is False (``_require_kernel``)."""
    return (_instantiated(spec)
            and _block_bytes(spec, record, 32)[-1] <= SMEM_LIMIT)


def _refusal(spec: CodeSpec) -> ValueError:
    return ValueError(
        f"nq={spec.nq}: no launch of the sweep kernel for this code "
        f"({-(-spec.nq // 64)} words per plane, {spanned_words(spec)} spanned "
        f"words per stabilizer); the card takes codes up to {MAX_WORDS} words "
        f"per plane (nq <= {64 * MAX_WORDS}), the plain version on the CPU any "
        f"size")


def _require_kernel(spec: CodeSpec, record: bool) -> None:
    if not sweep_kernel_fits(spec, record):
        raise _refusal(spec)


@functools.lru_cache(maxsize=None)
def least_lanes(spec: CodeSpec, record: bool) -> int:
    """Fewest lanes per chain whose smallest block fits 227 KB of shared
    memory: 1 up to 841 qubits (rotated and XZZX d=29); toric and planar
    d=21 (882 qubits) and rotated and XZZX d=31 (961) take 2, as a warp's
    32 rows of u8 state would not fit at 1.  The large variant's smallest
    block is one warp, whose 32 chains fit at 1 lane each up to its limit
    (toric d=89: 32 slots of 3,972 bytes).  32 where no lane count fits
    (``sweep_kernel_fits`` is False)."""
    L = 1
    while L < 32 and _block_bytes(spec, record, L)[-1] > SMEM_LIMIT:
        L *= 2
    return L


def wide_block(spec: CodeSpec, record: bool, B: int, n_sm: int,
               lanes: int | None = None) -> Tuple[int, int]:
    """(lanes per chain, warps per block) of the large variant for ``B``
    chains on ``n_sm`` SMs, from shared memory rather than from the batch
    alone.  A chain's bytes (its slot and its share of the staged tiles)
    fix how many chains one block of up to 227 KB holds; the batch is
    spread over the SMs in whole waves of one block an SM (toric d=25 at
    40,960 chains: 128 blocks of 320 chains in one wave, not 160 blocks of
    256 in 1.2 waves).  Lanes per chain are then the most, a power of two from
    ``least_lanes`` up to 32 and below twice the widest color's Philox
    blocks, that keep the block within WIDE_WARPS_PER_SM warps (toric d=25
    at 40,960 chains: 2 lanes, 20 warps; toric d=45 at 16,384: 8 lanes, 32
    warps); ``lanes`` given fixes them instead.  The warps are what the
    block's chains take at those lanes, at most WIDE_MAX_THREADS // 32."""
    least = least_lanes(spec, record)
    chain = 4 * plane_words(spec) + record * tile_bytes(TILE_STEPS, True)
    cap = (SMEM_LIMIT - sweep_smem_bytes(spec, 0, False, False, 0)) // chain
    need = -(-max(B, 1) // n_sm)  # chains an SM runs in one wave
    chains = -(-need // -(-need // cap))  # a block's share of whole waves
    if lanes is None:
        blocks = -(-stab_width(spec) // 4)
        lanes = 32
        while lanes > least and (lanes >= 2 * blocks or -(-chains * lanes // 32)
                                 > WIDE_WARPS_PER_SM):
            lanes //= 2
    warps = max(1, min(WIDE_MAX_THREADS // 32, -(-chains * lanes // 32)))
    while warps > 1 and _block_bytes(spec, record, lanes, warps)[-1] > SMEM_LIMIT:
        warps -= 1
    return lanes, warps


def sweep_plan(spec: CodeSpec, record: bool, lanes: int,
               warps: int | None = None) -> SweepPlan:
    """The launch of the sweep kernel for ``spec`` at ``lanes`` lanes per
    chain (at least ``least_lanes``) and ``warps`` warps a block: 32 / L
    chains per warp.  A register instantiation takes SWEEP_THREADS threads
    a block (``lanes_per_chain``); its warp's shared memory holds its rows
    of u8 state (at the start and the end) and, while recording, its
    chains' tiles of TILE_STEPS steps, and its tables go to shared memory
    when MIN_BLOCKS_PER_SM blocks still fit on an SM beside them (toric d
    <= 13), else the kernel reads them from device memory.  The large
    variant takes 1 to WIDE_MAX_THREADS // 32 warps (``wide_block``; one
    by default); its warp's shared memory holds its chains' slots and
    tiles, and the qubit table and then the multipliers go to shared
    memory where the block leaves room for them."""
    L = lanes
    if L & (L - 1) or not 1 <= L <= 32:
        raise ValueError(f"lanes={L}: expected a power of two up to 32")
    if not _instantiated(spec):
        raise _refusal(spec)
    wide = is_wide(spec)
    if warps is None:
        warps = 1 if wide else SWEEP_THREADS // 32
    most = WIDE_MAX_THREADS // 32 if wide else SWEEP_THREADS // 32
    if not (1 <= warps <= most and (wide or warps == most)):
        form = "large variant takes 1 to" if wide else "register form takes"
        raise ValueError(f"warps={warps}: the {form} {most} warps a block")
    region, in_smem, mults, smem = _block_bytes(spec, record, L, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a block of the sweep kernel needs {smem} B of shared "
                         f"memory ({spec.nq} qubits, {L} lanes per chain, "
                         f"{warps} warps)")
    return SweepPlan(L, 32 // L, 32 * warps // L, 32 * warps, TILE_STEPS,
                     region, in_smem, smem, mults)


class _Params(ctypes.Structure):
    """csrc/sweep.cu::SweepParams."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "nq", "nw", "span", "n_colors", "n_stabs", "steps", "iters",
        "equal_betas", "record", "lanes", "chains_per_block", "tile_steps",
        "region_bytes", "tab_in_smem", "smem",
    )] + [(n, ctypes.c_uint32) for n in ("key0", "key1")] + [
        (n, ctypes.c_int32) for n in ("beta_stride", "mults_in_smem", "threads")]


class _Buffers(ctypes.Structure):
    """csrc/sweep.cu::SweepBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state_in", "state_out", "betas", "tab", "meta", "mults", "seeds",
        "keys", "counts", "qtab",
    )]


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built and loaded on first use."""
    from . import _build

    lib = _build.load("sweep")
    lib.mqt_sweep.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers),
                              ctypes.c_void_p]
    lib.mqt_sweep.restype = ctypes.c_int
    lib.mqt_sweep_resident_blocks.argtypes = [ctypes.POINTER(_Params)]
    lib.mqt_sweep_resident_blocks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _static_fields(spec: CodeSpec, record: bool, lanes: int, warps: int):
    """(SweepPlan, the ``_Params`` fields fixed by the code, the mode, the
    lanes and the warps), worked out once for each."""
    offs = kernel_tables(spec)[2]
    plan = sweep_plan(spec, record, lanes, warps)
    return plan, dict(
        nq=spec.nq, nw=offs["nw"], span=offs["span"], n_colors=offs["n_colors"],
        n_stabs=spec.n_stabs, record=int(record), lanes=plan.lanes,
        chains_per_block=plan.chains_per_block, tile_steps=plan.tile_steps,
        region_bytes=plan.region_bytes, tab_in_smem=int(plan.tab_in_smem),
        smem=plan.smem, mults_in_smem=int(plan.mults_in_smem),
        threads=plan.threads,
    )


def _plan_params(spec: CodeSpec, B: int, steps: int, iters: int,
                 equal_betas: bool, record: bool, n_sm: int, seed: int = 0,
                 per_chain: bool = False):
    """(SweepPlan, ``_Params``) of a launch on a card with ``n_sm`` SMs;
    ``per_chain`` betas are a (B, 3) row per chain.  A register
    instantiation takes ``lanes_per_chain`` (at least ``least_lanes``) and
    SWEEP_THREADS threads, the large variant ``wide_block``."""
    _require_kernel(spec, record)
    if is_wide(spec):
        lanes, warps = wide_block(spec, record, B, n_sm)
    else:
        lanes = max(lanes_per_chain(kernel_tables(spec)[2], B, n_sm),
                    least_lanes(spec, record))
        warps = SWEEP_THREADS // 32
    plan, fields = _static_fields(spec, record, lanes, warps)
    return plan, _Params(B=B, steps=steps, iters=iters,
                         equal_betas=int(equal_betas), key0=int(seed) & MASK32,
                         key1=(int(seed) >> 32) & MASK32,
                         beta_stride=3 if per_chain else 0, **fields)


def launch_plan(spec: CodeSpec, B: int, record: bool, equal_betas: bool,
                device="cuda"):
    """(SweepPlan, blocks of it one SM holds at once) of a launch at this
    shape on a CUDA ``device``: the occupancy calculator's answer for the
    built kernel's registers and shared memory."""
    device = torch.device(device)
    plan, P = _plan_params(spec, B, 1, 1, equal_betas, record, _sm_count(device))
    with torch.cuda.device(device):
        n = _library().mqt_sweep_resident_blocks(ctypes.byref(P))
    if n < 0:
        raise RuntimeError(f"occupancy query failed for {plan}")
    return plan, n


@functools.lru_cache(maxsize=None)
def _host_tables(spec: CodeSpec):
    """(spanned-word table (n_stabs * span * 3,) int64 or None, meta (int32),
    hash multipliers (nq, 2) int32 bit patterns, qubit table (n_stabs,)
    int64 or None) the kernel reads: a register instantiation the
    spanned-word table and a meta of color starts and spanned-word
    entries; the large variant the qubit table and the color starts."""
    tab, meta, offs = kernel_tables(spec)
    n_c, m = offs["n_colors"], offs["m_span"]
    mults = np.ascontiguousarray(make_hash_mults(spec).T).view(np.int32)
    if is_wide(spec):
        return None, meta[: n_c + 1], mults, qubit_table(spec)
    meta_k = np.concatenate([meta[: n_c + 1], meta[m: m + spec.n_stabs]])
    return tab[offs["off_span"]:], meta_k, mults, None


def _launch(spec: CodeSpec, states: torch.Tensor, betas, *, steps: int,
            iters: int, equal_betas: bool, seed: int = 0, seeds=None,
            device_tables: dict):
    """One launch: ``steps`` steps of ``iters`` sweeps, recording when
    ``seeds`` (steps,) is given, else one step under ``seed``.  Returns the
    states, and with recording also the keys and counts."""
    device = states.device
    B, nq = states.shape
    if nq != spec.nq:
        raise ValueError(f"states have {nq} qubits, spec {spec.nq}")
    record = seeds is not None
    _require_kernel(spec, record)  # a ValueError for a code the card cannot take
    _check(states, "states", (B, nq), torch.uint8, device)
    # a host array here would be a blocking copy per call: callers on the
    # hot path pass the betas as a tensor on the device
    betas_d = torch.as_tensor(betas, dtype=torch.float32, device=device)
    per_chain = betas_d.dim() == 2
    _check(betas_d, "betas", (B, 3) if per_chain else (3,), torch.float32,
           device)
    if device not in device_tables:  # uploaded once a device
        device_tables[device] = tuple(
            None if a is None else torch.as_tensor(a, device=device)
            for a in _host_tables(spec))
    tab, meta, mults, qtab = device_tables[device]
    out = torch.empty_like(states)
    keys = counts = seeds_d = None
    if record:
        seeds_d = torch.as_tensor(seeds, dtype=torch.int64).to(device)
        _check(seeds_d, "seeds", (steps,), torch.int64, device)
        keys = torch.empty((B, steps, 2), dtype=torch.int64, device=device)
        counts = torch.empty((B, steps, 3), dtype=torch.int32, device=device)
    if B == 0 or steps == 0:
        out.copy_(states)
        return (out, keys, counts) if record else out
    plan, P = _plan_params(spec, B, steps, iters, equal_betas, record,
                           _sm_count(device), seed, per_chain)
    bufs = _Buffers(*(t.data_ptr() if t is not None else None for t in (
        states, out, betas_d, tab, meta, mults, seeds_d, keys, counts,
        qtab)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mqt_sweep(ctypes.byref(P), ctypes.byref(bufs), stream)
    if err != 0:
        raise RuntimeError(
            f"sweep kernel launch failed: cudaError {err} (B={B}, nq={nq}, "
            f"steps={steps}, iters={iters}, record={record}, {plan})"
        )
    sweep_counts.add_launch(B)
    return (out, keys, counts) if record else out


def make_sweep(spec: CodeSpec, n_sweeps: int, equal_betas: bool = False):
    """Build ``fn(states (B, nq) u8, seed int, betas (3,) or (B, 3) f32)
    -> states`` running ``n_sweeps`` colored sweeps over every chain, at
    one shared row of betas or a row per chain.

    ``equal_betas=True`` asserts beta_x == beta_y == beta_z and takes the
    total-count branch (bit-identical decisions up to f32 rounding of the
    per-Pauli sum).  The device of ``states`` decides: CUDA launches the
    kernel (counted in ``sweep_counts.launches``), CPU runs
    ``sweep_reference`` (counted in ``plain_calls``); any other device
    raises."""
    device_tables = {}

    def fn(states: torch.Tensor, seed: int, betas) -> torch.Tensor:
        if states.device.type == "cuda":
            return _launch(spec, states, betas, steps=1, iters=n_sweeps,
                           equal_betas=equal_betas, seed=seed,
                           device_tables=device_tables)
        if states.device.type == "cpu":
            sweep_counts.add_plain(states.shape[0])
            return sweep_reference(spec, states, seed, betas, n_sweeps,
                                   equal_betas)
        raise ValueError(f"no sweep for device {states.device}")

    return fn


def make_recording_sweep(spec: CodeSpec, steps: int, iters_per_step: int = 1,
                         equal_betas: bool = False):
    """Build ``fn(states (B, nq) u8, seeds (steps,) int64, betas (3,) or
    (B, 3) f32) -> (states, keys (B, steps, 2) int64, counts (B, steps, 3)
    int32)``:
    step ``s`` runs ``iters_per_step`` sweeps under seed ``seeds[s]`` and
    records every chain's ``pack_key`` halves (int64 values in [0, 2**32))
    and X, Y and Z counts.  ``seeds`` may be a CPU tensor or a list (it is
    copied to the device once per call).  The device of ``states`` decides:
    CUDA makes one launch of the kernel (counted in
    ``sweep_counts.launches``), CPU runs ``sample_reference`` (counted in
    ``plain_calls``); any other device raises."""
    if steps < 0 or iters_per_step < 0:
        raise ValueError(f"steps={steps}, iters_per_step={iters_per_step}: "
                         f"expected counts >= 0")
    device_tables = {}

    def fn(states: torch.Tensor, seeds, betas):
        if len(seeds) != steps:
            raise ValueError(f"{len(seeds)} seeds for {steps} steps")
        if states.device.type == "cuda":
            return _launch(spec, states, betas, steps=steps,
                           iters=iters_per_step, equal_betas=equal_betas,
                           seeds=seeds, device_tables=device_tables)
        if states.device.type == "cpu":
            sweep_counts.add_plain(states.shape[0])
            return sample_reference(spec, states, seeds, betas,
                                    iters_per_step, equal_betas)
        raise ValueError(f"no sweep for device {states.device}")

    return fn
