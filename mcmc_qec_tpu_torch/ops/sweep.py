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
from .ladder_window import (
    KERNEL_SHAPES,
    SMEM_LIMIT,
    KernelCounter,
    _DRAW_BUDGET,
    _check,
    _draw_words,
    _plain_tables,
    _sm_count,
    kernel_tables,
    lanes_per_rung,
)
from .pauli import count_errors_xyz, make_hash_mults, pack_key
from .philox import MASK32

# most 64-bit words per bit plane the kernel is built for (toric d=19:
# nq=722); a code's count is ``kernel_words(nq)``
MAX_WORDS = 12
# threads per block of the kernel (csrc/sweep.cu::kSweepThreads)
SWEEP_THREADS = 256
# recording steps a warp stages per chain before it stores them: 16 steps
# are 256 contiguous bytes of keys and 192 of counts per chain (whole
# 32-byte sectors of the stream, 28 bytes per chain and step: 826 MB at
# 65,536 chains x 450 steps)
TILE_STEPS = 16
# blocks one SM must still hold beside tables in shared memory, else the
# kernel reads its tables from device memory
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
    """Lanes that split a chain's proposals: at most the window kernel's
    rule (about one lane per Philox block, four stabilizers, of the widest
    color, a power of two up to 8: toric d=5 4, toric d >= 7 8), halved
    while the batch still gives every one of the ``n_sm`` SMs
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
    tile_steps: int  # recording steps staged per store
    region_bytes: int  # shared memory of one warp (its rows, or its tiles)
    tab_in_smem: bool  # tables in shared memory (else device memory)
    smem: int  # dynamic shared memory per block, bytes


def tile_bytes(tile_steps: int) -> int:
    """Shared memory of one chain's staged tile: per step two 32-bit hashes
    and the packed counts, each run padded by one word
    (csrc/sweep.cu::sweep_kernel)."""
    return 4 * (3 * tile_steps + 2)


def sweep_smem_bytes(spec: CodeSpec, region_bytes: int, tab_in_smem: bool) -> int:
    """Dynamic shared memory of one block (csrc/sweep.cu::SweepLayout): the
    spanned-word table if it sits there, the hash multipliers, the color
    starts and packed spans, then each warp's region, 16-byte aligned."""
    offs = kernel_tables(spec)[2]
    tab = 8 * spec.n_stabs * 3 * offs["span"] if tab_in_smem else 0
    head = tab + 8 * spec.nq + 4 * (offs["n_colors"] + 1 + spec.n_stabs)
    return -(-head // 16) * 16 + region_bytes * (SWEEP_THREADS // 32)


def sweep_plan(spec: CodeSpec, record: bool, lanes: int) -> SweepPlan:
    """The launch of the sweep kernel for ``spec`` at ``lanes`` lanes per
    chain (``lanes_per_chain``): 32 / L chains per warp, SWEEP_THREADS
    threads per block; a warp's shared memory holds its rows of u8 state
    (at the start and the end) and, while recording, its chains' tiles of
    TILE_STEPS steps.  The tables go to shared memory when
    MIN_BLOCKS_PER_SM blocks still fit on an SM beside them (toric d <=
    13), else the kernel reads them from device memory."""
    L = lanes
    if L & (L - 1) or not 1 <= L <= 32:
        raise ValueError(f"lanes={L}: expected a power of two up to 32")
    cpw = 32 // L
    region = cpw * spec.nq
    if record:
        region = max(region, cpw * tile_bytes(TILE_STEPS))
    region = -(-region // 16) * 16
    in_smem = MIN_BLOCKS_PER_SM * sweep_smem_bytes(spec, region, True) <= SMEM_LIMIT
    smem = sweep_smem_bytes(spec, region, in_smem)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a block of the sweep kernel needs {smem} B of shared "
                         f"memory ({spec.nq} qubits, {L} lanes per chain)")
    return SweepPlan(L, cpw, SWEEP_THREADS // L, TILE_STEPS, region, in_smem, smem)


class _Params(ctypes.Structure):
    """csrc/sweep.cu::SweepParams."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "nq", "nw", "span", "n_colors", "n_stabs", "steps", "iters",
        "equal_betas", "record", "lanes", "chains_per_block", "tile_steps",
        "region_bytes", "tab_in_smem", "smem",
    )] + [(n, ctypes.c_uint32) for n in ("key0", "key1")] + [
        ("beta_stride", ctypes.c_int32)]


class _Buffers(ctypes.Structure):
    """csrc/sweep.cu::SweepBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state_in", "state_out", "betas", "tab", "meta", "mults", "seeds",
        "keys", "counts",
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


def _check_words(spec: CodeSpec) -> None:
    need = -(-spec.nq // 64)
    if need > MAX_WORDS:
        raise NotImplementedError(
            f"nq={spec.nq} needs {need} words per plane; the sweep kernel is "
            f"built for at most {MAX_WORDS} (nq <= {64 * MAX_WORDS})"
        )


@functools.lru_cache(maxsize=None)
def _static_fields(spec: CodeSpec, record: bool, lanes: int):
    """(SweepPlan, the ``_Params`` fields fixed by the code, the mode and
    the lanes), worked out once for each."""
    offs = kernel_tables(spec)[2]
    if (offs["nw"], offs["span"]) not in KERNEL_SHAPES:
        raise ValueError(f"no sweep kernel for {offs['nw']} words per plane "
                         f"and {offs['span']} spanned words per stabilizer")
    plan = sweep_plan(spec, record, lanes)
    return plan, dict(
        nq=spec.nq, nw=offs["nw"], span=offs["span"], n_colors=offs["n_colors"],
        n_stabs=spec.n_stabs, record=int(record), lanes=plan.lanes,
        chains_per_block=plan.chains_per_block, tile_steps=plan.tile_steps,
        region_bytes=plan.region_bytes, tab_in_smem=int(plan.tab_in_smem),
        smem=plan.smem,
    )


def _plan_params(spec: CodeSpec, B: int, steps: int, iters: int,
                 equal_betas: bool, record: bool, n_sm: int, seed: int = 0,
                 per_chain: bool = False):
    """(SweepPlan, ``_Params``) of a launch on a card with ``n_sm`` SMs;
    ``per_chain`` betas are a (B, 3) row per chain."""
    _check_words(spec)
    lanes = lanes_per_chain(kernel_tables(spec)[2], B, n_sm)
    plan, fields = _static_fields(spec, record, lanes)
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
    """(spanned-word table (n_stabs * span * 3,) int64, meta: color starts
    then packed spans (int32), hash multipliers (nq, 2) int32 bit
    patterns) the kernel reads."""
    tab, meta, offs = kernel_tables(spec)
    n_c, m = offs["n_colors"], offs["m_span"]
    meta_k = np.concatenate([meta[: n_c + 1], meta[m: m + spec.n_stabs]])
    mults = np.ascontiguousarray(make_hash_mults(spec).T).view(np.int32)
    return tab[offs["off_span"]:], meta_k, mults


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
    _check_words(spec)
    _check(states, "states", (B, nq), torch.uint8, device)
    # a host array here would be a blocking copy per call: callers on the
    # hot path pass the betas as a tensor on the device
    betas_d = torch.as_tensor(betas, dtype=torch.float32, device=device)
    per_chain = betas_d.dim() == 2
    _check(betas_d, "betas", (B, 3) if per_chain else (3,), torch.float32,
           device)
    if device not in device_tables:
        device_tables[device] = tuple(
            torch.as_tensor(a, device=device) for a in _host_tables(spec))
    tab, meta, mults = device_tables[device]
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
        states, out, betas_d, tab, meta, mults, seeds_d, keys, counts)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mqt_sweep(ctypes.byref(P), ctypes.byref(bufs), stream)
    if err != 0:
        raise RuntimeError(
            f"sweep kernel launch failed: cudaError {err} (B={B}, nq={nq}, "
            f"steps={steps}, iters={iters}, record={record}, {plan})"
        )
    sweep_counts.launches += 1
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
            sweep_counts.plain_calls += 1
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
            sweep_counts.plain_calls += 1
            return sample_reference(spec, states, seeds, betas,
                                    iters_per_step, equal_betas)
        raise ValueError(f"no sweep for device {states.device}")

    return fn
