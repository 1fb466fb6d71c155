"""Colored Metropolis sweeps over a batch of chains: CUDA kernel and plain
PyTorch version.

Counterpart of ``mcmc_qec_tpu/ops/pallas_sweep.py`` (the Pallas TPU kernel
K1).  ``make_sweep(spec, n_sweeps, equal_betas)`` returns a function with
the contract of ``make_pallas_sweep``'s ``raw`` (pallas_sweep.py:191):
``fn(states (B, nq) u8, seed int, betas (3,) f32) -> states``.  It
dispatches on the device of the states:

- a CUDA tensor launches ``csrc/sweep.cu`` (built with ``nvcc`` at first
  use, ``ops/_build.py``) once per call, or raises;
- a CPU tensor runs ``sweep_reference``, the plain version.

Each sweep visits the colors of ``_color_tables(spec)`` in order; every
stabilizer of a color proposes its flip, and the flip is accepted iff
``log u < logr`` in f32, with ``logr = -(beta_x * dN)`` on the total
error-count change (``equal_betas``, the fast branch valid when the three
betas are equal) or ``logr = -((beta_x dN_x + beta_y dN_y) + beta_z dN_z)``
on the per-Pauli changes.  An infinite beta times a zero change is NaN,
which rejects, as in the TPU kernel.

Randomness: the uniform of stabilizer ``j`` of color ``c`` in sweep ``t``
for chain ``b`` is ``u = (w >> 8) * 2**-24 + 1e-12`` (the compiled TPU
path's form, pallas_sweep.py:130-134), where ``w`` is word ``j % 4`` of
Philox4x32-10 (``ops/philox.py``) at counter ``(j // 4, c, t, b)`` under key
``(seed mod 2**32, seed >> 32)``.  Distinct (chain, sweep, color,
stabilizer) never share a draw.  The Pallas interpreter on the CPU instead
injects ``log(jax.random.uniform(...))`` in its own layout; the plain
version accepts such a ``logu`` of shape ``(n_sweeps, n_colors, B, W_max)``
so that the two can be compared bit for bit (tests/test_torch_sweep.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.base import CodeSpec
from .dense_sweep import _color_tables
from .ladder_window import (
    KernelCounter,
    _DRAW_BUDGET,
    _check,
    _draw_words,
    _plain_tables,
    kernel_tables,
    kernel_words,
)
from .philox import MASK32

# most 64-bit words per bit plane the kernel is built for (toric d=13:
# nq=338); a code's count is ``kernel_words(nq)``
MAX_WORDS = 6

# the sweep wrapper's counts (every function ``make_sweep`` returns adds to it)
sweep_counts = KernelCounter()


def stab_width(spec: CodeSpec) -> int:
    """Most stabilizers in one color (the last axis of an injected logu)."""
    return max(sel.shape[0] for sel, _, _ in _color_tables(spec))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def sweep_reference(spec: CodeSpec, states: torch.Tensor, seed: int, betas,
                    n_sweeps: int, equal_betas: bool = False,
                    logu: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``n_sweeps`` sweeps on the device of
    ``states`` (B, nq) u8.  Per color, every chain's stabilizers are
    evaluated at once through per-qubit lookups and the accepted flips are
    XORed in.  ``logu`` (n_sweeps, n_colors, B, W_max) f32, if given,
    replaces the Philox uniforms' logarithms (parity tests only)."""
    device = states.device
    B, nq = states.shape
    T = _plain_tables(spec, device)
    n_colors = len(T.colors)
    f32 = torch.float32
    i64 = torch.int64
    bx, by, bz = torch.as_tensor(betas, dtype=f32, device=device).reshape(3).unbind()
    k0, k1 = int(seed) & MASK32, (int(seed) >> 32) & MASK32
    n_blocks = -(-stab_width(spec) // 4)
    two_m24 = torch.tensor(2.0 ** -24, dtype=f32, device=device)
    eps = torch.tensor(1e-12, dtype=f32, device=device)
    no_hit = torch.zeros((B, 1), dtype=torch.bool, device=device)
    slot4 = [4 * torch.arange(n * deg, device=device) for *_, n, deg in T.colors]
    op_supp = [op.index_select(0, supp) for op, _, _, supp, *_ in T.colors]

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
            for c, (op, dsupp, _, supp, owner, n, deg) in enumerate(T.colors):
                if logu is None:
                    lu = lu_all[t - t0, :, c, :n]
                else:
                    lu = logu[t, c, :, :n]
                vals = S.index_select(-1, supp)  # (B, n * deg)
                if equal_betas:
                    dn = dsupp.take(vals + slot4[c]).view(B, n, deg).sum(-1)
                    logr = -(bx * dn.to(f32))
                else:
                    new = vals ^ op_supp[c]
                    d1, d2, d3 = (
                        ((new == v).to(i64) - (vals == v).to(i64))
                        .view(B, n, deg).sum(-1).to(f32)
                        for v in (1, 2, 3)
                    )
                    logr = -((bx * d1 + by * d2) + bz * d3)
                acc = lu < logr
                hit = torch.cat([acc, no_hit], -1).index_select(-1, owner)
                S = torch.where(hit, S ^ op, S)
    return S[:, :nq].to(torch.uint8)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/sweep.cu::SweepParams."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "B", "nq", "nw", "n_colors", "n_sweeps", "equal_betas", "n_tab",
    )] + [(n, ctypes.c_uint32) for n in ("key0", "key1")]


class _Buffers(ctypes.Structure):
    """csrc/sweep.cu::SweepBuffers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state_in", "state_out", "betas", "tab", "color_start",
    )]


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The kernel's C entry point, built and loaded on first use."""
    from . import _build

    fn = _build.load("sweep").mqt_sweep
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Buffers),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(spec: CodeSpec, states: torch.Tensor, seed: int, betas,
            n_sweeps: int, equal_betas: bool, device_tables: dict) -> torch.Tensor:
    device = states.device
    B, nq = states.shape
    if nq != spec.nq:
        raise ValueError(f"states have {nq} qubits, spec {spec.nq}")
    need = -(-nq // 64)
    if need > MAX_WORDS:
        raise NotImplementedError(
            f"nq={nq} needs {need} words per plane; the sweep kernel is built "
            f"for at most {MAX_WORDS} (nq <= {64 * MAX_WORDS})"
        )
    nw = kernel_words(nq)  # the word count of the shared tables
    _check(states, "states", (B, nq), torch.uint8, device)
    # a host array here would be a blocking copy per call: callers on the
    # hot path pass the betas as a tensor on the device
    betas_d = torch.as_tensor(betas, dtype=torch.float32, device=device)
    _check(betas_d, "betas", (3,), torch.float32, device)
    if device not in device_tables:
        tab_np, meta_np, offs = kernel_tables(spec)
        device_tables[device] = (
            torch.as_tensor(tab_np[: offs["off_draw"]], device=device),
            torch.as_tensor(meta_np[: offs["n_colors"] + 1], device=device),
        )
    tab, cstart = device_tables[device]
    out = torch.empty_like(states)
    if B == 0:
        return out
    P = _Params(B=B, nq=nq, nw=nw, n_colors=cstart.numel() - 1,
                n_sweeps=n_sweeps, equal_betas=int(equal_betas),
                n_tab=tab.numel(), key0=int(seed) & MASK32,
                key1=(int(seed) >> 32) & MASK32)
    bufs = _Buffers(*(t.data_ptr() for t in (states, out, betas_d, tab, cstart)))
    entry = _kernel_entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(ctypes.byref(P), ctypes.byref(bufs), stream)
    if err != 0:
        raise RuntimeError(
            f"sweep kernel launch failed: cudaError {err} (B={B}, nq={nq}, "
            f"n_sweeps={n_sweeps})"
        )
    sweep_counts.launches += 1
    return out


def make_sweep(spec: CodeSpec, n_sweeps: int, equal_betas: bool = False):
    """Build ``fn(states (B, nq) u8, seed int, betas (3,) f32) -> states``
    running ``n_sweeps`` colored sweeps over every chain.

    ``equal_betas=True`` asserts beta_x == beta_y == beta_z and takes the
    total-count branch (bit-identical decisions up to f32 rounding of the
    per-Pauli sum).  The device of ``states`` decides: CUDA launches the
    kernel (counted in ``sweep_counts.launches``), CPU runs
    ``sweep_reference`` (counted in ``plain_calls``); any other device
    raises."""
    device_tables = {}

    def fn(states: torch.Tensor, seed: int, betas) -> torch.Tensor:
        if states.device.type == "cuda":
            return _launch(spec, states, seed, betas, n_sweeps, equal_betas,
                           device_tables)
        if states.device.type == "cpu":
            sweep_counts.plain_calls += 1
            return sweep_reference(spec, states, seed, betas, n_sweeps,
                                   equal_betas)
        raise ValueError(f"no sweep for device {states.device}")

    return fn
