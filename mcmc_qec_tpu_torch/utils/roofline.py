"""The least time an NVIDIA H100 could take for the work of the port's
kernels: the bound ``chip_smoke.py`` prints beside each kernel's time.

Counterpart of ``mcmc_qec_tpu/utils/roofline.py``, which counts the TPU
sweep kernel's matrix-unit FLOPs.  The port's kernels do no matrix
products, so this module counts what bounds them on the card instead: the
bytes a launch must move, its 32-bit popcounts, its Philox blocks and its
other 32-bit multiplies.  The counts are read from the code and the
kernels' own tables (``ops/kernel_tables.py::kernel_tables``), so a bound
counts the work of every code size.  ``bound_ms`` turns them into milliseconds
at the rates below and the SM count and clock of the card, which the
caller reads from the card.

Rates: the H100 SXM's HBM3 rate (NVIDIA's data sheet); per-SM issue rates
per clock for compute capability 9.0 (CUDA C++ Programming Guide,
throughput of native arithmetic instructions): population count 16, 32-bit
integer multiply 64.  Philox4x32-10 is 10 rounds of two mul.hi and two
mul.lo (40 IMAD) per block of four draws.  The precise logf of a proposal
that may be rejected depends on the data and is not counted, so the bound
is a lower bound.  A proposal's change of energy needs only its
stabilizer's own qubits, two bits each: the fewest 32-bit popcounts that
give it are two with equal betas (the errors on the support before and
after) and four with general betas (the overlaps of the op's X and Z parts
with the state, and the Y count before and after), on one 32-bit word for
a support of up to 16 qubits (``popc_per_sweep``).  Both forms of both
kernels are held to that count, whatever they issue: the register forms
popcount 64-bit words of the planes, two POPC each.  The recording
sampler's keys and counts can be kept up to date flip by flip (pack_key
is a wraparound sum and the counts are integers, as K1's large variant
keeps them), so the fewest the function needs is one pass over the
qubits a launch: three 64-bit popcounts per word of the plane for the
counts and two multiplies per qubit for the hash, per chain.  The
updates per accepted flip depend on the data and, like the logf, are not
counted; both forms of K1 are held to that count (``sampler_work``).
"""

from __future__ import annotations

from typing import Tuple

from ..models.base import CodeSpec
from ..ops.kernel_tables import kernel_tables, kernel_words

HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLK_SM = 16
IMAD_PER_CLK_SM = 64
POPC_PER_64BIT = 2
IMAD_PER_PHILOX = 40


def bound_ms(n_bytes: float, popc: float, philox_blocks: float,
             imad: float = 0.0, *, n_sm: int, clock_hz: float
             ) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") for work that moves ``n_bytes``
    and issues ``popc`` 32-bit popcounts, ``philox_blocks`` Philox blocks
    and ``imad`` other 32-bit multiplies, on a card of ``n_sm`` SMs at
    ``clock_hz``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(popc / (POPC_PER_CLK_SM * n_sm * clock_hz),
                (philox_blocks * IMAD_PER_PHILOX + imad)
                / (IMAD_PER_CLK_SM * n_sm * clock_hz))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def philox_blocks_per_sweep(spec: CodeSpec) -> int:
    """Philox blocks one chain draws in one sweep: one per four stabilizers
    of each color (the tables' ``n_blk``)."""
    return kernel_tables(spec)[2]["n_blk"]


def popc_per_sweep(spec: CodeSpec, equal_betas: bool) -> int:
    """The fewest 32-bit popcounts a sweep of one chain needs: per
    stabilizer, two with equal betas (the error count on its support before
    and after) and four with general betas (the overlaps of the op's X and
    Z parts with the state, and the Y count before and after), each on the
    32-bit words that hold its support's qubits at two bits a qubit."""
    words = -(-2 * (spec.stab_ops != 0).sum(axis=1) // 32)
    return (2 if equal_betas else 4) * int(words.sum())


def sampler_work(spec: CodeSpec, R: int, steps: int, iters: int,
                 equal_betas: bool) -> Tuple[int, int, int]:
    """(32-bit popcounts, Philox blocks, other 32-bit multiplies) of the
    recording sampler over ``R`` chains and ``steps`` steps of ``iters``
    sweeps: the sweeps' popcounts and blocks, and once per chain and
    launch three 64-bit popcounts per word of the plane for the counts and
    two multiplies per qubit for the hash (the records after that follow
    the accepted flips, which are not counted)."""
    nw = kernel_words(spec.nq)
    popc = R * (steps * iters * popc_per_sweep(spec, equal_betas)
                + 3 * POPC_PER_64BIT * nw)
    blocks = R * steps * iters * philox_blocks_per_sweep(spec)
    return popc, blocks, R * 2 * spec.nq


def sampler_bound(spec: CodeSpec, R: int, steps: int, iters: int,
                  equal_betas: bool, n_bytes: float, *, n_sm: int,
                  clock_hz: float) -> Tuple[float, str]:
    """``bound_ms`` of the recording sampler: the bytes moved (states in
    and out, seeds, the stream written) and ``sampler_work``."""
    popc, blocks, imad = sampler_work(spec, R, steps, iters, equal_betas)
    return bound_ms(n_bytes, popc, blocks, imad, n_sm=n_sm, clock_hz=clock_hz)
