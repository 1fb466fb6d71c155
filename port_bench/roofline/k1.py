"""K1, the recording sampler (``csrc/sweep.cu``): the least time of a
launch of ``R`` chains over ``steps`` steps of ``iters`` sweeps.

Work: the sweeps' popcounts and Philox blocks (``counts``), and once per
chain and launch three 64-bit popcounts per word of the plane for the X, Y
and Z counts and two multiplies per qubit for the content key; the updates
of the record per accepted flip depend on the data and are not counted.
Bytes: the states read and written, the step seeds read, and every step's
keys (two int64) and counts (three int32) written.
"""

from __future__ import annotations

from typing import Tuple

from ..reference.codes import Code
from . import counts, peaks


def work(code: Code, R: int, steps: int, iters: int,
         equal_betas: bool) -> Tuple[int, int, int, int]:
    """(bytes, 32-bit popcounts, Philox blocks, other multiplies)."""
    nw = counts.plane_words(code.nq)
    popc = R * (steps * iters * counts.popc_per_sweep(code, equal_betas)
                + 3 * peaks.POPC_PER_64BIT * nw)
    blocks = R * steps * iters * counts.philox_blocks_per_sweep(code)
    n_bytes = 2 * R * code.nq + 8 * steps + R * steps * (16 + 12)
    return n_bytes, popc, blocks, R * 2 * code.nq


def bound_ms(code: Code, shape, *, n_sm: int, clock_hz: float) -> float:
    """Least ms of a launch of ``shape`` = (R, steps, iters,
    equal_betas)."""
    n_bytes, popc, blocks, imad = work(code, *shape)
    return peaks.bound_ms(n_bytes, popc, blocks, imad, n_sm=n_sm,
                          clock_hz=clock_hz)[0]
