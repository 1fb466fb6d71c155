"""K2, one PT window (``csrc/ladder_window.cu``): the least time of a
launch at its shape.

Work: every proposal of every sweep on every rung (``counts``), and per
syndrome and step the Philox blocks of the top-rung gates, logical draws
and exchange (and of the Metropolis mix when the top betas are not zero),
each use ``ceil(max(iters, 3 * iters * draws, Nc - 1, 1) / 4)`` blocks.
Bytes: the ladder state, flags, tops0, class counts and since_burn read
and written, the chunk energies, burn flags, first burned steps and swap
counts written, the betas read.
"""

from __future__ import annotations

from typing import Tuple

from ..reference.codes import Code
from . import counts, peaks


def work(code: Code, B: int, Nc: int, W: int, iters: int, C: int,
         equal_betas: bool, top_exact: bool) -> Tuple[int, int, int]:
    """(bytes, 32-bit popcounts, Philox blocks) of one window launch."""
    n_extra = max(iters, 3 * iters * len(code.draws), Nc - 1, 1)
    xblocks = -(-n_extra // 4)
    uses = 3 if top_exact else 4
    blocks = (B * Nc * W * iters * counts.philox_blocks_per_sweep(code)
              + B * W * uses * xblocks)
    popc = B * Nc * W * iters * counts.popc_per_sweep(code, equal_betas)
    K = code.n_classes
    state = B * Nc * code.nq + 4 * (B * Nc + B + B * K + B)
    written = 4 * (W // C) * B + B + 4 * B + 4 * B * (Nc - 1)
    return 2 * state + written + 4 * Nc * 3, popc, blocks


def bound_ms(code: Code, shape, *, n_sm: int, clock_hz: float) -> float:
    """Least ms of a launch of ``shape`` = (B, Nc, W, iters, C,
    equal_betas, top_exact)."""
    n_bytes, popc, blocks = work(code, *shape)
    return peaks.bound_ms(n_bytes, popc, blocks, n_sm=n_sm,
                          clock_hz=clock_hz)[0]
