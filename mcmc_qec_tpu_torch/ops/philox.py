"""Philox4x32-10 counter-based generator as plain torch int64 ops.

Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11); the
constants and round structure follow Random123's ``philox4x32_R``.  The
same function is ``philox4x32_10`` in ``csrc/philox.cuh``, so each CUDA
kernel and its plain PyTorch version draw identical bits.

Every word is held in an int64 tensor and masked to 32 bits.  The 32x32-bit
products are formed from 16-bit halves of the multiplier so no
intermediate exceeds 2**49 (no signed overflow on any device).
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * m, a in [0, 2**32)."""
    t_lo = a * (m & 0xFFFF)  # < 2**48
    t = a * (m >> 16) + (t_lo >> 16)  # < 2**49
    hi = t >> 16
    lo = ((t & 0xFFFF) << 16) | (t_lo & 0xFFFF)
    return hi, lo


def philox4x32(
    c0: torch.Tensor,
    c1: torch.Tensor,
    c2: torch.Tensor,
    c3: torch.Tensor,
    k0: int,
    k1: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1).

    The counter words are int64 tensors of broadcastable shapes with values
    in [0, 2**32); the key is two Python ints.  Returns the four output
    words as int64 tensors in [0, 2**32)."""
    k0 &= MASK32
    k1 &= MASK32
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
