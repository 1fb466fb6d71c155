"""Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32_R``) in
plain torch int64 arithmetic, with the key as a tensor so that rows drawn
under different keys go through one call.

Every word is held in an int64 in [0, 2**32); the 32 x 32-bit products are
formed from 16-bit halves of the multiplier, so nothing exceeds 2**49.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    lo16 = a * (m & 0xFFFF)
    t = a * (m >> 16) + (lo16 >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox(c0, c1, c2, c3, k0, k1):
    """The four output words of counter (c0, c1, c2, c3) under key (k0, k1);
    all six broadcast together (ints or int64 tensors)."""
    for i in range(10):
        if i:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(keys: torch.Tensor, rows: torch.Tensor, steps: torch.Tensor,
          use0: int, n_uses: int, n_blocks: int) -> torch.Tensor:
    """(len(steps), R, n_uses, 4 * n_blocks) int64 words: element e of use u
    at step t for row r is word e % 4 of the block at counter (e // 4, u, t,
    rows[r]) under key (keys[r] mod 2**32, keys[r] >> 32)."""
    dev = keys.device
    c0 = torch.arange(n_blocks, dtype=torch.int64, device=dev).view(1, 1, 1, -1)
    c1 = torch.arange(use0, use0 + n_uses, dtype=torch.int64,
                      device=dev).view(1, 1, -1, 1)
    c2 = steps.to(torch.int64).view(-1, 1, 1, 1)
    c3 = rows.to(torch.int64).view(1, -1, 1, 1)
    k0 = (keys & MASK32).view(1, -1, 1, 1)
    k1 = ((keys >> 32) & MASK32).view(1, -1, 1, 1)
    out = torch.stack(philox(c0, c1, c2, c3, k0, k1), -1)
    return out.reshape(len(steps), len(rows), n_uses, 4 * n_blocks)
