"""The error draws of the studies.

The JAX scripts derive each batch's key from ``fold_in(PRNGKey(key),
round(p * 1e5))``; threefry draws cannot be reproduced here, so each batch
is drawn from a ``torch.Generator`` on the run's device seeded by
``batch_seed(key, p)``.  The map is injective on the studies' range
(``round(p * 1e5) < 1_000_003``): batches at different (key, p) never share
a seed, so the points of a grid stay independent along p and along d, as
the bootstrap of the fit assumes."""

from __future__ import annotations

import torch

P_SCALE = 100_000
KEY_STRIDE = 1_000_003


def batch_seed(key: int, p: float) -> int:
    """``key * 1_000_003 + round(p * 1e5)``."""
    fold = int(round(p * P_SCALE))
    if not 0 <= fold < KEY_STRIDE:
        raise ValueError(f"p={p} is outside [0, {KEY_STRIDE / P_SCALE})")
    return int(key) * KEY_STRIDE + fold


def batch_generator(device: torch.device, key: int, p: float) -> torch.Generator:
    """The generator on ``device`` of the batch at (key, p)."""
    return torch.Generator(device=device).manual_seed(batch_seed(key, p))
