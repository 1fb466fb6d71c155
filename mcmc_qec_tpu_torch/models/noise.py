"""Error-model samplers and parameter conversions.

Torch counterpart of ``mcmc_qec_tpu/models/noise.py``: the samplers draw
from an explicit ``torch.Generator`` (the JAX module uses counter-based
``jax.random`` keys; the two give different numbers from one seed, so
tests that compare the packages make their inputs with numpy).  The
parameter converters are pure numpy and carried over unchanged.

- depolarizing(p): error w.p. p, uniform X/Y/Z (toric_model.py:15-24;
  equivalent to xyz(p/3, p/3, p/3), cf. generate_data.py:65).
- xyz(px, py, pz): thresholds r<pz -> Z, <pz+px -> X, <pz+px+py -> Y
  (planar_model.py:18-31, rotated_surface_model.py:25-38).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import CodeSpec


def xyz_probs_from_biased(p_error: float, eta: float) -> Tuple[float, float, float]:
    pz = p_error * eta / (eta + 1.0)
    px = p_error / (2.0 * (eta + 1.0))
    return px, px, pz


def alpha_tilde_from_p(p_error: float, alpha: float) -> float:
    """Solve pz_tilde + 2*pz_tilde**alpha = p_tilde for pz_tilde
    (planar_model.py:82 uses scipy fsolve; we use bisection)."""
    p_tilde = p_error / (1.0 + p_error) if p_error < 1 else 1.0
    lo, hi = 0.0, 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid + 2.0 * mid**alpha < p_tilde:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def xyz_probs_from_alpha(pz_tilde: float, alpha: float) -> Tuple[float, float, float]:
    p_tilde = pz_tilde + 2.0 * pz_tilde**alpha
    p = p_tilde / (1.0 + p_tilde)
    pz = pz_tilde * (1.0 - p)
    px = pz_tilde**alpha * (1.0 - p)
    return px, px, pz


def biased_alpha_equivalent(p_error: float, eta: float) -> Tuple[float, float]:
    """(pz_tilde, alpha) equivalent of biased(p, eta) (generate_data.py:147-148)."""
    pz_tilde = (p_error / (1.0 + 1.0 / eta)) / (1.0 - p_error)
    alpha = np.log(pz_tilde / (2.0 * eta)) / np.log(pz_tilde)
    return pz_tilde, alpha


def sample_xyz(
    generator: torch.Generator,
    spec: CodeSpec,
    p_x: float,
    p_y: float,
    p_z: float,
    batch: Tuple[int, ...] = (),
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Sample flat uint8 error states (batch + (nq,)) with independent
    per-qubit X/Y/Z probabilities, zeroing invalid cells
    (planar_model.py:39-40).  ``generator`` must live on ``device``."""
    shape = tuple(batch) + (spec.nq,)
    r = torch.rand(shape, generator=generator, device=device)
    q = torch.zeros(shape, dtype=torch.uint8, device=device)
    q[r < p_z + p_x + p_y] = 2
    q[r < p_z + p_x] = 1
    q[r < p_z] = 3
    valid = torch.as_tensor(spec.valid_mask, device=device)
    return q * valid


def sample_depolarizing(
    generator: torch.Generator,
    spec: CodeSpec,
    p_error: float,
    batch: Tuple[int, ...] = (),
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    p3 = p_error / 3.0
    return sample_xyz(generator, spec, p3, p3, p3, batch, device)

