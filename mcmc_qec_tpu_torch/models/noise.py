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

The samplers' tensors live on their generator's device unless ``device``
names it (the JAX samplers run on the default device).
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
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Sample flat uint8 error states (batch + (nq,)) with independent
    per-qubit X/Y/Z probabilities, zeroing invalid cells
    (planar_model.py:39-40).  The states live on ``device``, by default
    the generator's; an explicit ``device`` must be the generator's."""
    device = generator.device if device is None else device
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
    device: torch.device | str | None = None,
) -> torch.Tensor:
    p3 = p_error / 3.0
    return sample_xyz(generator, spec, p3, p3, p3, batch, device)


def known_error(spec: CodeSpec) -> np.ndarray:
    """Fixed deterministic error injection — the reference's
    regression-reproduction hook (``generate_known_error``,
    rotated_surface_model.py:79-82: X at (2,2) and (1,0);
    xzzx_model.py:31-34: X at (0,1) and (1,1)).  Returns a flat (nq,) state.
    """
    if spec.family not in ("rotated", "xzzx"):
        raise ValueError(
            "known_error exists only for rotated/xzzx codes "
            "(as in the reference)"
        )
    pos = {"rotated": [(2, 2), (1, 0)], "xzzx": [(0, 1), (1, 1)]}[spec.family]
    state = np.zeros(spec.state_shape, dtype=np.uint8)
    for r, c in pos:
        state[r, c] = 1
    return state.reshape(-1)


def sample_n_random_errors(generator: torch.Generator, spec: CodeSpec,
                           n: int) -> torch.Tensor:
    """Exactly n errors with uniform Pauli at random positions
    (toric_model.py:26-32), on the generator's device; positions are drawn
    from *valid* cells only so planar's unused cells never eat part of the
    budget."""
    device = generator.device
    valid_idx = torch.as_tensor(np.flatnonzero(spec.valid_mask),
                                device=device)
    perm = torch.randperm(valid_idx.shape[0], generator=generator,
                          device=device)
    chosen = valid_idx[perm[:n]]
    paulis = torch.randint(1, 4, (spec.nq,), generator=generator,
                           device=device).to(torch.uint8)
    sel = torch.zeros((spec.nq,), dtype=torch.uint8, device=device)
    sel[chosen] = 1
    return sel * paulis

