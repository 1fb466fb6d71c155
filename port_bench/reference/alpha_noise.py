"""Biased noise and its alpha equivalent, stated again for the plain reference.

Biased noise (p, eta) puts Z on a qubit with probability ``pz = p eta /
(eta + 1)`` and X and Y with ``px = py = p / (2 (eta + 1))`` each, so that
``pz / (px + py) = eta``.  The alpha model weighs an error by ``pz~^n_eff``
with ``n_eff = n_z + alpha (n_x + n_y)``; relative to a qubit left alone
(probability ``1 - p``) that is ``pz~ = pz / (1 - p)`` and ``pz~^alpha = px
/ (1 - p)``, which gives the upstream project's alpha equivalent
(``src/generate_data.py:147-148``).

Its ladder (``src/mcmc_alpha.py:94-98``) runs pz~ evenly from the bottom
rung's value up to 1; a rung at pz~ weighs an error by ``exp(-beta_x n_x -
beta_y n_y - beta_z n_z)`` with ``beta_z = -ln pz~`` and ``beta_x = beta_y
= alpha beta_z``, so the top rung (pz~ = 1) is free.  The energy a rung
reports is ``n_eff``: weights (alpha, alpha, 1) on (n_x, n_y, n_z).
"""

from __future__ import annotations

import math

import numpy as np


def xyz_probs(p: float, eta: float) -> tuple:
    """(px, py, pz) of biased noise (p, eta)."""
    px = p / (2.0 * (eta + 1.0))
    return px, px, p * eta / (eta + 1.0)


def alpha_equivalent(p: float, eta: float) -> tuple:
    """(pz~, alpha) of biased noise (p, eta)."""
    px, _, pz = xyz_probs(p, eta)
    pz_tilde = pz / (1.0 - p)
    return pz_tilde, math.log(px / (1.0 - p)) / math.log(pz_tilde)


def ladder(pz_tilde: float, alpha: float, Nc: int) -> np.ndarray:
    """(Nc, 3) float32 betas on (X, Y, Z), bottom rung first."""
    bz = -np.log(np.linspace(pz_tilde, 1.0, Nc))
    return np.stack([alpha * bz, alpha * bz, bz], -1).astype(np.float32)


def weights(alpha: float) -> np.ndarray:
    """The energy weights on (n_x, n_y, n_z), float32."""
    return np.array([alpha, alpha, 1.0], np.float32)
