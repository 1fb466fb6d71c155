"""Exact maximum-likelihood decoding by full sector enumeration (small d).

Counterpart of ``mcmc_qec_tpu/decoders/exact.py`` (numpy and scipy, copied
so that the port imports nothing of the JAX package).  For lattices whose
stabilizer group is small enough to enumerate (rank r such that 2^r states
fit in memory — d <= 3 toric, d <= 4 planar), the true per-class posterior
is the Boltzmann sum over each class's full orbit: the ground truth the
MCMC decoders are checked against (tests/test_torch_pteq_biased.py,
chip_smoke.py).
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.special import logsumexp

from ..models.base import CodeSpec, np_to_class


@functools.lru_cache(maxsize=None)
def _independent_generators(spec: CodeSpec):
    """GF(2)-independent stabilizer masks (incremental elimination over the
    symplectic bit representation)."""
    masks = spec.stab_masks
    b0 = ((masks & 1) ^ ((masks >> 1) & 1)).astype(np.uint8)
    b1 = ((masks >> 1) & 1).astype(np.uint8)
    rows = np.concatenate([b0, b1], axis=1)
    gens = []
    basis = []  # (pivot, reduced_row, reduced_mask)
    for i in range(rows.shape[0]):
        r = rows[i].copy()
        m = masks[i].copy()
        for pivot, br, bm in basis:
            if r[pivot]:
                r = r ^ br
                m = m ^ bm
        if r.any():
            basis.append((int(np.argmax(r)), r, m))
            gens.append(m)
    return gens


def orbit(spec: CodeSpec, state: np.ndarray) -> np.ndarray:
    """All states in the stabilizer orbit of ``state``: (2^r, nq) uint8."""
    gens = _independent_generators(spec)
    if len(gens) > 26:
        raise ValueError(
            f"stabilizer rank {len(gens)} too large for exact enumeration"
        )
    out = state[None, :].copy()
    for g in gens:
        out = np.concatenate([out, out ^ g], axis=0)
    return out


def exact_mld(
    spec: CodeSpec,
    states: np.ndarray,  # (B, nq) uint8
    betas: np.ndarray,  # (3,) per-Pauli weights beta_i = -ln(p_i/(1-p))
) -> np.ndarray:
    """Exact per-class posterior (B, n_classes), rows summing to 1."""
    states = np.asarray(states).reshape(-1, spec.nq)
    betas = np.asarray(betas, dtype=np.float64)
    out = np.zeros((len(states), spec.n_classes))
    for b, s in enumerate(states):
        logZ = np.empty(spec.n_classes)
        for eq in range(spec.n_classes):
            orb = orbit(spec, np_to_class(spec, s, eq))
            nx = (orb == 1).sum(-1)
            ny = (orb == 2).sum(-1)
            nz = (orb == 3).sum(-1)
            logZ[eq] = logsumexp(-(betas[0] * nx + betas[1] * ny + betas[2] * nz))
        w = np.exp(logZ - logZ.max())
        out[b] = w / w.sum()
    return out
