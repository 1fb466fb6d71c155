"""Inputs under biased noise, drawn from ``--seed`` on the card.

A batch is ``B`` errors on the code's ``nq`` qubits, each qubit Z with
probability ``pz``, X with ``px`` and Y with ``py``, in the upstream
project's order of thresholds (a uniform below ``pz`` is Z, below ``pz +
px`` X, below ``pz + px + py`` Y); biased noise (p, eta) is ``px = py = p /
(2 (eta + 1))``, ``pz = p eta / (eta + 1)``.  Each decode starts from the
error times a uniformly random logical, drawn as ``inputs.draw_pool``
draws it: that pool at p = 0 is the random logicals alone, and the errors
come from the same seed's uniforms, which the pool at p = 0 leaves unused.
"""

from __future__ import annotations

import torch

from . import inputs
from .reference.codes import Code


def draw_pool(code: Code, probs, n_batches: int, B: int, seed: int,
              device) -> tuple:
    """(errors, starts): (n_batches, B, nq) uint8 each, on ``device``;
    ``probs`` is (px, py, pz)."""
    px, py, pz = probs
    gen = torch.Generator(device=device).manual_seed(int(seed))
    r = torch.rand((n_batches, B, code.nq), generator=gen, device=device)
    err = torch.zeros((n_batches, B, code.nq), dtype=torch.uint8,
                      device=device)
    err[r < pz + px + py] = 2
    err[r < pz + px] = 1
    err[r < pz] = 3
    _, logicals = inputs.draw_pool(code, 0.0, n_batches, B, seed, device)
    return err, err ^ logicals
