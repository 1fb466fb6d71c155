"""The benchmark's inputs, drawn from ``--seed`` on the card, and their true
classes.

A batch is ``B`` depolarizing errors on the code's ``nq`` qubits (each qubit
in error with probability ``p``, then X, Y or Z alike), as the upstream
project's data generation draws them, and the state each decode starts
from: the error times a uniformly random logical (op and positions of each
logical draw), the randomised warm start of its pipeline
(generate_data.py:130-133).  The decoder sees only the start state's
syndrome and must find the error's class.

The whole pool is two draws of one ``torch.Generator`` on the card, so the
same seed gives the same inputs, and set-up stays a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.codes import Code, class_bits_np


def draw_pool(code: Code, p: float, n_batches: int, B: int, seed: int,
              device) -> tuple:
    """(errors, starts): (n_batches, B, nq) uint8 each, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    nq = code.nq
    r = torch.rand((n_batches, B, nq), generator=gen, device=device)
    err = torch.zeros((n_batches, B, nq), dtype=torch.uint8, device=device)
    err[r < p] = 2
    err[r < 2 * p / 3] = 1
    err[r < p / 3] = 3
    idx = torch.randint(0, 1 << 30, (n_batches, B, len(code.draws), 3),
                        generator=gen, device=device)
    start = err.clone()
    for i, d in enumerate(code.draws):
        lut = torch.as_tensor(d.op_lut, device=device)
        op = idx[..., i, 0] % 4
        xm = torch.as_tensor(d.x_masks, device=device)[idx[..., i, 1]
                                                       % d.x_masks.shape[0]]
        zm = torch.as_tensor(d.z_masks, device=device)[idx[..., i, 2]
                                                       % d.z_masks.shape[0]]
        start ^= xm * lut[op, 0, None] ^ zm * lut[op, 1, None]
    return err, start


def true_classes(code: Code, errors: np.ndarray) -> np.ndarray:
    """The class of each error (..., nq): what a decode has to return."""
    return class_bits_np(code.class_a, code.class_b, errors)


def failure_rate(code: Code, errors: np.ndarray, distributions) -> float:
    """Share of syndromes whose most likely class is not the error's."""
    guess = np.asarray(distributions).argmax(-1)
    return float(np.mean(guess != true_classes(code, errors)))
