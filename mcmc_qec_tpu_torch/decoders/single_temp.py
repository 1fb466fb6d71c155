"""ST: single-temperature mean-energy decoder (decoders.py:108-135).

Counterpart of ``mcmc_qec_tpu/decoders/single_temp.py``.  One chain per
equivalence class at fixed p; the score per class is the mean error count
over the run (decision = argmin, generate_data.py:199-203).  Each recorded
step is five literal proposals (``ops/metropolis.py``, the reference's
cadence), batched over syndromes and classes on ``device``; plain torch on
every device, as the literal engine is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mcmc.ladder import betas_depolarizing
from ..models.base import CodeSpec
from ..ops.engines import resolve_device
from ..ops.metropolis import make_chain_update
from ..ops.pauli import count_errors
from .stdc import _as_states, _class_seeds

# proposals per recorded step (single_temp.py:24)
PROPOSALS_PER_STEP = 5


def single_temp(
    spec: CodeSpec,
    init_states,  # (B, nq) or (B, K, nq), numpy or tensor
    p: float,
    max_iters: int,
    seed: int = 0,
    *,
    device="cuda",
) -> np.ndarray:
    """Returns (B, K) float32 mean error counts (smaller = more likely
    class) over all but the last of ``max_iters`` recorded steps, as the
    reference averages ``nbr_errors_chain[eq, :max_iters-1]``
    (decoders.py:130-133).  ``seed`` seeds a generator on ``device`` that
    draws every proposal."""
    device = resolve_device(device)
    states = _class_seeds(spec, _as_states(init_states, device))
    update = make_chain_update(spec, PROPOSALS_PER_STEP)
    betas = torch.as_tensor(betas_depolarizing(p), dtype=torch.float32,
                            device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = torch.zeros(states.shape[:2], dtype=torch.int64, device=device)
    for t in range(max_iters):
        states = update(states, gen, betas)
        if t < max_iters - 1:
            total += count_errors(states)
    # the mean of int32 counts in float32: an exact sum over the steps,
    # divided once, as jnp.mean of the (T - 1, B, K) counts does
    mean = total.to(torch.float32) / torch.tensor(
        float(max_iters - 1), dtype=torch.float32, device=device)
    return mean.cpu().numpy()
