"""Parallel-tempering ladder state and beta tables.

Counterpart of ``mcmc_qec_tpu/mcmc/ladder.py`` for the PTEQ decoders: the
numpy beta tables (depolarizing, biased, alpha) are carried over unchanged,
``LadderState`` holds torch tensors, and ``init_ladder`` replicates the
initial states across the rungs with the top rung flagged
(src/mcmc.py:72-79).  The ladder step
itself lives in the fused window (``ops/ladder_window.py``);
``make_ladder_step`` (the unfused step) is still to port (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.base import CodeSpec


class LadderState(NamedTuple):
    """Batched ladder state: B independent ladders of Nc chains each."""

    state: torch.Tensor  # (B, Nc, nq) uint8
    flag: torch.Tensor  # (B, Nc) int32 — 1 marks the descendant of a top chain
    tops0: torch.Tensor  # (B,) int32 — count of top-flags reaching the bottom


def betas_xyz(p_x, p_y, p_z) -> np.ndarray:
    """beta_i = -ln(p_i / (1 - p_total)) (the unified acceptance form)."""
    p = p_x + p_y + p_z
    return -np.log(np.array([p_x, p_y, p_z]) / (1.0 - p))


def betas_depolarizing(p: float) -> np.ndarray:
    return betas_xyz(p / 3.0, p / 3.0, p / 3.0)


def beta_ladder_depolarizing(p_bottom: float, Nc: int, p_top: float = 0.75) -> np.ndarray:
    """linspace p-ladder bottom -> 0.75 (src/mcmc.py:62-66)."""
    ps = np.linspace(p_bottom, p_top, Nc)
    return np.stack([betas_depolarizing(p) for p in ps])


def beta_ladder_biased(p_bottom: float, eta: float, Nc: int) -> np.ndarray:
    """p_top = (eta+1)/(2*eta+1) (src/mcmc_biased.py:83-86)."""
    p_top = (eta + 1.0) / (2.0 * eta + 1.0)
    ps = np.linspace(p_bottom, p_top, Nc)
    out = []
    for p in ps:
        pz = p * eta / (eta + 1.0)
        px = p / (2.0 * (eta + 1.0))
        out.append(betas_xyz(px, px, pz))
    return np.stack(out)


def beta_ladder_alpha(pz_tilde_bottom: float, alpha: float, Nc: int) -> np.ndarray:
    """pz_tilde ladder bottom -> 1 (src/mcmc_alpha.py:94-98); the unified
    betas are beta_z = -ln pz_tilde, beta_x = beta_y = -alpha ln pz_tilde."""
    pzt = np.linspace(pz_tilde_bottom, 1.0, Nc)
    bz = -np.log(np.maximum(pzt, 1e-30))
    return np.stack([alpha * bz, alpha * bz, bz], axis=-1)


def init_ladder(spec: CodeSpec, init_states: torch.Tensor, Nc: int) -> LadderState:
    """Replicate (B, nq) uint8 initial states across Nc rungs on their
    device; the top rung starts flagged (src/mcmc.py:72-79)."""
    if init_states.dim() != 2 or init_states.shape[1] != spec.nq:
        raise ValueError(
            f"init_states must be (B, {spec.nq}), got {tuple(init_states.shape)}"
        )
    B = init_states.shape[0]
    device = init_states.device
    state = (
        init_states.to(torch.uint8).unsqueeze(1).expand(B, Nc, spec.nq)
        .contiguous()
    )
    flag = torch.zeros((B, Nc), dtype=torch.int32, device=device)
    flag[:, -1] = 1
    tops0 = torch.zeros((B,), dtype=torch.int32, device=device)
    return LadderState(state=state, flag=flag, tops0=tops0)
