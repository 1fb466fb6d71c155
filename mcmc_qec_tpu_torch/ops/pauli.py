"""Batched Pauli-state operations on torch tensors.

Counterpart of ``mcmc_qec_tpu/ops/pauli.py`` for the functions the PTEQ
slice uses.  All functions take *flat* uint8 states ``(..., nq)`` on any
device; the spec's numpy tables are moved to the state's device per call.
Everything is elementwise or a gather (no matmul), so results are exact on
every device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.base import CodeSpec


def count_errors(state: torch.Tensor) -> torch.Tensor:
    """Total error count n (toric_model.py:174-176)."""
    return (state != 0).sum(-1, dtype=torch.int32)


def count_errors_xyz(state: torch.Tensor) -> torch.Tensor:
    """Per-Pauli counts (n_x, n_y, n_z) on a trailing axis
    (planar_model.py:224-229)."""
    return torch.stack(
        [(state == v).sum(-1, dtype=torch.int32) for v in (1, 2, 3)], dim=-1
    )


def bit_planes(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X-component, Z-component) bit planes of a Pauli state."""
    b0 = (state & 1) ^ ((state >> 1) & 1)
    b1 = (state >> 1) & 1
    return b0, b1


def anticommute(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    b0a, b1a = a & 1, (a >> 1) & 1
    b0b, b1b = b & 1, (b >> 1) & 1
    return (b0a & b1b) ^ (b1a & b0b)


def syndrome(spec: CodeSpec, state: torch.Tensor) -> torch.Tensor:
    """Defect bit per stabilizer: anticommutation parity of the state with
    each check's Pauli string."""
    qubits = torch.as_tensor(spec.stab_qubits, dtype=torch.long,
                             device=state.device)
    ops = torch.as_tensor(spec.stab_ops, device=state.device)
    vals = state[..., qubits]  # (..., n_stabs, deg)
    ac = anticommute(vals, ops)
    return (ac.sum(-1, dtype=torch.int32) % 2).to(torch.uint8)


def class_bits(spec: CodeSpec, state: torch.Tensor) -> torch.Tensor:
    """Class-bit pattern: bit f = parity(A[f]·b0 + B[f]·b1)."""
    b0, b1 = bit_planes(state)
    a = torch.as_tensor(spec.class_A, device=state.device)
    b = torch.as_tensor(spec.class_B, device=state.device)
    feats = (
        (b0.unsqueeze(-2) & a).sum(-1, dtype=torch.int32)
        + (b1.unsqueeze(-2) & b).sum(-1, dtype=torch.int32)
    ) % 2  # (..., n_bits)
    weights = 1 << torch.arange(spec.n_class_bits, dtype=torch.int32,
                                device=state.device)
    return (feats * weights).sum(-1, dtype=torch.int32)


def eq_class(spec: CodeSpec, state: torch.Tensor) -> torch.Tensor:
    """Equivalence class id (toric_model.py:317-351 et al.), int32."""
    b2e = torch.as_tensor(spec.bits_to_eq, dtype=torch.int32,
                          device=state.device)
    return b2e[class_bits(spec, state).long()]
