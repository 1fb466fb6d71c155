"""Batched Pauli-state operations on torch tensors.

Counterpart of ``mcmc_qec_tpu/ops/pauli.py``, with the random-logical
draws split out (``draw_logicals``, ``logical_masks``) so that the literal
engine and the ladder's top-rung mix share them.  All functions take
*flat* uint8 states ``(..., nq)`` on any device; the spec's numpy tables
are moved to the state's device per call.  Everything is elementwise or a gather (no matmul:
torch has no integer matmul on CUDA, and a float one may run in TF32), so
results are exact on every device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.base import CodeSpec
from .philox import MASK32


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


def to_class(spec: CodeSpec, state: torch.Tensor, eq) -> torch.Tensor:
    """Move states to class ``eq`` (an int or a tensor broadcastable to
    the batch) while preserving the syndrome (pauli.py:80-88)."""
    e2b = torch.as_tensor(spec.eq_to_bits, dtype=torch.int64, device=state.device)
    masks = torch.as_tensor(spec.class_delta_masks, device=state.device)
    eq = torch.as_tensor(eq, dtype=torch.int64, device=state.device)
    delta = class_bits(spec, state).long() ^ e2b[eq]
    return state ^ masks[delta]


def all_class_states(spec: CodeSpec, state: torch.Tensor) -> torch.Tensor:
    """(K, ..., nq): one state per equivalence class with the syndrome of
    ``state`` (..., nq); the class axis leads, as ``jax.vmap`` over the
    classes puts it (pauli.py:91-96)."""
    return torch.stack([to_class(spec, state, e) for e in range(spec.n_classes)])


def apply_stabilizers_uniform(spec: CodeSpec, state: torch.Tensor,
                              generator: torch.Generator,
                              p: float = 0.5) -> torch.Tensor:
    """XOR a random subset of stabilizers (each selected w.p. ``p``) onto
    the state, the "rain" randomization (pauli.py:99-119).  ``generator``
    must live on the state's device.  The Pauli encoding is GF(2)-linear in
    the (X, Z) bit planes, so XORing the selected stabilizer masks one by
    one equals the JAX mat-vec over the planes."""
    sel = torch.rand(state.shape[:-1] + (spec.n_stabs,), generator=generator,
                     device=state.device) < p
    masks = torch.as_tensor(spec.stab_masks, device=state.device)
    out = state.clone()
    for s in range(spec.n_stabs):
        out ^= sel[..., s : s + 1].to(torch.uint8) * masks[s]
    return out


def draw_logicals(spec: CodeSpec, shape, generator: torch.Generator,
                  device) -> torch.Tensor:
    """(*shape, n_draws, 3) int64 uniform random-logical indices: per draw
    of ``spec.logical_draws`` an op in [0, 4) and an X and a Z position
    (pauli.py:127-131), from ``generator`` (on ``device``)."""
    cols = []
    for drw in spec.logical_draws:
        for hi in (4, drw.x_masks.shape[0], drw.z_masks.shape[0]):
            cols.append(torch.randint(0, hi, tuple(shape), generator=generator,
                                      device=device))
    return torch.stack(cols, -1).view(*shape, len(spec.logical_draws), 3)


def logical_masks(spec: CodeSpec, idx: torch.Tensor) -> torch.Tensor:
    """(..., nq) uint8 mask of the logicals ``idx`` (..., n_draws, 3) picks
    (op, X position, Z position per draw): the XOR over draws of the X mask
    at its position if the op has an X part and the Z mask at its position
    if it has a Z part (pauli.py:126-134)."""
    device = idx.device
    mask = None
    for i, drw in enumerate(spec.logical_draws):
        op, xp, zp = idx[..., i, 0], idx[..., i, 1], idx[..., i, 2]
        lut = torch.as_tensor(np.asarray(drw.op_lut, np.uint8), device=device)
        do = lut[op]  # (..., 2)
        xm = torch.as_tensor(drw.x_masks, device=device)[xp] * do[..., 0:1]
        zm = torch.as_tensor(drw.z_masks, device=device)[zp] * do[..., 1:2]
        m = xm ^ zm
        mask = m if mask is None else mask ^ m
    return mask


def random_logical(spec: CodeSpec, state: torch.Tensor,
                   generator: torch.Generator | None = None,
                   idx: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a uniformly random logical to each state of the batch (the
    randomized warm start, generate_data.py:130-133; pauli.py:122-135).
    The draws come from ``generator`` (on the state's device), or ``idx``
    (*batch, n_draws, 3) gives them (``draw_logicals``' layout)."""
    if idx is None:
        idx = draw_logicals(spec, state.shape[:-1], generator, state.device)
    return state ^ logical_masks(spec, idx.to(state.device))


def pack_key(spec: CodeSpec, state: torch.Tensor, mults) -> torch.Tensor:
    """64-bit content key of a chain as two 32-bit universal hashes
    (pauli.py:139-148): (..., 2) int64 holding the JAX uint32 values.
    Each product is below 2**34 and a sum over nq <= 768 qubits (the
    kernels' widest code, toric d=19 at 12 words per plane) below 2**44,
    so the int64 sum is exact and masking it to 32 bits is the JAX uint32
    wraparound.  ``mults`` is the (2, nq) numpy table of
    ``make_hash_mults`` or that table as an int64 tensor on the state's
    device (no copy per call)."""
    if isinstance(mults, torch.Tensor):
        m = mults.to(device=state.device, dtype=torch.int64)
    else:
        m = torch.as_tensor(np.asarray(mults, np.int64), device=state.device)
    h = (state.to(torch.int64).unsqueeze(-2) * m).sum(-1)
    return h & MASK32


def make_hash_mults(spec: CodeSpec, seed: int = 0x9E3779B9) -> np.ndarray:
    """(2, nq) odd uint32 multipliers of ``pack_key`` (pauli.py:151-154)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    mults = rng.randint(0, 1 << 31, size=(2, spec.nq), dtype=np.int64) * 2 + 1
    return mults.astype(np.uint32)
