"""Code-family specifications as static index tables.

TPU-first design: instead of the reference's per-family numba kernels
(reference: src/toric_model.py:174-377, src/planar_model.py:219-409,
src/rotated_surface_model.py:198-420, src/xzzx_model.py:150-486), every code
family compiles down to a small set of *static numpy tables* consumed by one
generic, batched JAX/Pallas engine:

- ``stab_qubits``/``stab_ops``: stabilizer supports as flat qubit indices and
  the Pauli XORed onto each qubit (padded entries use qubit 0 with op 0, a
  harmless no-op under XOR).
- checks == stabilizers for all four families: the syndrome bit of stabilizer
  ``s`` is the anticommutation parity of the state with the stabilizer's
  Pauli string (verified against the reference formulas, e.g.
  toric_model.py:58-101, planar_model.py:134-153, xzzx_model.py:155-223).
- ``class_A``/``class_B``: the equivalence class is a GF(2)-linear functional
  of the state's symplectic bit planes; each class bit is
  ``parity(A·bit0(s) + B·bit1(s))``.  This unifies toric 16-class parity
  counting (toric_model.py:317-351), planar/rotated first-row/column parity
  (planar_model.py:379-390, rotated_surface_model.py:411-420) and the XZZX
  alternating rule (xzzx_model.py:455-486).
- ``logical_draws``: random-logical proposal tables (X/Z masks per position
  plus the family's op->(do_X, do_Z) convention, cf. toric_model.py:228-253,
  planar_model.py:271-288, rotated_surface_model.py:331-346,
  xzzx_model.py:340-357).
- ``class_delta_masks``: for every class-bit pattern, a Pauli mask whose XOR
  moves a state's class by that pattern while preserving the syndrome.  This
  generalizes ``Toric_code.to_class`` (toric_model.py:354-377) and *fixes*
  the reference gap where ``Planar_code.to_class`` is commented out
  (planar_model.py:393-409).
- ``color_stabs``: a greedy conflict-free coloring of the stabilizers used by
  the checkerboard multi-proposal sweep kernel.

Pauli encoding matches the reference: 0=I, 1=X, 2=Y, 3=Z with XOR
composition (X^Z=Y).  X-component of v is bit0(v)^bit1(v); Z-component is
bit1(v); two Paulis anticommute iff ``b0(a)&b1(b) ^ b1(a)&b0(b)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Pauli helpers (host-side, numpy)
# ---------------------------------------------------------------------------


def xcomp(v: np.ndarray) -> np.ndarray:
    """1 where the Pauli has an X component (v in {1, 2})."""
    v = np.asarray(v)
    return ((v & 1) ^ ((v >> 1) & 1)).astype(np.uint8)


def zcomp(v: np.ndarray) -> np.ndarray:
    """1 where the Pauli has a Z component (v in {2, 3})."""
    v = np.asarray(v)
    return ((v >> 1) & 1).astype(np.uint8)


def anticommute(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Symplectic form: 1 iff Paulis a and b anticommute."""
    a = np.asarray(a)
    b = np.asarray(b)
    b0a, b1a = a & 1, (a >> 1) & 1
    b0b, b1b = b & 1, (b >> 1) & 1
    return ((b0a & b1b) ^ (b1a & b0b)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Spec dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LogicalDraw:
    """One random-logical draw: ``op ~ U{0..3}``, positions ``~ U{0..n_pos}``.

    ``x_masks[p]``/``z_masks[p]`` are (nq,) uint8 Pauli masks XORed onto the
    state when the drawn op has an X/Z part at position ``p``.  ``op_lut`` maps
    op -> (do_X, do_Z) following the family's convention.
    """

    x_masks: np.ndarray  # (n_pos, nq) uint8
    z_masks: np.ndarray  # (n_pos, nq) uint8
    op_lut: np.ndarray  # (4, 2) uint8


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash so
# specs can key lru_caches (family spec functions are cached, so one
# instance exists per (family, size))
class CodeSpec:
    """Static description of a code family instance (one lattice size)."""

    family: str
    size: int
    state_shape: Tuple[int, ...]  # canonical state shape, e.g. (2, d, d)
    nq: int  # == prod(state_shape)
    n_classes: int
    n_class_bits: int

    # Stabilizers (= syndrome checks).
    stab_qubits: np.ndarray  # (n_stabs, deg) int32 flat indices, pad -> 0
    stab_ops: np.ndarray  # (n_stabs, deg) uint8 Pauli, pad -> 0
    stab_masks: np.ndarray  # (n_stabs, nq) uint8 dense Pauli masks

    # Conflict-free coloring for the sweep kernel.
    color_stabs: np.ndarray  # (n_colors, max_per_color) int32, pad -> n_stabs
    # (a sentinel row of no-op stabilizers is appended at index n_stabs)

    # Equivalence classes: bit f = parity(class_A[f]·b0 + class_B[f]·b1).
    class_A: np.ndarray  # (n_class_bits, nq) uint8
    class_B: np.ndarray  # (n_class_bits, nq) uint8
    bits_to_eq: np.ndarray  # (n_classes,) uint8
    eq_to_bits: np.ndarray  # (n_classes,) uint8

    # Logical operators.
    logical_draws: Tuple[LogicalDraw, ...]
    class_delta_masks: np.ndarray  # (2**n_class_bits, nq) uint8

    # Valid-qubit mask (planar zeroes its unused cells,
    # planar_model.py:39-40); 1 where a physical qubit lives.
    valid_mask: np.ndarray  # (nq,) uint8

    # Layout of the defect vector in the family's canonical defect array
    # (for plotting / parity with the reference's defect matrices).
    defect_shape: Tuple[int, ...]
    defect_coords: np.ndarray  # (n_stabs,) int64 flat indices into defect_shape

    @property
    def n_stabs(self) -> int:
        return int(self.stab_qubits.shape[0])

    @property
    def stab_deg(self) -> int:
        return int(self.stab_qubits.shape[1])

    @property
    def max_length(self) -> int:
        """Largest possible error-chain length (2*d*d for 2-layer codes)."""
        return int(self.valid_mask.sum())


# ---------------------------------------------------------------------------
# Generic constructors
# ---------------------------------------------------------------------------


def _flatten(coords: Sequence[Tuple[int, ...]], shape: Tuple[int, ...]) -> np.ndarray:
    return np.ravel_multi_index(np.array(coords).T, shape).astype(np.int32)


def _pad_table(
    rows: List[Tuple[List[int], List[int]]], deg: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-stabilizer (qubits, ops) lists to a dense (n, deg) table."""
    n = len(rows)
    qubits = np.zeros((n, deg), dtype=np.int32)
    ops = np.zeros((n, deg), dtype=np.uint8)
    for i, (q, o) in enumerate(rows):
        qubits[i, : len(q)] = q
        ops[i, : len(o)] = o
    return qubits, ops


def _dense_masks(qubits: np.ndarray, ops: np.ndarray, nq: int) -> np.ndarray:
    n = qubits.shape[0]
    masks = np.zeros((n, nq), dtype=np.uint8)
    for i in range(n):
        for q, o in zip(qubits[i], ops[i]):
            masks[i, q] ^= o
    return masks


def _greedy_coloring(qubits: np.ndarray, ops: np.ndarray, n_stabs: int) -> np.ndarray:
    """Greedy proper coloring of the stabilizer conflict graph.

    Two stabilizers conflict if they touch a common qubit; within a color all
    proposals are independent, so a vectorized Metropolis accept of a whole
    color preserves detailed balance.
    """
    # qubit -> list of stabs touching it
    touch: Dict[int, List[int]] = {}
    for s in range(n_stabs):
        for q, o in zip(qubits[s], ops[s]):
            if o != 0:
                touch.setdefault(int(q), []).append(s)
    adj: List[set] = [set() for _ in range(n_stabs)]
    for stabs in touch.values():
        for a in stabs:
            for b in stabs:
                if a != b:
                    adj[a].add(b)
    colors = -np.ones(n_stabs, dtype=np.int64)
    # visit highest-degree first for tighter colorings
    order = np.argsort([-len(a) for a in adj], kind="stable")
    for s in order:
        used = {colors[t] for t in adj[s] if colors[t] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[s] = c
    n_colors = int(colors.max()) + 1
    groups = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    width = max(len(g) for g in groups)
    table = np.full((n_colors, width), n_stabs, dtype=np.int32)  # pad -> sentinel
    for c, g in enumerate(groups):
        table[c, : len(g)] = g
    return table


def _class_bits_of_mask(mask: np.ndarray, class_A: np.ndarray, class_B: np.ndarray) -> int:
    """Class-bit pattern of a Pauli mask (valid because bits are GF(2)-linear)."""
    b0 = (mask & 1) ^ ((mask >> 1) & 1)  # X component
    b1 = (mask >> 1) & 1  # Z component
    feats = (class_A.astype(np.int64) @ b0.astype(np.int64)
             + class_B.astype(np.int64) @ b1.astype(np.int64)) % 2
    return int(np.sum(feats << np.arange(len(feats))))


def _build_delta_masks(
    generators: List[np.ndarray],
    class_A: np.ndarray,
    class_B: np.ndarray,
    n_bits: int,
) -> np.ndarray:
    """XOR-combine generator masks to hit every class-bit pattern."""
    nq = class_A.shape[1]
    gen_bits = [_class_bits_of_mask(g, class_A, class_B) for g in generators]
    out = np.zeros((1 << n_bits, nq), dtype=np.uint8)
    found = {0}
    # brute force over generator subsets (<= 2^4 = 16 subsets needed)
    for subset in range(1 << len(generators)):
        bits = 0
        mask = np.zeros(nq, dtype=np.uint8)
        for i in range(len(generators)):
            if subset >> i & 1:
                bits ^= gen_bits[i]
                mask = mask ^ generators[i]
        if bits not in found:
            found.add(bits)
            out[bits] = mask
    if len(found) != (1 << n_bits):
        raise ValueError(
            f"logical generators span only {len(found)} of {1 << n_bits} patterns"
        )
    return out


def build_spec(
    family: str,
    size: int,
    state_shape: Tuple[int, ...],
    stab_rows: List[Tuple[List[int], List[int]]],
    class_A: np.ndarray,
    class_B: np.ndarray,
    bits_to_eq: np.ndarray,
    logical_draws: Tuple[LogicalDraw, ...],
    valid_mask: np.ndarray,
    defect_shape: Tuple[int, ...],
    defect_coords: np.ndarray,
) -> CodeSpec:
    nq = int(np.prod(state_shape))
    deg = max(len(q) for q, _ in stab_rows)
    qubits, ops = _pad_table(stab_rows, deg)
    masks = _dense_masks(qubits, ops, nq)
    n_stabs = qubits.shape[0]
    color_stabs = _greedy_coloring(qubits, ops, n_stabs)

    n_bits = class_A.shape[0]
    eq_to_bits = np.zeros_like(bits_to_eq)
    for bits, eq in enumerate(bits_to_eq):
        eq_to_bits[eq] = bits

    # unit logical generators: every (draw, X@pos0 / Z@pos0) mask
    generators: List[np.ndarray] = []
    for drw in logical_draws:
        generators.append(drw.x_masks[0])
        generators.append(drw.z_masks[0])
    delta_masks = _build_delta_masks(generators, class_A, class_B, n_bits)

    return CodeSpec(
        family=family,
        size=size,
        state_shape=state_shape,
        nq=nq,
        n_classes=int(len(bits_to_eq)),
        n_class_bits=n_bits,
        stab_qubits=qubits,
        stab_ops=ops,
        stab_masks=masks,
        color_stabs=color_stabs,
        class_A=class_A.astype(np.uint8),
        class_B=class_B.astype(np.uint8),
        bits_to_eq=bits_to_eq.astype(np.uint8),
        eq_to_bits=eq_to_bits.astype(np.uint8),
        logical_draws=logical_draws,
        class_delta_masks=delta_masks,
        valid_mask=valid_mask.astype(np.uint8),
        defect_shape=defect_shape,
        defect_coords=defect_coords,
    )


# ---------------------------------------------------------------------------
# Host-side reference ops on specs (numpy; used by tests & matching layer)
# ---------------------------------------------------------------------------


def _batch_shape(spec: CodeSpec, state: np.ndarray) -> Tuple[int, ...]:
    """Leading batch shape; the state may be flat (..., nq) or shaped
    (..., *state_shape)."""
    k = len(spec.state_shape)
    if state.ndim >= k and tuple(state.shape[-k:]) == spec.state_shape:
        return state.shape[:-k]
    if state.shape[-1] == spec.nq:
        return state.shape[:-1]
    raise ValueError(f"bad state shape {state.shape} for {spec.family} d={spec.size}")


def np_syndrome(spec: CodeSpec, state: np.ndarray) -> np.ndarray:
    """Defect bit per stabilizer: anticommutation parity (numpy oracle)."""
    batch = _batch_shape(spec, state)
    flat = state.reshape(-1, spec.nq)
    vals = flat[:, spec.stab_qubits]  # (B, n_stabs, deg)
    ac = anticommute(vals, spec.stab_ops[None])
    out = ac.sum(axis=-1) % 2
    return out.reshape(batch + (spec.n_stabs,))


def np_eq_class(spec: CodeSpec, state: np.ndarray) -> np.ndarray:
    batch = _batch_shape(spec, state)
    flat = state.reshape(-1, spec.nq).astype(np.int64)
    b0 = (flat & 1) ^ ((flat >> 1) & 1)
    b1 = (flat >> 1) & 1
    feats = (b0 @ spec.class_A.T + b1 @ spec.class_B.T) % 2
    bits = (feats << np.arange(spec.n_class_bits)).sum(axis=-1)
    eq = spec.bits_to_eq[bits]
    return eq.reshape(batch)


def np_to_class(spec: CodeSpec, state: np.ndarray, eq: int) -> np.ndarray:
    """Return a state with the same syndrome but in class ``eq``."""
    cur = np_eq_class(spec, state)
    delta = spec.eq_to_bits[cur] ^ spec.eq_to_bits[eq]
    mask = spec.class_delta_masks[delta].reshape(state.shape)
    return state ^ mask


def np_count_errors(spec: CodeSpec, state: np.ndarray) -> np.ndarray:
    batch = _batch_shape(spec, state)
    flat = state.reshape(-1, spec.nq)
    return np.count_nonzero(flat, axis=-1).reshape(batch)


def defect_array(spec: CodeSpec, defects: np.ndarray) -> np.ndarray:
    """Scatter the flat defect vector into the family's canonical layout."""
    out = np.zeros(spec.defect_shape, dtype=defects.dtype)
    out.reshape(-1)[spec.defect_coords] = defects
    return out
