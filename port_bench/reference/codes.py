"""The toric code, built again from its definition for the plain reference.

A frozen, self-contained statement of the code the benchmark's cells decode:
the periodic d x d lattice with two qubit layers (nq = 2 d^2), its vertex (X)
and plaquette (Z) checks, the greedy colouring of the checks that the
decoders sweep in, the four class bits (X and Z parity of each layer), the
random-logical draws of the top rung, and one Pauli mask per change of class
bits.  The orders (checks, colours, masks) are the ones the decoders use,
because a replay that must agree draw for draw has to visit the checks in the
same order; the numbers are worked out here from the lattice alone.

Pauli values: 0 = I, 1 = X, 2 = Y, 3 = Z; X component ``v ^ (v >> 1) & 1``,
Z component ``v >> 1``.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np


class Draw(NamedTuple):
    x_masks: np.ndarray  # (n_pos, nq) uint8
    z_masks: np.ndarray  # (n_pos, nq) uint8
    op_lut: np.ndarray  # (4, 2) uint8: op -> (has X part, has Z part)


class Code(NamedTuple):
    family: str
    size: int
    nq: int
    n_classes: int
    stab_qubits: np.ndarray  # (n_stabs, 4) int64
    stab_ops: np.ndarray  # (n_stabs, 4) uint8
    stab_masks: np.ndarray  # (n_stabs, nq) uint8
    colors: Tuple[np.ndarray, ...]  # per colour: the check indices, in order
    class_a: np.ndarray  # (4, nq) on the X-component plane
    class_b: np.ndarray  # (4, nq) on the Z-component plane
    delta_masks: np.ndarray  # (16, nq) uint8, one per class-bit change
    draws: Tuple[Draw, ...]

    @property
    def n_stabs(self) -> int:
        return int(self.stab_qubits.shape[0])


def _coloring(qubits: np.ndarray, n_stabs: int) -> Tuple[np.ndarray, ...]:
    """Greedy proper colouring of the check conflict graph (two checks
    conflict when they share a qubit), highest degree first, ties by index;
    each colour lists its checks in increasing order."""
    touch = {}
    for s in range(n_stabs):
        for q in qubits[s]:
            touch.setdefault(int(q), []).append(s)
    adj = [set() for _ in range(n_stabs)]
    for stabs in touch.values():
        for a in stabs:
            adj[a].update(b for b in stabs if b != a)
    colors = -np.ones(n_stabs, dtype=np.int64)
    for s in np.argsort([-len(a) for a in adj], kind="stable"):
        used = {colors[t] for t in adj[s] if colors[t] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[s] = c
    return tuple(np.nonzero(colors == c)[0] for c in range(colors.max() + 1))


def class_bits_np(code_a: np.ndarray, code_b: np.ndarray,
                  state: np.ndarray) -> np.ndarray:
    """Class-bit pattern of Pauli states (..., nq)."""
    s = state.astype(np.int64)
    x = (s & 1) ^ ((s >> 1) & 1)
    z = (s >> 1) & 1
    feats = (x @ code_a.T.astype(np.int64) + z @ code_b.T.astype(np.int64)) % 2
    return (feats << np.arange(feats.shape[-1])).sum(-1)


@functools.lru_cache(maxsize=None)
def toric(d: int) -> Code:
    nq = 2 * d * d

    def q(layer: int, r: int, c: int) -> int:
        return (layer * d + r % d) * d + c % d

    rows: List[List[int]] = []
    ops: List[int] = []
    for r in range(d):  # vertex checks, X on four qubits
        for c in range(d):
            rows.append([q(1, r, c), q(1, r, c - 1), q(0, r, c), q(0, r - 1, c)])
            ops.append(1)
    for r in range(d):  # plaquette checks, Z on four qubits
        for c in range(d):
            rows.append([q(1, r, c), q(0, r, c), q(0, r, c + 1), q(1, r + 1, c)])
            ops.append(3)
    qubits = np.asarray(rows, np.int64)
    stab_ops = np.repeat(np.asarray(ops, np.uint8)[:, None], 4, 1)
    masks = np.zeros((len(rows), nq), np.uint8)
    for i, row in enumerate(rows):
        for qq in row:
            masks[i, qq] ^= ops[i]

    layer0 = np.arange(d * d)
    layer1 = d * d + layer0
    class_a = np.zeros((4, nq), np.uint8)
    class_b = np.zeros((4, nq), np.uint8)
    class_a[0, layer0] = 1
    class_b[1, layer0] = 1
    class_a[2, layer1] = 1
    class_b[3, layer1] = 1

    lut = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.uint8)
    x0, z0, x1, z1 = (np.zeros((d, nq), np.uint8) for _ in range(4))
    for p in range(d):
        for i in range(d):
            x0[p, q(0, p, i)] ^= 1
            z0[p, q(0, i, p)] ^= 3
            x1[p, q(1, i, p)] ^= 1
            z1[p, q(1, p, i)] ^= 3
    draws = (Draw(x0, z0, lut), Draw(x1, z1, lut))

    # one mask per class-bit change, from subsets of the unit logicals
    # (X and Z at position 0 of each draw), the first subset to reach each
    gens = [x0[0], z0[0], x1[0], z1[0]]
    gen_bits = [int(class_bits_np(class_a, class_b, g)) for g in gens]
    delta = np.zeros((16, nq), np.uint8)
    found = {0}
    for subset in range(16):
        bits, mask = 0, np.zeros(nq, np.uint8)
        for i in range(4):
            if subset >> i & 1:
                bits ^= gen_bits[i]
                mask = mask ^ gens[i]
        if bits not in found:
            found.add(bits)
            delta[bits] = mask
    if len(found) != 16:
        raise ValueError("the unit logicals do not reach every class")
    return Code("toric", d, nq, 16, qubits, stab_ops, masks,
                _coloring(qubits, len(rows)), class_a, class_b, delta, draws)


CODES = {"toric": toric}


def code(family: str, size: int) -> Code:
    if family not in CODES:
        raise ValueError(f"no reference for the {family!r} family")
    return CODES[family](int(size))
