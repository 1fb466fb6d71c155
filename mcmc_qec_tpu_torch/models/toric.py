"""Toric code family spec.

Reference semantics: src/toric_model.py (periodic d x d lattice, two qubit
layers, state (2, d, d) uint8, 16 equivalence classes).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .base import CodeSpec, LogicalDraw, build_spec


@functools.lru_cache(maxsize=None)
def toric_spec(d: int) -> CodeSpec:
    shape = (2, d, d)

    def q(layer: int, r: int, c: int) -> int:
        return (layer * d + r % d) * d + c % d

    # Stabilizers (== syndrome checks).  Supports and ops mirror
    # toric_model.py:256-284; vertex checks (op X) come first so the defect
    # vector reshapes to the reference's (2, d, d) defect_matrix
    # (toric_model.py:58-101).
    rows: List[Tuple[List[int], List[int]]] = []
    for r in range(d):
        for c in range(d):  # X stabilizer / vertex check at (r, c)
            rows.append(
                (
                    [q(1, r, c), q(1, r, c - 1), q(0, r, c), q(0, r - 1, c)],
                    [1, 1, 1, 1],
                )
            )
    for r in range(d):
        for c in range(d):  # Z stabilizer / plaquette check at (r, c)
            rows.append(
                (
                    [q(1, r, c), q(0, r, c), q(0, r, c + 1), q(1, r + 1, c)],
                    [3, 3, 3, 3],
                )
            )

    nq = 2 * d * d
    # Class bits (x1, z1, x2, z2): X/Z-component parity per layer
    # (toric_model.py:317-351).
    class_A = np.zeros((4, nq), dtype=np.uint8)
    class_B = np.zeros((4, nq), dtype=np.uint8)
    layer0 = np.arange(d * d)
    layer1 = d * d + np.arange(d * d)
    # planes are symplectic: A multiplies the X-component plane, B the
    # Z-component plane
    class_A[0, layer0] = 1  # x1: X-component parity of layer 0
    class_B[1, layer0] = 1  # z1: Z-component parity of layer 0
    class_A[2, layer1] = 1  # x2
    class_B[3, layer1] = 1  # z2
    bits_to_eq = np.arange(16, dtype=np.uint8)  # eq = x1 + 2 z1 + 4 x2 + 8 z2

    # Logical draws: one op per layer (toric_model.py:228-253).
    # layer 0: X on row X_pos of layer 0, Z on column Z_pos of layer 0.
    # layer 1 (transposed convention): X on column X_pos of layer 1,
    #   Z on row Z_pos of layer 1 (toric_model.py:197-223).
    # op -> (do_X, do_Z): do_X if op in {1,2}; do_Z if op in {2,3}.
    op_lut = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.uint8)

    x0 = np.zeros((d, nq), dtype=np.uint8)
    z0 = np.zeros((d, nq), dtype=np.uint8)
    x1m = np.zeros((d, nq), dtype=np.uint8)
    z1m = np.zeros((d, nq), dtype=np.uint8)
    for p in range(d):
        for i in range(d):
            x0[p, q(0, p, i)] ^= 1
            z0[p, q(0, i, p)] ^= 3
            x1m[p, q(1, i, p)] ^= 1
            z1m[p, q(1, p, i)] ^= 3
    draws = (
        LogicalDraw(x_masks=x0, z_masks=z0, op_lut=op_lut),
        LogicalDraw(x_masks=x1m, z_masks=z1m, op_lut=op_lut),
    )

    valid = np.ones(nq, dtype=np.uint8)
    defect_coords = np.arange(2 * d * d, dtype=np.int64)  # [vertex, plaquette]

    return build_spec(
        family="toric",
        size=d,
        state_shape=shape,
        stab_rows=rows,
        class_A=class_A,
        class_B=class_B,
        bits_to_eq=bits_to_eq,
        logical_draws=draws,
        valid_mask=valid,
        defect_shape=(2, d, d),
        defect_coords=defect_coords,
    )
