"""Rotated surface code family spec.

Reference semantics: src/rotated_surface_model.py (d x d rotated surface
code, odd d, state (d, d) uint8, 4 equivalence classes; checkerboard full
stabilizers plus border half stabilizers).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .base import CodeSpec, LogicalDraw, build_spec


def _half_stab_coords(d: int, i: int, j: int):
    """Qubit coords of border half stabilizer (i, j), j = border id
    (rotated_surface_model.py:369-381 / xzzx_model.py:382-434)."""
    if j == 0:  # top
        return [(0, 2 * i + 1), (0, 2 * i + 2)]
    if j == 1:  # right
        return [(2 * i + 1, d - 1), (2 * i + 2, d - 1)]
    if j == 2:  # bottom
        return [(d - 1, 2 * i), (d - 1, 2 * i + 1)]
    return [(2 * i, 0), (2 * i + 1, 0)]  # left


def _half_defect_coord(d: int, i: int, j: int):
    """Position of half-stab defect in the (d+1, d+1) plaquette_defects array
    (rotated_surface_model.py:114-130 / xzzx_model.py:66-82)."""
    if j == 0:
        return (0, 2 * i + 2)
    if j == 1:
        return (2 * i + 2, d)
    if j == 2:
        return (d, 2 * i + 1)
    return (2 * i + 1, 0)


@functools.lru_cache(maxsize=None)
def rotated_spec(d: int) -> CodeSpec:
    if d % 2 == 0:
        raise ValueError("rotated surface code requires odd d (reference convention)")
    shape = (d, d)

    def q(r: int, c: int) -> int:
        return r * d + c

    rows: List[Tuple[List[int], List[int]]] = []
    defect_coords: List[int] = []
    dshape = (d + 1, d + 1)

    # Full stabilizers at (r, c), r, c in 0..d-2: 2x2 block, uniform op
    # 1 if r%2 == c%2 else 3 (rotated_surface_model.py:357-368).
    for r in range(d - 1):
        for c in range(d - 1):
            op = 1 if (r % 2) == (c % 2) else 3
            qs = [q(r, c), q(r, c + 1), q(r + 1, c), q(r + 1, c + 1)]
            rows.append((qs, [op] * 4))
            defect_coords.append((r + 1) * (d + 1) + (c + 1))

    # Border half stabilizers: op 1 on top/bottom, 3 on right/left
    # (rotated_surface_model.py:369-381).
    half_ops = {0: 1, 1: 3, 2: 1, 3: 3}
    for i in range((d - 1) // 2):
        for j in range(4):
            coords = _half_stab_coords(d, i, j)
            rows.append(([q(r, c) for r, c in coords], [half_ops[j]] * 2))
            dr, dc = _half_defect_coord(d, i, j)
            defect_coords.append(dr * (d + 1) + dc)

    nq = d * d
    # Class bits: f0 = X-component parity of row 0; f1 = Z-component parity
    # of column 0 (rotated_surface_model.py:411-420); eq = f0 + 2 f1.
    class_A = np.zeros((2, nq), dtype=np.uint8)
    class_B = np.zeros((2, nq), dtype=np.uint8)
    for c in range(d):
        class_A[0, q(0, c)] = 1  # X-component plane
    for r in range(d):
        class_B[1, q(r, 0)] = 1  # Z-component plane
    bits_to_eq = np.arange(4, dtype=np.uint8)

    # Logical draw: do_X if op in {1,3}, do_Z if op in {2,3}
    # (rotated_surface_model.py:260-261).  X logical = X down column X_pos;
    # Z logical = Z across row Z_pos (rotated_surface_model.py:263-280).
    op_lut = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.uint8)
    xm = np.zeros((d, nq), dtype=np.uint8)
    zm = np.zeros((d, nq), dtype=np.uint8)
    for p in range(d):
        for i in range(d):
            xm[p, q(i, p)] ^= 1
            zm[p, q(p, i)] ^= 3
    draws = (LogicalDraw(x_masks=xm, z_masks=zm, op_lut=op_lut),)

    return build_spec(
        family="rotated",
        size=d,
        state_shape=shape,
        stab_rows=rows,
        class_A=class_A,
        class_B=class_B,
        bits_to_eq=bits_to_eq,
        logical_draws=draws,
        valid_mask=np.ones(nq, dtype=np.uint8),
        defect_shape=dshape,
        defect_coords=np.array(defect_coords, dtype=np.int64),
    )
