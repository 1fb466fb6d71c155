"""XZZX twisted surface code family spec.

Reference semantics: src/xzzx_model.py (d x d lattice, odd d, state (d, d)
uint8, 4 equivalence classes; full plaquettes apply mixed ops [X, Z, Z, X]
over the 2x2 block, border half stabilizers apply mixed pairs).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .base import CodeSpec, LogicalDraw, build_spec
from .rotated import _half_defect_coord, _half_stab_coords


@functools.lru_cache(maxsize=None)
def xzzx_spec(d: int) -> CodeSpec:
    if d % 2 == 0:
        raise ValueError("xzzx code requires odd d (reference convention)")
    shape = (d, d)

    def q(r: int, c: int) -> int:
        return r * d + c

    rows: List[Tuple[List[int], List[int]]] = []
    defect_coords: List[int] = []

    # Full stabilizers: qubits [(r,c), (r+1,c), (r,c+1), (r+1,c+1)] with ops
    # [1, 3, 3, 1] (xzzx_model.py:369-371).
    for r in range(d - 1):
        for c in range(d - 1):
            qs = [q(r, c), q(r + 1, c), q(r, c + 1), q(r + 1, c + 1)]
            rows.append((qs, [1, 3, 3, 1]))
            defect_coords.append((r + 1) * (d + 1) + (c + 1))

    # Border half stabilizers with mixed op pairs (xzzx_model.py:382-434):
    # top [3,1], right [1,3], bottom [1,3], left [3,1].
    half_ops = {0: [3, 1], 1: [1, 3], 2: [1, 3], 3: [3, 1]}
    for i in range((d - 1) // 2):
        for j in range(4):
            coords = _half_stab_coords(d, i, j)
            rows.append(([q(r, c) for r, c in coords], half_ops[j]))
            dr, dc = _half_defect_coord(d, i, j)
            defect_coords.append(dr * (d + 1) + dc)

    nq = d * d
    # Class bits from the alternating first-row/first-column rule
    # (xzzx_model.py:455-476):
    #   x_errors parity: row-0 site (0, i): even i counts {1,2} (X comp),
    #     odd i counts {3,2} (Z comp).
    #   z_errors parity: col-0 site (i, 0): even i counts {3,2}, odd {1,2}.
    class_A = np.zeros((2, nq), dtype=np.uint8)
    class_B = np.zeros((2, nq), dtype=np.uint8)
    # planes are symplectic: A multiplies the X-component plane, B the
    # Z-component plane
    for i in range(d):
        if i % 2 == 0:
            class_A[0, q(0, i)] = 1  # even row-0 sites count {1,2} = X comp
            class_B[1, q(i, 0)] = 1  # even col-0 sites count {3,2} = Z comp
        else:
            class_B[0, q(0, i)] = 1  # odd row-0 sites count {3,2}
            class_A[1, q(i, 0)] = 1  # odd col-0 sites count {1,2}
    # (x%2, z%2) -> eq: (0,0)->0, (1,0)->1, (1,1)->2, (0,1)->3
    # (xzzx_model.py:477-486); bits index = f0 + 2 f1.
    bits_to_eq = np.array([0, 1, 3, 2], dtype=np.uint8)

    # Logical draw: do_X if op in {1,2}, do_Z if op in {3,2}
    # (xzzx_model.py:288-289).  X logical = X along the anti-diagonal,
    # Z logical = Z along the main diagonal (xzzx_model.py:291-311);
    # positions are drawn but ignored.
    op_lut = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.uint8)
    xm = np.zeros((1, nq), dtype=np.uint8)
    zm = np.zeros((1, nq), dtype=np.uint8)
    for i in range(d):
        xm[0, q(i, d - 1 - i)] ^= 1
        zm[0, q(i, i)] ^= 3
    draws = (LogicalDraw(x_masks=xm, z_masks=zm, op_lut=op_lut),)

    return build_spec(
        family="xzzx",
        size=d,
        state_shape=shape,
        stab_rows=rows,
        class_A=class_A,
        class_B=class_B,
        bits_to_eq=bits_to_eq,
        logical_draws=draws,
        valid_mask=np.ones(nq, dtype=np.uint8),
        defect_shape=(d + 1, d + 1),
        defect_coords=np.array(defect_coords, dtype=np.int64),
    )
