"""Planar (surface) code family spec.

Reference semantics: src/planar_model.py (open-boundary d x d planar code,
state (2, d, d) with cells (1, d-1, :) and (1, :, d-1) unused, 4 equivalence
classes).  Our spec also provides ``to_class`` via class_delta_masks, fixing
the reference gap where ``Planar_code.to_class`` is commented out
(planar_model.py:131-132, 393-409).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .base import CodeSpec, LogicalDraw, build_spec


@functools.lru_cache(maxsize=None)
def planar_spec(d: int) -> CodeSpec:
    shape = (2, d, d)

    def q(layer: int, r: int, c: int) -> int:
        return (layer * d + r) * d + c

    # X stabilizers at (row in 0..d-2, col in 0..d-1), with boundary
    # triangles at col 0 / d-1 (planar_model.py:297-311).  These are also the
    # vertex checks: vertex_defects[r, c] = parity of yz at
    # (0,r,c), (0,r+1,c), (1,r,c), (1,r,c-1) (planar_model.py:134-143).
    rows: List[Tuple[List[int], List[int]]] = []
    vertex_coords = []
    for r in range(d - 1):
        for c in range(d):
            if c == 0:
                qs = [q(0, r, 0), q(0, r + 1, 0), q(1, r, 0)]
            elif c == d - 1:
                qs = [q(0, r, c), q(0, r + 1, c), q(1, r, c - 1)]
            else:
                qs = [q(0, r, c), q(0, r + 1, c), q(1, r, c), q(1, r, c - 1)]
            rows.append((qs, [1] * len(qs)))
            vertex_coords.append(r * d + c)

    # Z stabilizers at (row in 0..d-1, col in 0..d-2), triangles at row 0 /
    # d-1 (planar_model.py:312-325) == plaquette checks
    # (planar_model.py:145-153).
    plaq_coords = []
    n_vertex_cells = (d - 1) * d
    for r in range(d):
        for c in range(d - 1):
            if r == 0:
                qs = [q(0, 0, c), q(0, 0, c + 1), q(1, 0, c)]
            elif r == d - 1:
                qs = [q(0, r, c), q(0, r, c + 1), q(1, r - 1, c)]
            else:
                qs = [q(0, r, c), q(0, r, c + 1), q(1, r, c), q(1, r - 1, c)]
            rows.append((qs, [3] * len(qs)))
            plaq_coords.append(n_vertex_cells + r * (d - 1) + c)

    nq = 2 * d * d
    # Class bits: f0 = X-component parity of first column of layer 0,
    # f1 = Z-component parity of first row of layer 0
    # (planar_model.py:379-390); eq = f0 + 2 f1.
    class_A = np.zeros((2, nq), dtype=np.uint8)
    class_B = np.zeros((2, nq), dtype=np.uint8)
    for r in range(d):
        class_A[0, q(0, r, 0)] = 1  # X-component plane
    for c in range(d):
        class_B[1, q(0, 0, c)] = 1  # Z-component plane
    bits_to_eq = np.arange(4, dtype=np.uint8)

    # Logical draw: single op; do_X if op in {1,3}, do_Z if op in {2,3}
    # (planar_model.py:247-248).  X logical = X across row X_pos of layer 0;
    # Z logical = Z down column Z_pos of layer 0 (planar_model.py:262-266).
    op_lut = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.uint8)
    xm = np.zeros((d, nq), dtype=np.uint8)
    zm = np.zeros((d, nq), dtype=np.uint8)
    for p in range(d):
        for i in range(d):
            xm[p, q(0, p, i)] ^= 1
            zm[p, q(0, i, p)] ^= 3
    draws = (LogicalDraw(x_masks=xm, z_masks=zm, op_lut=op_lut),)

    valid = np.ones(nq, dtype=np.uint8)
    for c in range(d):
        valid[q(1, d - 1, c)] = 0
    for r in range(d):
        valid[q(1, r, d - 1)] = 0

    # Defect layout: vertex (d-1, d) then plaquette (d, d-1), flattened into
    # one array of length (d-1)*d + d*(d-1).
    defect_coords = np.array(vertex_coords + plaq_coords, dtype=np.int64)

    return build_spec(
        family="planar",
        size=d,
        state_shape=shape,
        stab_rows=rows,
        class_A=class_A,
        class_B=class_B,
        bits_to_eq=bits_to_eq,
        logical_draws=draws,
        valid_mask=valid,
        defect_shape=(2 * d * (d - 1),),
        defect_coords=defect_coords,
    )


def planar_defect_arrays(spec: CodeSpec, defects: np.ndarray):
    """Split a flat planar defect vector into (vertex, plaquette) arrays
    matching ``Planar_code.vertex_defects``/``plaquette_defects`` shapes."""
    d = spec.size
    nv = (d - 1) * d
    vertex = defects[..., :nv].reshape(defects.shape[:-1] + (d - 1, d))
    plaq = defects[..., nv:].reshape(defects.shape[:-1] + (d, d - 1))
    return vertex, plaq
