"""Colored-sweep tables.

Only ``_color_tables`` is ported so far (numpy, carried over unchanged
from ``mcmc_qec_tpu/ops/dense_sweep.py``): the ladder-window and sweep
kernels and their plain versions build their stabilizer tables from it.  ``make_dense_sweep``
(the ``sweep`` engine) is still to port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import functools

import numpy as np

from ..models.base import CodeSpec


@functools.lru_cache(maxsize=None)
def _color_tables(spec: CodeSpec):
    """Per color: selection matrix (W, nq) and op-component masks (nq,)."""
    tables = []
    for color in spec.color_stabs:
        stabs = [int(s) for s in color if s < spec.n_stabs]
        W = len(stabs)
        sel = np.zeros((W, spec.nq), dtype=np.int8)
        xop = np.zeros(spec.nq, dtype=np.uint8)
        zop = np.zeros(spec.nq, dtype=np.uint8)
        for i, s in enumerate(stabs):
            for q, o in zip(spec.stab_qubits[s], spec.stab_ops[s]):
                if o != 0:
                    sel[i, q] = 1
                    xop[q] = (o & 1) ^ ((o >> 1) & 1)  # X component
                    zop[q] = (o >> 1) & 1  # Z component
        tables.append((sel, xop, zop))
    return tables
