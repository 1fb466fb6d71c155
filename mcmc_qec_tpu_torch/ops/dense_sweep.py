"""The ``sweep`` engine: one colored Metropolis sweep per call, and the
colored-sweep tables.

Counterpart of ``mcmc_qec_tpu/ops/dense_sweep.py``.  ``_color_tables`` is
carried over unchanged (numpy): the ladder-window and sweep kernels and
their plain versions build their stabilizer tables from it.
``make_dense_sweep`` is the JAX package's bit-plane sweep, in the same
color and stabilizer order with the per-Pauli acceptance
``(bx*dN_x + by*dN_y) + bz*dN_z``: on a CUDA tensor one launch of the sweep
kernel K1 (``ops/sweep.py``, general branch) with a row of betas per chain,
on a CPU tensor its plain version.  The JAX package's matmul form of the
per-stabilizer counts (the MXU) is a TPU layout, not the function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def make_dense_sweep(spec: CodeSpec, n_sweeps: int = 1):
    """``sweep(states (..., nq) u8, seed int, betas (3,) or (..., 3),
    logu=None) -> states``: ``n_sweeps`` full colored sweeps (n_stabs
    proposals each) over every chain (dense_sweep.py:48-106), the chains
    at one shared row of betas or at a row each.

    The device of ``states`` decides, as ``ops/sweep.py::make_sweep``
    does: CUDA makes one launch of the sweep kernel's general branch, CPU
    runs ``sweep_reference``.  ``logu`` (n_colors, *batch, W_max) f32, the
    JAX layout of ``log(uniform(key, ..., minval=1e-38))``
    (dense_sweep.py:70-73), replaces the uniforms of a one-sweep call with
    given ones and runs the plain version (parity tests)."""
    from .sweep import make_sweep, stab_width, sweep_counts, sweep_reference

    fn = make_sweep(spec, n_sweeps, equal_betas=False)
    nq = spec.nq
    n_colors = len(_color_tables(spec))

    def sweep(states: torch.Tensor, seed: int, betas, logu=None):
        batch = states.shape[:-1]
        N = int(np.prod(batch, dtype=np.int64))
        flat = states.reshape(N, nq).contiguous()
        b = torch.as_tensor(betas, dtype=torch.float32, device=states.device)
        if tuple(b.shape) != (3,):
            b = b.expand(batch + (3,)).reshape(N, 3).contiguous()
        if logu is None:
            out = fn(flat, seed, b)
        else:
            if n_sweeps != 1:
                raise ValueError("logu injection takes one sweep per call")
            lu = torch.as_tensor(logu, dtype=torch.float32,
                                 device=states.device)
            lu = lu.reshape(1, n_colors, N, stab_width(spec))
            sweep_counts.add_plain(N)
            out = sweep_reference(spec, flat, seed, b, 1, logu=lu)
        return out.reshape(states.shape)

    return sweep
