"""Code-family registry.

The family spec functions and ``CodeSpec`` tables are numpy code carried over
unchanged from ``mcmc_qec_tpu.models`` (importing that package pulls in
jax); tests/test_torch_models.py pins every table against it.
"""

from __future__ import annotations

from .base import (
    CodeSpec,
    LogicalDraw,
    anticommute,
    defect_array,
    np_count_errors,
    np_eq_class,
    np_syndrome,
    np_to_class,
    xcomp,
    zcomp,
)
from .planar import planar_defect_arrays, planar_spec
from .rotated import rotated_spec
from .toric import toric_spec
from .xzzx import xzzx_spec

FAMILIES = {
    "toric": toric_spec,
    "planar": planar_spec,
    "rotated": rotated_spec,
    "xzzx": xzzx_spec,
}


def get_spec(family: str, size: int) -> CodeSpec:
    try:
        return FAMILIES[family](size)
    except KeyError:
        raise ValueError(f"unknown code family {family!r}; have {sorted(FAMILIES)}")
