"""Engine and device selection (counterpart of
``mcmc_qec_tpu/ops/engines.py``): map the user-facing ``engine`` knob to a
concrete sampler for a decoder family.

Concrete engines, each running its CUDA kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor:

- ``fused``: the whole PT window in one launch (``ops/ladder_window.py``,
  kernel K2); PTEQ's ``"auto"``;
- ``pallas``: the counting decoders' recording sampler on the sweep kernel
  K1 (``ops/sweep.py``); STDC/STRC's ``"auto"``;
- ``sweep``: colored sweeps (``ops/dense_sweep.py::make_dense_sweep``, K1's
  general branch with a row of betas per chain) and the PT ladder step
  around them (``mcmc/ladder.py``); the ``"chain"`` family's ``"auto"``
  (PTDC, PTRC);
- ``literal``: one random stabilizer per proposal (``ops/metropolis.py``),
  the reference's cadence, plain torch on every device.

The names resolve as in the JAX package (engines.py:27-48), with one
exception: for the ``"chain"`` family (``single_temp``, PTDC, PTRC and the
ladder step) ``"pallas"`` resolves to ``"sweep"``, the K1 sweep, as the JAX
pipeline maps it for PTDC/PTRC (pipeline/generate.py:189-197); the JAX
``make_perm_ladder_step`` would run the literal update there (ROADMAP.md
§3).  The other engine names a family has no kernel for run the literal
update, as in the JAX package: ``pteq`` with ``pallas`` (ladder.py:156-157)
and ``counting`` with ``fused`` (counting.py:91-92).
"""

from __future__ import annotations

import torch

VALID_ENGINES = ("auto", "literal", "sweep", "pallas", "fused")

_AUTO = {"pteq": "fused", "counting": "pallas", "chain": "sweep"}


def resolve_engine(engine: str, kind: str) -> str:
    """Resolve ``engine`` for a decoder family: ``"pteq"`` (the PT-window
    decoders), ``"counting"`` (STDC/STRC) or ``"chain"`` (the plain ladder
    and single-temperature paths)."""
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {VALID_ENGINES}"
        )
    if kind not in _AUTO:
        raise ValueError(f"unknown decoder family {kind!r}; expected one of "
                         f"{tuple(_AUTO)}")
    if engine == "auto":
        return _AUTO[kind]
    if kind == "chain" and engine == "pallas":
        return "sweep"
    return engine


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` is every entry
    point's default; a CUDA request on a host without a card raises (the
    CPU runs only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU"
        )
    return device
