"""Engine and device selection (counterpart of
``mcmc_qec_tpu/ops/engines.py``).

Two decoder families have a ported engine:

- ``kind="pteq"``: ``"auto"`` and ``"fused"`` resolve to ``"fused"``, the
  PT-window path (``ops/ladder_window.py``);
- ``kind="counting"`` (STDC, STRC): ``"auto"`` and ``"pallas"`` resolve to
  ``"pallas"``, the colored-sweep path (``ops/sweep.py``).

Either path runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor.  The other engines raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

VALID_ENGINES = ("auto", "literal", "sweep", "pallas", "fused")

_LITERAL = ("ROADMAP.md queue 1 item 3, 'The other engines' "
            "(ops/metropolis.py literal stepper)")
_SWEEP = ("ROADMAP.md queue 1 item 3, 'The other engines' "
          "(ops/dense_sweep.py::make_dense_sweep)")

_PORTED = {"pteq": ("fused", ("auto", "fused")),
           "counting": ("pallas", ("auto", "pallas"))}

_NOT_PORTED = {
    "pteq": {"literal": _LITERAL, "sweep": _SWEEP,
             "pallas": "the PT ladder on the sweep kernel: "
                       "ROADMAP.md queue 1 item 3, 'The other engines' "
                       "(mcmc/ladder.py::make_ladder_step)"},
    # the JAX counting sampler runs the literal chain update for "fused"
    "counting": {"literal": _LITERAL, "sweep": _SWEEP, "fused": _LITERAL},
}


def resolve_engine(engine: str, kind: str) -> str:
    """Resolve ``engine`` for a decoder family (``"pteq"`` or
    ``"counting"``)."""
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {VALID_ENGINES}"
        )
    if kind not in _PORTED:
        raise ValueError(f"unknown decoder family {kind!r}; expected one of "
                         f"{tuple(_PORTED)}")
    resolved, accepted = _PORTED[kind]
    if engine not in accepted:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet for the {kind} decoders: "
            f"{_NOT_PORTED[kind][engine]}"
        )
    return resolved


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
