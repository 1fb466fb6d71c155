"""Engine selection: map the user-facing ``engine`` knob to a concrete
sampler implementation (counterpart of ``mcmc_qec_tpu/ops/engines.py``).

Only the PT-window engine is ported: ``"auto"`` and ``"fused"`` resolve to
the ladder-window path (``ops/ladder_window.py``: the CUDA kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor).  The other engines
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

VALID_ENGINES = ("auto", "literal", "sweep", "pallas", "fused")

_NOT_PORTED = {
    "literal": "ROADMAP.md queue 1 item 'Engines as torch ops' "
               "(ops/metropolis.py literal stepper)",
    "sweep": "ROADMAP.md queue 1 item 'Engines as torch ops' "
             "(ops/dense_sweep.py::make_dense_sweep)",
    "pallas": "ROADMAP.md queue 2 kernel K1 "
              "(ops/pallas_sweep.py::make_pallas_sweep)",
}


def resolve_engine(engine: str) -> str:
    """Resolve ``engine`` for the PT-ladder window decoders."""
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {VALID_ENGINES}"
        )
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: {_NOT_PORTED[engine]}"
        )
    return "fused"
