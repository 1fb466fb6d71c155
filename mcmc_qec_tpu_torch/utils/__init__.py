"""Utilities of the port: exact checkpoint/resume (``checkpoint.py``),
structured metrics (``metrics.py``, numpy only) and profiling helpers
(``profiling.py``)."""

from .checkpoint import CheckpointManager, load_pytree, save_pytree
from .metrics import (
    LadderMetrics,
    MetricsLogger,
    effective_sample_size,
    swap_acceptance_from_traces,
    unique_discovery_curve,
)
from .profiling import StageTimer, Throughput, device_trace
