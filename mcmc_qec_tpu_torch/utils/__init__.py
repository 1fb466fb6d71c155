"""Utilities of the port: structured metrics (``metrics.py``, numpy
only)."""

from .metrics import (
    LadderMetrics,
    MetricsLogger,
    effective_sample_size,
    swap_acceptance_from_traces,
    unique_discovery_curve,
)
