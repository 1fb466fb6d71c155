"""Sampler observability (numpy only).

A copy of ``mcmc_qec_tpu/utils/metrics.py``, so that the port imports
nothing of the JAX package.  The reference's only observability is ad-hoc
``print()`` progress lines (generate_data.py:54,140,256; decoders.py:87).
Here samplers can emit structured metrics: replica-exchange acceptance per
rung, tops0 round-trip rate, unique-chain discovery rate, and effective
sample size of the bottom-chain energy trace.  ``pteq_run`` logs one
``pteq_window`` record per window and ``stdc_run`` one ``stdc_run`` record
to a ``MetricsLogger``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class LadderMetrics:
    swap_accept_rate: np.ndarray  # (Nc-1,) fraction of accepted swaps per rung
    tops0_rate: float  # round trips per ladder step
    energy_ess: float  # effective sample size of the energy trace
    steps: int

    def to_json(self) -> str:
        return json.dumps(
            {
                "swap_accept_rate": self.swap_accept_rate.tolist(),
                "tops0_rate": self.tops0_rate,
                "energy_ess": self.energy_ess,
                "steps": self.steps,
            }
        )


def effective_sample_size(trace: np.ndarray, max_lag: Optional[int] = None) -> float:
    """ESS via the initial-positive-sequence autocorrelation estimator."""
    x = np.asarray(trace, dtype=np.float64)
    n = len(x)
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = x.var()
    if var == 0:
        return float(n)
    max_lag = max_lag or min(n // 2, 1000)
    acf = np.correlate(x, x, mode="full")[n - 1 : n - 1 + max_lag] / (var * n)
    tau = 1.0
    for k in range(1, max_lag):
        if acf[k] <= 0:
            break
        tau += 2.0 * acf[k]
    return float(n / tau)


def swap_acceptance_from_traces(flag_trace: np.ndarray) -> np.ndarray:
    """Estimate per-rung state mobility from a (T, Nc) flag trace (fraction
    of steps the rung's occupant changed)."""
    changed = flag_trace[1:] != flag_trace[:-1]
    return changed.mean(axis=0)


def unique_discovery_curve(first_occurrence_mask: np.ndarray) -> np.ndarray:
    """Cumulative unique-chain count over a chronological sample stream —
    the saturation diagnostic for STDC-style counting."""
    return np.cumsum(np.asarray(first_occurrence_mask, dtype=np.int64))


class MetricsLogger:
    """Tiny structured-metrics sink (JSONL), stdlib only."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=_np_default)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
