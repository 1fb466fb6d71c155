"""Profiling helpers: device traces and lightweight throughput timers.

Counterpart of ``mcmc_qec_tpu/utils/profiling.py``: ``device_trace`` runs
``torch.profiler`` (CPU activity, and CUDA activity when a card is
present) and writes a Chrome trace under ``logdir``; ``Throughput`` and
``StageTimer`` are the JAX package's, unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` and write
    ``logdir/trace_<pid>.json`` (viewable in Perfetto or
    chrome://tracing); yields the profiler, whose ``key_averages()`` hold
    the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class Throughput:
    """Accumulating work/time meter: ``with meter.measure(n_proposals): ...``"""

    def __init__(self) -> None:
        self.work = 0.0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, work_units: float) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.work += work_units

    @property
    def rate(self) -> float:
        return self.work / self.seconds if self.seconds else 0.0


class StageTimer:
    """Named stage wall-times (host-side; synchronise the device yourself
    when timing device work)."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.times.values()) or 1.0
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{k:24s} {v:8.3f}s  {100*v/total:5.1f}%" for k, v in rows
        )
