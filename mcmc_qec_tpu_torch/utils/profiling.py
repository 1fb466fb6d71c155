"""Profiling helpers: the port's span and counter recorder, device traces
and lightweight throughput timers.

Counterpart of ``mcmc_qec_tpu/utils/profiling.py``: ``device_trace`` runs
``torch.profiler`` (CPU activity, and CUDA activity when a card is
present) and writes a Chrome trace under ``logdir``; ``Throughput`` and
``StageTimer`` are the JAX package's, unchanged.

The recorder (``recorder``, and the module functions ``span``, ``count``,
``new_call``, ``snapshot`` and ``reset`` bound to it) names the host work
of the port's layers: the pipeline's stages (``pipeline.*``), PTEQ's
window loop (``pteq.*``), the stream scan (``stream.*``) and the rank
gathers (``multihost.*``).  It records only while a ``torch.profiler``
records (``device_trace`` is one), in any thread of the process; otherwise
a span costs the read of one flag (``recording``).  While it records, a
span is also a host range of the profiler's trace, on the trace's clock, so
the trace's idle gaps can be put down to the span that covered them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


class _Span:
    """One open span: a range of the profiler's trace, timed on the host
    and nested in the thread's stack of open spans."""

    __slots__ = ("rec", "name", "call", "parent", "child_ns", "t0", "rf")

    def __init__(self, rec: "Recorder", name: str, call: Optional[int]):
        self.rec, self.name, self.call = rec, name, call

    def __enter__(self) -> "_Span":
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        if self.call is None and self.parent is not None:
            self.call = self.parent.call
        self.child_ns = 0
        self.rf = _trace_range(self.name, self.call)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter_ns() - self.t0
        self.rec._stack().pop()
        self.rf.__exit__(None, None, None)
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        self.rec._add(self.name, dur, dur - self.child_ns,
                      parent.name if parent is not None else None, self.call)
        return False


_OFF = contextlib.nullcontext()

# a host-only range: ``torch.profiler.record_function`` opens a user
# annotation, which the profiler mirrors onto the card's timeline from the
# first to the last kernel launched inside it, so that the host time
# between them would read as the card's busy time
_FastRange = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _trace_range(name: str, call: Optional[int]):
    """The profiler's range of a span, with the decode call's id as its
    input (in the trace's ``Concrete Inputs`` when the profiler records
    shapes)."""
    if _FastRange is None:
        return _OFF
    return _FastRange(name) if call is None else _FastRange(name, (call,))


def recording() -> bool:
    """Whether a ``torch.profiler`` records: the flag it sets for the whole
    process while it traces.  ``torch.autograd._profiler_enabled()``
    answers for the calling thread only, and the shards of
    ``parallel.map_shards`` run in threads of their own."""
    return _autograd_profiler._is_profiler_enabled


class Recorder:
    """Named host spans and counters, kept in memory while a
    ``torch.profiler`` records and not otherwise.

    ``span(name, call=None)`` is a context manager; ``count(name, n)`` adds
    to a counter.  Per span name the store keeps the count, the total host
    ns, the self ns (the total less the spans nested in it on the same
    thread), the names of the spans it was nested in and the ids of the
    decode calls it belonged to (``new_call()`` draws one; a span without
    one takes its parent's).  The store is thread-safe: the shards of
    ``parallel.map_shards`` launch from one host thread each, and every
    thread nests its own spans."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._calls = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # name -> [count, total ns, self ns, parent names, call ids]
            self._spans: Dict[str, list] = {}
            self._counters: Dict[str, int] = {}

    def new_call(self) -> int:
        """A fresh id for one decode call."""
        return next(self._calls)

    def span(self, name: str, call: Optional[int] = None):
        if not recording():
            return _OFF
        return _Span(self, name, call)

    def count(self, name: str, n: int = 1) -> None:
        if not recording():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "total_ns", "self_ns", "parents",
        "calls"}}, "counters": {name: n}}``, a copy."""
        with self._lock:
            spans = {
                name: dict(count=c, total_ns=t, self_ns=s,
                           parents=sorted(p, key=str), calls=sorted(ids))
                for name, (c, t, s, p, ids) in self._spans.items()}
            return dict(spans=spans, counters=dict(self._counters))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, total_ns: int, self_ns: int,
             parent: Optional[str], call: Optional[int]) -> None:
        with self._lock:
            e = self._spans.get(name)
            if e is None:
                e = self._spans[name] = [0, 0, 0, set(), set()]
            e[0] += 1
            e[1] += total_ns
            e[2] += self_ns
            e[3].add(parent)
            if call is not None:
                e[4].add(call)


# the port's one recorder; the functions below are its methods
recorder = Recorder()
span = recorder.span
count = recorder.count
new_call = recorder.new_call
snapshot = recorder.snapshot
reset = recorder.reset
