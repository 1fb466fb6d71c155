"""The benchmark's driver-independent parts: finding a cell's files by name,
the closed loop of the measured window, the trace's reduction, and the
result's last line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, found as
``configs/<config>.json``, and a traffic mix, found as
``traffic/<traffic>.json``.  The configuration names its ``driver``
(``drivers/<driver>.py``), which turns the two into calls into the port.  A
per-layer metric is read by ``layer_metrics/<metric>.py``.  Nothing here
knows a cell by name.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules the measured process may not hold once the window has closed:
# the JAX package and JAX itself, compared by whole top-level names
FOREIGN = ("jax", "jaxlib", "flax", "mcmc_qec_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(name: str, man: Optional[dict] = None) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(cells[name])
    w["config_data"] = load_json("configs", w["config"])
    w["traffic_data"] = load_json("traffic", w["traffic"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    w["end_to_end"] = mine(man["end_to_end"])
    w["per_layer"] = mine(man["per_layer"])
    return w


def driver_class(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}").Driver


def reader(metric: str):
    """``read(rec) -> float | None`` of a per-layer metric, from
    ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.layer_metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules(modules=None) -> List[str]:
    """Top-level names in ``modules`` (``sys.modules``) that are JAX's or
    the JAX package's; ``mcmc_qec_tpu_torch`` is another name."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(t for t in tops if t in FOREIGN)


def p90(values: List[float]) -> float:
    """The 90th percentile, linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = 0.9 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Window:
    """The closed loop: requests are handed one after another while time
    remains; the last one started before ``seconds`` ran out is waited for,
    and the window ends at its return."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.spans = []  # (hand-off, return) per request, perf_counter s

    def run(self, step) -> None:
        """``step(i, deadline)`` decodes request ``i`` and returns None, or
        True/False where the stop is decided across ranks."""
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        i = 0
        while True:
            a = time.perf_counter()
            stop = step(i, deadline)
            b = time.perf_counter()
            self.spans.append((a, b))
            i += 1
            if stop is None:
                stop = b >= deadline
            if stop:
                return

    @property
    def seconds_run(self) -> float:
        return self.spans[-1][1] - self.spans[0][0]

    @property
    def batch_seconds(self) -> List[float]:
        return [b - a for a, b in self.spans]


def _union(intervals) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce_trace(prof, top: int = 10) -> dict:
    """Device time, kernel time by name and the idle gaps of a
    ``torch.profiler`` run: ``busy_s`` (the union of the card's kernel,
    copy and set intervals), ``kernels`` {name: [seconds, launches]},
    ``device_ops`` and ``idle_gaps`` (the longest gaps summed by the host
    event that covered their middle)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, s + d, e.name()))
        elif d > 0:
            cpu.append((s, s + d, e.name()))
    kernels: Dict[str, list] = {}
    for a, b, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    busy = _union((a, b) for a, b, _ in dev) * 1e-9
    dev.sort()
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = {}
    end = None
    for a, b, _ in dev:
        if end is not None and a > end:
            mid = (a + end) // 2
            i = bisect.bisect_right(starts, mid)
            label = "host Python between traced ops"
            for j in range(i - 1, max(i - 400, -1), -1):
                if cpu[j][1] >= mid:
                    label = cpu[j][2]
                    break
            gaps[label] = gaps.get(label, 0.0) + (a - end) * 1e-9
        end = b if end is None else max(end, b)
    ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda x: -x[1])
    idle = sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])
    return dict(busy_s=busy, kernels=kernels, device_ops=ops[:top],
                idle_gaps=idle[:top])


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: Dict[str, tuple],
         breakdown: Optional[dict] = None) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    the numbers compared under ``checks``, its last key."""
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    print(json.dumps(out), flush=True)
