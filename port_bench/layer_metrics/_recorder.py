"""What the port's span and counter recorder
(``mcmc_qec_tpu_torch/utils/profiling.py``) and K2's kernel counter
(``ops/ladder_window.py::ladder_window_counts``) hold once the traced window
has closed.  The recorder records only while the profiler runs, which
starts after the driver's warm decode, and the warm decode resets the
kernel counter, so both hold the window alone.  They are read only for the
record of a traced run (one that holds the trace's reduction, ``kernels``).
Each function returns None where there is nothing to read: no trace,
nothing recorded, or a program without the recorder or the counter's
rows."""


def snapshot(rec: dict):
    if "kernels" not in rec:
        return None
    try:
        from mcmc_qec_tpu_torch.utils import profiling

        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def span(rec: dict, name: str):
    """(count, total ms, self ms) of the span ``name``, or None."""
    s = ((snapshot(rec) or {}).get("spans") or {}).get(name)
    if not s or not s.get("count"):
        return None
    return s["count"], s["total_ns"] * 1e-6, s["self_ns"] * 1e-6


def counter(rec: dict, name: str):
    """The counter ``name``, or None when it is absent or 0."""
    return ((snapshot(rec) or {}).get("counters") or {}).get(name) or None


def k2_rows(rec: dict):
    """(rows, calls) of K2's counter: the batch rows of its window calls
    summed, and its launches and plain calls; None without them."""
    if "kernels" not in rec:
        return None
    try:
        from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts
    except ImportError:
        return None
    c = ladder_window_counts
    rows = getattr(c, "rows", None)
    calls = c.launches + c.plain_calls
    if not rows or not calls:
        return None
    return rows, calls
