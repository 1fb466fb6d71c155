"""pteq.compact_ms_per_window: host ms of PTEQ's batch compaction a window,
the total time of the program's span ``pteq.compact`` over its counter
``pteq.windows`` (``_recorder``): most windows compact nothing, a few
repack the batch."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    s, n = _r.span(rec, "pteq.compact"), _r.counter(rec, "pteq.windows")
    if s is None or n is None:
        return None
    return s[1] / n
