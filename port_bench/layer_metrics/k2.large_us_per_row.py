"""k2.large_us_per_row: device us a syndrome row takes in a launch of K2's
large variant, the trace's time in kernels whose name holds
``ladder_window_kernel_wide`` (``_kernels``) over the program's counter
``k2.rows.large``, the rows of those launches summed (``_recorder``)."""

import importlib

_k = importlib.import_module("port_bench.layer_metrics._kernels")
_r = importlib.import_module("port_bench.layer_metrics._recorder")

WIDE = _k.K2 + "_wide"


def read(rec):
    rows = _r.counter(rec, "k2.rows.large")
    t = _k.seconds(rec, WIDE)
    if rows is None or t is None:
        return None
    return 1e6 * t[0] / rows
