"""pteq.windows_per_batch: PTEQ windows a decode call runs, the program's
counter ``pteq.windows`` over its counter ``pteq.decodes``
(``_recorder``); the step cap over the window is the most."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    w, d = _r.counter(rec, "pteq.windows"), _r.counter(rec, "pteq.decodes")
    if w is None or d is None:
        return None
    return w / d
