"""pteq.dispatch_ms_per_window: host ms a PTEQ window spends handing K2 its
launch, the self time of the program's span ``pteq.dispatch`` (the window
function's call up to its return) over its count (``_recorder``)."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    s = _r.span(rec, "pteq.dispatch")
    return None if s is None else s[2] / s[0]
