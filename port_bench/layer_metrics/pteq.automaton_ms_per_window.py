"""pteq.automaton_ms_per_window: host ms a PTEQ window spends in the
convergence automaton, the self time of the program's span
``pteq.automaton`` over its count (``_recorder``)."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    s = _r.span(rec, "pteq.automaton")
    return None if s is None else s[2] / s[0]
