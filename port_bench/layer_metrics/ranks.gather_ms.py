"""ranks.gather_ms: host ms of one gather of rows between the ranks, rank
0's program span ``multihost.allgather`` (``parallel/multihost.py``), its
total over its count (``_recorder``); a rank that finishes its decode first
waits in the gather for the slowest."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    s = _r.span(rec, "multihost.allgather")
    return None if s is None else s[1] / s[0]
