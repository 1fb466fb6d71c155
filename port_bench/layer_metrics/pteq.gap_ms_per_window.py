"""pteq.gap_ms_per_window: PTEQ's host window loop between K2 launches.
The benchmark's span around every PTEQ call, less the K2 kernel time in the
trace, over the K2 launches (``ladder_window_counts``); rank 0's in a cell
of several ranks."""

import importlib

_k = importlib.import_module("port_bench.layer_metrics._kernels")


def read(rec):
    if not rec.get("k2_launches") or "pteq_call_s" not in rec:
        return None
    k2 = _k.seconds(rec, _k.K2)
    if k2 is None:
        return None
    return 1e3 * (rec["pteq_call_s"] - k2[0]) / rec["k2_launches"]
