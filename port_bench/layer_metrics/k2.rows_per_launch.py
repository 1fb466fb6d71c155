"""k2.rows_per_launch: batch rows a K2 call runs, the program's count of
rows (``ladder_window_counts.rows``) over its launches and plain calls
(``_recorder``); below the request's batch once compaction repacks the
rows that have not converged."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    k = _r.k2_rows(rec)
    return None if k is None else k[0] / k[1]
