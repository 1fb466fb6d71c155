"""k2_roofline: K2's share of its roofline.  The frozen count's least time
(``roofline/k2.py``) of every window launch at the rows it ran (recorded
around the window function PTEQ calls), over the K2 kernel time in the
trace."""

import importlib

_k = importlib.import_module("port_bench.layer_metrics._kernels")
k2 = importlib.import_module("port_bench.roofline.k2")


def read(rec):
    shapes = rec.get("k2_shapes")
    t = _k.seconds(rec, _k.K2)
    if not shapes or t is None or "n_sm" not in rec:
        return None
    least = sum(k2.bound_ms(rec["code"], s, n_sm=rec["n_sm"],
                            clock_hz=rec["clock_hz"]) for s in shapes)
    return 100.0 * least / (1e3 * t[0])
