"""k1_roofline: K1's share of its roofline.  The frozen count's least time
(``roofline/k1.py``) of every recording launch at its chains and steps
(recorded around the stream's chunk sampler), over the K1 kernel time in
the trace."""

import importlib

_k = importlib.import_module("port_bench.layer_metrics._kernels")
k1 = importlib.import_module("port_bench.roofline.k1")


def read(rec):
    shapes = rec.get("k1_shapes")
    t = _k.seconds(rec, _k.K1)
    if not shapes or t is None or "n_sm" not in rec:
        return None
    least = sum(k1.bound_ms(rec["code"], s, n_sm=rec["n_sm"],
                            clock_hz=rec["clock_hz"]) for s in shapes)
    return 100.0 * least / (1e3 * t[0])
