"""device.idle_pct.stdc: the card's idle share in the STDC cells
(``_idle``)."""

import importlib

read = importlib.import_module("port_bench.layer_metrics._idle").read
