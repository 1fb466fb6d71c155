"""device.idle_pct: the card's idle share in the PTEQ cells (``_idle``)."""

import importlib

read = importlib.import_module("port_bench.layer_metrics._idle").read
