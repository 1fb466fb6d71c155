"""k2.waves_per_launch: waves a K2 launch runs, the mean over its launches
of the launch's rows over the rows its shape holds on the card at once
(groups a block x blocks an SM by the occupancy calculator x SMs): the
program's counter ``k2.waves_micro`` (millionths of a wave, summed) over
``k2.form.registers`` plus ``k2.form.large`` (one a launch; ``_recorder``).
Below 1 a launch leaves SMs idle, above it rows wait for a later wave."""

import importlib

_r = importlib.import_module("port_bench.layer_metrics._recorder")


def read(rec):
    waves = _r.counter(rec, "k2.waves_micro")
    launches = sum(_r.counter(rec, f"k2.form.{form}") or 0
                   for form in ("registers", "large"))
    if waves is None or not launches:
        return None
    return waves * 1e-6 / launches
