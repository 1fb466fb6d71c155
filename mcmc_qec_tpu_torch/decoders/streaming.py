"""The ``stream`` knob of the counting decoders.

Counterpart of ``should_stream`` and its constants in
``mcmc_qec_tpu/decoders/streaming.py`` (:409-431), copied.  The
bounded-memory streaming reduction itself is still to port (ROADMAP.md
queue 1): a decode whose materialised sample stream would exceed
``STREAM_AUTO_BYTES`` raises there.
"""

from __future__ import annotations

import numpy as np

# materialized-path cost model: 8 key bytes + 12 n_xyz bytes per sample
STREAM_BYTES_PER_SAMPLE = 20
# stream="auto" switches to the bounded-memory path above this many bytes
STREAM_AUTO_BYTES = 1 << 30


def should_stream(stream, rows: int, droplets: int, steps: int) -> bool:
    """Resolve the ``stream`` knob shared by STDC/STRC/PTDC/PTRC:
    "auto" switches on once the materialized sample stream would exceed
    ~1 GiB; True/False force a path.  Any other value is rejected (a
    string like "off" must not silently truthy-enable streaming)."""
    if isinstance(stream, str):
        if stream != "auto":
            raise ValueError(
                f"stream={stream!r}: expected 'auto', True or False"
            )
        return rows * droplets * steps * STREAM_BYTES_PER_SAMPLE \
            > STREAM_AUTO_BYTES
    if not isinstance(stream, (bool, np.bool_, int)):
        raise ValueError(
            f"stream={stream!r}: expected 'auto', True or False"
        )
    return bool(stream)
