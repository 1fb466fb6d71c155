"""The least time an NVIDIA H100 could take for a count of work.

Rates: HBM3 at 3.35 TB/s (NVIDIA's H100 SXM data sheet); per SM and clock,
16 population counts and 64 32-bit integer multiplies (CUDA C++ Programming
Guide, throughput of native arithmetic instructions, compute capability
9.0).  Philox4x32-10 is 10 rounds of two mul.hi and two mul.lo, 40 integer
multiplies a block of four draws.  The SM count and the top SM clock are
read from the card.  The bound is the larger of bytes over bandwidth and
operations over issue rate.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLK_SM = 16
IMAD_PER_CLK_SM = 64
IMAD_PER_PHILOX = 40
POPC_PER_64BIT = 2


def bound_ms(n_bytes: float, popc: float, philox_blocks: float,
             imad: float = 0.0, *, n_sm: int, clock_hz: float
             ) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(popc / (POPC_PER_CLK_SM * n_sm * clock_hz),
                (philox_blocks * IMAD_PER_PHILOX + imad)
                / (IMAD_PER_CLK_SM * n_sm * clock_hz))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card_rates(device: int = 0) -> Tuple[int, float]:
    """(SM count, top SM clock in Hz) of the card."""
    import torch

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return n_sm, float(out.stdout.strip().splitlines()[0]) * 1e6
