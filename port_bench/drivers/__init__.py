"""Drivers: each turns a configuration and a traffic mix into calls into the
port (``mcmc_qec_tpu_torch``), records what the per-layer metrics read, and
holds what the timed path produced up against the plain reference.

A driver module defines ``Driver(ctx)`` with ``batch`` (syndromes a
request), ``warm()``, ``decode(i, deadline)``, ``end_window()``,
``rows(i)`` (the decode's answers), ``layer_record()``, ``quality()`` and
``check()`` (a dict of name -> (number, limit)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Context:
    cell: dict  # harness.cell(): the workload with its config and traffic
    seed: int
    device: str = "cuda"
    rank: int = 0
    world: int = 1
    trace: bool = False
    # "bf16": the plain reference in bfloat16 takes the kernel's place
    control: Optional[str] = None

    @property
    def config(self) -> dict:
        return self.cell["config_data"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_data"]

    def decode_seed(self, i: int) -> int:
        """Decoder seed of request ``i`` on this rank."""
        return self.seed * 1_000_003 + i * self.world + self.rank

    def pool_seed(self) -> int:
        return self.seed * self.world + self.rank

    def sampled(self, every: int, salt: int) -> "Sample":
        """The requests checked; every one in a control run."""
        return Sample(self.seed, 1 if self.control else every,
                      salt + 7 * self.rank)

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order (``[obj]`` alone)."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


class Sample:
    """Requests ``off, off + every, ...``, with ``off`` drawn from the seed,
    and a generator for the rows checked in them."""

    def __init__(self, seed: int, every: int, salt: int):
        self.rng = np.random.default_rng([int(seed), salt])
        self.every = every
        self.off = int(self.rng.integers(every))

    def __contains__(self, i: int) -> bool:
        return i % self.every == self.off
