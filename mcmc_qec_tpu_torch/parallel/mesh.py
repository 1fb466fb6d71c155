"""Device mesh: the syndrome batch split over devices.

Counterpart of ``mcmc_qec_tpu/parallel/mesh.py``.  The reference scales by
SLURM job fan-out with file-based aggregation (generate_data.py:274-308,
concat_data.py); here, as in the JAX package, the *syndrome batch* is the
parallel axis.  Ladders, classes and droplets stay on their device, so the
hot loop has no collective; only results cross devices.

A ``Mesh`` is a tuple of ``torch.device``s and an axis name.
``shard_batch`` splits the leading axis into one tensor per device,
``replicate`` copies a tensor to each, and ``map_shards`` runs a function
on every shard, one host thread per device, so the cards overlap (the
interpreter lock is released while a thread waits on its card).

**The semantics differ from JAX's.**  In JAX a sharded call is one global
program, so it equals the unsharded call (tests/test_distributed.py).  Here
``map_shards`` makes one call per shard, and the port's draws (Philox
counters keyed by the chain index within a launch, ``ops/sweep.py``; the
rain's ``torch.Generator``, ``decoders/counting.py``) depend on the shard a
chain is in.  So the contract is that of the hosts of
``parallel/multihost.py``: shard i runs under ``seed + i``.  Shard i then
equals a direct call on that shard under that seed bit for bit, a mesh of
one device equals the unsharded call bit for bit, and against the
unsharded call on a larger mesh the result agrees in distribution.

A CPU mesh (``make_mesh(n, device="cpu")``, n entries of the CPU) stands
in for JAX's virtual CPU devices in the tests; a mesh may list one card
more than once (``Mesh((dev, dev))``), two shards time-sharing it.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices in shard order and the axis's name."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device="cuda") -> Mesh:
    """A mesh of the first ``n_devices`` cards (default: every card), or
    with ``device="cpu"`` of ``n_devices`` (default 1) entries of the CPU.
    Asking for more cards than exist raises, as does a missing card."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis_name)
    if kind != "cuda":
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for "
                           "a CPU mesh")
    n = n_devices or count
    if n > count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def _tensor(arr) -> torch.Tensor:
    """A tensor as given, or a host tensor of a copy of an array (which
    may be read-only)."""
    return arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.array(arr))


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's "
                         f"{mesh.axis_name!r}")


def shard_batch(arr, mesh: Mesh, axis_name: str = "data") -> list:
    """The leading (batch) axis of ``arr`` (numpy or a tensor) split into
    ``mesh.size`` equal, contiguous shards, shard i on ``mesh.devices[i]``.
    A batch that does not divide raises (pad it with ``pad_to_multiple``)."""
    _check_axis(mesh, axis_name)
    t = _tensor(arr)
    if t.dim() == 0 or t.shape[0] % mesh.size:
        raise ValueError(f"a batch of shape {tuple(t.shape)} does not split "
                         f"over {mesh.size} devices")
    per = t.shape[0] // mesh.size
    return [t[i * per:(i + 1) * per].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def replicate(arr, mesh: Mesh) -> list:
    """One copy of ``arr`` on each device of the mesh, in mesh order."""
    t = _tensor(arr)
    return [t.to(dev, copy=True) for dev in mesh.devices]


def pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad the batch axis to a multiple of the mesh size with copies of the
    first row; returns (padded, original_length)."""
    B = arr.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return arr, B
    pad = np.repeat(arr[:1], rem, axis=0)
    return np.concatenate([arr, pad], axis=0), B


def _concat(parts: Sequence, device: torch.device):
    """Shard results joined along the leading axis: numpy arrays as numpy,
    tensors on ``device``, tuples and lists element by element."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts], device)
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    return np.concatenate([np.asarray(p) for p in parts])


def map_shards(fn: Callable, sharded: Sequence[torch.Tensor], seed: int,
               *replicated: Sequence) -> object:
    """``fn(shard_i, seed + i, *(r[i] for r in replicated))`` on every
    shard, each on its own host thread under its device (``fn`` may build
    tensors on a bare ``"cuda"``), and the results (numpy arrays, tensors,
    or tuples of them) joined in shard order, tensors on the first shard's
    device.  Shard i's result equals a direct call under ``seed + i``."""
    n = len(sharded)
    if any(len(r) != n for r in replicated):
        raise ValueError("every replicated argument needs one entry per shard")

    def run(i):
        shard = sharded[i]
        args = (shard, seed + i) + tuple(r[i] for r in replicated)
        if shard.device.type == "cuda":
            with torch.cuda.device(shard.device):
                out = fn(*args)
                torch.cuda.current_stream(shard.device).synchronize()
            return out
        return fn(*args)

    with ThreadPoolExecutor(max_workers=n) as pool:
        parts = [f.result() for f in [pool.submit(run, i) for i in range(n)]]
    return _concat(parts, sharded[0].device)
