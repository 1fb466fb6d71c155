"""Multi-process runs on ``torch.distributed``: one rank per card, without
SLURM file shuffling.

Counterpart of ``mcmc_qec_tpu/parallel/multihost.py``.  The reference
scales out with SLURM array tasks writing pickle files that are merged
offline (generate_data.py:274-308, concat_data.py).  Here every rank
decodes its shard of the syndrome batch on its own card and the result
rows are gathered in-band.

The process group's backend is gloo: what is gathered is numpy rows that
are already on the host, sent as fixed-shape CPU tensors.  The decode
itself has no collective (ladders, classes and droplets stay on their
card), and gloo, unlike NCCL, also runs two ranks that share one card.

A world of one process is the degenerate case: the shard is the whole
batch and the gathers return their input, so the regular tests run these
paths; with more ranks the same code runs after ``init_distributed()``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling

# a rank that never joins fails the run after this long instead of hanging it
JOIN_TIMEOUT = datetime.timedelta(seconds=120)

PLATFORMS = ("cpu", "cuda", "gpu")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _check_world(num_processes: Optional[int]) -> None:
    if num_processes is not None and _world() != num_processes:
        raise RuntimeError(
            f"torch.distributed joined {_world()} process(es), expected "
            f"{num_processes}: a rank that ran alone would decode the whole "
            "batch"
        )


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: Optional[str] = "gloo",
    platform: Optional[str] = None,
) -> None:
    """Join the process group: ``init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port`` of rank 0), or from the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` environment a
    launcher such as ``torchrun`` sets when no address is given, with the
    backend ``cpu_collectives`` (gloo) and a join timeout of
    ``JOIN_TIMEOUT``.  Does nothing when a group exists.

    ``platform="cpu"`` keeps the run's tensors on the CPU.  Otherwise the
    rank takes card ``(LOCAL_RANK or process_id) % device_count`` and makes
    it the current device before its first CUDA allocation, so that every
    bare ``"cuda"`` of the rank, and every bare
    ``torch.cuda.synchronize()``, is that card; no card raises.

    When ``num_processes`` is given, the joined world size is verified: a
    rank that silently ran alone would decode the whole batch (and write a
    conflicting file) instead of its shard."""
    if platform is not None and platform not in PLATFORMS:
        raise ValueError(f"platform={platform!r}: expected one of {PLATFORMS}")
    if dist.is_initialized():
        _check_world(num_processes)
        return
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    if platform != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device; pass platform='cpu' to "
                "run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=cpu_collectives or "gloo",
                            timeout=JOIN_TIMEOUT, **kw)
    _check_world(num_processes)


def host_shard(n_total: int) -> slice:
    """This process's contiguous shard of a global batch of ``n_total``
    (the last ranks' shards are shorter, or empty)."""
    p, n = _rank(), _world()
    per = -(-n_total // n)
    return slice(p * per, min((p + 1) * per, n_total))


def _gather(local: np.ndarray) -> list:
    """Every rank's ``local`` (equal shapes and dtypes), in rank order;
    the span ``multihost.allgather`` and the counter
    ``multihost.allgather_bytes`` (the bytes every rank's slot holds,
    summed) while a profiler records."""
    t = torch.from_numpy(np.ascontiguousarray(local))
    out = [torch.empty_like(t) for _ in range(_world())]
    with profiling.span("multihost.allgather"):
        dist.all_gather(out, t)
    profiling.count("multihost.allgather_bytes", t.nbytes * len(out))
    return [o.numpy() for o in out]


def allgather_rows(local: np.ndarray) -> np.ndarray:
    """Every rank's rows, concatenated in rank order, on every rank (the
    input itself in a world of one).  The shapes must be equal: pad a
    ragged shard."""
    if _world() == 1:
        return np.asarray(local)
    return np.concatenate(_gather(np.atleast_1d(np.asarray(local))))


def global_sum(value) -> np.ndarray:
    """A small array summed over the ranks (the input in a world of one)."""
    if _world() == 1:
        return np.asarray(value)
    return np.stack(_gather(np.asarray(value))).sum(axis=0)


def _rank_device(device: str) -> str:
    """A bare ``"cuda"`` pinned to the rank's current card."""
    if torch.device(device) == torch.device("cuda"):
        return f"cuda:{torch.cuda.current_device()}"
    return device


def distributed_generate(file_path, cfg, nbr_datapoints, progress=None):
    """Multi-process ``pipeline.generate``: rank r decodes its shard of the
    ``nbr_datapoints`` under ``seed = cfg.seed + r`` on its own device;
    every rank gathers the merged dataset; rank 0 writes it to
    ``file_path``.

    The ragged last shards are padded with rows of ``true_classes = -1``,
    trimmed after the gather.  A rank may get no rows at all (5 points over
    4 ranks: 2, 2, 1, 0): the row widths come from the code
    (``spec.state_shape``) and from one small gather of the ranks' widths
    of the distributions (the ``all`` and comparison methods concatenate
    several), never from the rank's own, possibly empty, arrays."""
    from ..models import get_spec
    from ..ops.engines import resolve_device
    from ..pipeline.dataset import Dataset
    from ..pipeline.generate import generate

    resolve_device(cfg.device)
    rank, world = _rank(), _world()
    sl = host_shard(nbr_datapoints)
    n_local = max(sl.stop - sl.start, 0)
    per = -(-nbr_datapoints // world)
    local_cfg = dataclasses.replace(cfg, seed=cfg.seed + rank,
                                    device=_rank_device(cfg.device))
    ds = generate(None, local_cfg, n_local, progress=progress)

    spec = get_spec(cfg.code, cfg.size)
    widths = allgather_rows(np.array(
        [ds.distributions.shape[1] if n_local else -1], np.int64))
    known = set(widths[widths >= 0].tolist())
    if len(known) > 1:
        raise RuntimeError(f"ranks decoded distributions of widths "
                           f"{sorted(known)}")
    K = known.pop() if known else 0

    # equal shapes on every rank: pad to `per` rows; float64 carries the
    # float32 distributions exactly
    qm = np.zeros((per, spec.nq), np.uint8)
    distr = np.zeros((per, K), np.float64)
    trues = np.full((per,), -1, np.int64)
    if n_local:
        qm[:n_local] = ds.qubit_matrices.reshape(n_local, spec.nq)
        distr[:n_local] = ds.distributions
        trues[:n_local] = ds.true_classes
    qms, distrs, trues = (allgather_rows(a) for a in (qm, distr, trues))
    keep = trues >= 0
    merged = Dataset(
        qubit_matrices=qms[keep].reshape((-1,) + tuple(spec.state_shape)),
        distributions=distrs[keep].astype(np.float32),
        true_classes=trues[keep].astype(np.int32),
        config=cfg,
    )
    if file_path and rank == 0:
        merged.save(file_path)
    return merged
