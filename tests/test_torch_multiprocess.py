"""The port's ``distributed_generate`` in four real processes on a gloo
process group (tests/test_multiprocess.py's pattern, on the CPU).

Five planar d=3 points over four ranks: shards of 2, 2, 1 and 0 rows, so
rank 3 decodes nothing.  The JAX package fails on this input (its empty
rank's reshape, multihost.py:121); the port must not.  Every rank gathers
the same dataset, the merged dataset equals the per-rank ``generate`` runs
under ``seed + rank`` bit for bit, and it loads in the JAX package's
``Dataset.load``.

    python tests/test_torch_multiprocess.py <rank> <world> <port> <out_dir>

runs one rank (this file run as a script is the worker; it imports no jax).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

N_RANKS, N_TOTAL = 4, 5
SHARDS = (2, 2, 1, 0)  # host_shard(5) over 4 ranks: per = 2


def config():
    from mcmc_qec_tpu_torch.pipeline import RunConfig

    return RunConfig(code="planar", method="STDC", size=3, p_error=0.08,
                     p_sampling=0.25, droplets=1, steps=300, batch=4, seed=11,
                     device="cpu")


def worker(rank: int, world: int, port: str, out_dir: str) -> int:
    from mcmc_qec_tpu_torch.parallel import (
        allgather_rows,
        distributed_generate,
        global_sum,
        host_shard,
        init_distributed,
    )
    import torch.distributed as dist

    init_distributed(f"localhost:{port}", world, rank, platform="cpu")
    assert dist.get_world_size() == world and dist.get_rank() == rank
    # the collectives: rows in rank order, sums over the ranks
    rows = allgather_rows(np.arange(3) + 100 * rank)
    expect = np.concatenate([np.arange(3) + 100 * r for r in range(world)])
    assert np.array_equal(rows, expect), rows
    assert global_sum(np.array([1, rank])).tolist() == [world,
                                                        sum(range(world))]
    sl = host_shard(N_TOTAL)
    assert sl.stop - sl.start == SHARDS[rank] or SHARDS[rank] == 0, sl
    merged = distributed_generate(
        os.path.join(out_dir, "merged.npz") if rank == 0 else None,
        config(), N_TOTAL, progress=None)
    assert len(merged) == N_TOTAL, len(merged)
    merged.save(os.path.join(out_dir, f"gathered_r{rank}.npz"))
    dist.destroy_process_group()
    print(f"worker {rank} ok", flush=True)
    return 0


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    from torch_dist_common import launch

    out_dir = str(tmp_path_factory.mktemp("mp"))
    rcs, outs = launch(lambda r, port: [sys.executable, __file__, str(r),
                                        str(N_RANKS), str(port), out_dir],
                       N_RANKS)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"worker {r} ok" in out
    return out_dir


def _load(path):
    from mcmc_qec_tpu_torch.pipeline import Dataset

    return Dataset.load(path)


def test_four_ranks_merge_with_a_zero_row_rank(mp_run):
    ds = _load(os.path.join(mp_run, "merged.npz"))
    assert len(ds) == N_TOTAL
    assert np.all(ds.true_classes >= 0)  # no padding row leaked through
    assert ds.qubit_matrices.shape == (N_TOTAL, 2, 3, 3)
    assert ds.distributions.shape == (N_TOTAL, 4)
    assert ds.distributions.dtype == np.float32
    assert ds.true_classes.dtype == np.int32
    assert ds.config == config()


def test_every_rank_gathers_the_same_dataset(mp_run):
    sets = [_load(os.path.join(mp_run, f"gathered_r{r}.npz"))
            for r in range(N_RANKS)]
    for other in sets[1:]:
        for f in ("qubit_matrices", "distributions", "true_classes"):
            np.testing.assert_array_equal(getattr(other, f),
                                          getattr(sets[0], f))


def test_merged_equals_the_per_rank_runs(mp_run):
    """Rank r ran ``generate`` under seed + r on its shard: the merged
    dataset is their concatenation, bit for bit."""
    from mcmc_qec_tpu_torch.pipeline import generate

    cfg = config()
    parts = [generate(None, dataclasses.replace(cfg, seed=cfg.seed + r), n,
                      progress=None)
             for r, n in enumerate(SHARDS) if n]
    merged = _load(os.path.join(mp_run, "merged.npz"))
    for f in ("qubit_matrices", "distributions", "true_classes"):
        np.testing.assert_array_equal(
            getattr(merged, f), np.concatenate([getattr(p, f) for p in parts]))


def test_the_merged_dataset_loads_in_the_jax_package(mp_run):
    from mcmc_qec_tpu.pipeline import Dataset as JaxDataset

    path = os.path.join(mp_run, "merged.npz")
    theirs, ours = JaxDataset.load(path), _load(path)
    for f in ("qubit_matrices", "distributions", "true_classes"):
        np.testing.assert_array_equal(getattr(theirs, f), getattr(ours, f))
    assert theirs.config.method == "STDC" and theirs.config.seed == 11


def test_the_jax_package_fails_on_a_zero_row_rank(monkeypatch):
    """The fault the port does not copy: on rank 3 of 4 with 5 points the
    JAX ``distributed_generate`` decodes 0 rows and its reshape of the
    empty dataset raises before any gather (the process count and index
    are patched in the JAX module; nothing is decoded)."""
    import mcmc_qec_tpu.parallel.multihost as jax_multihost
    from mcmc_qec_tpu.pipeline import RunConfig as JaxRunConfig

    monkeypatch.setattr(jax_multihost.jax, "process_count", lambda: N_RANKS)
    monkeypatch.setattr(jax_multihost.jax, "process_index", lambda: 3)
    cfg = dataclasses.asdict(config())
    cfg.pop("device")
    with pytest.raises(ValueError, match="cannot reshape"):
        jax_multihost.distributed_generate(None, JaxRunConfig(**cfg), N_TOTAL,
                                           progress=None)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
