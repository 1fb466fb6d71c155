"""``python -m mcmc_qec_tpu_torch generate --distributed``: one invocation
per rank (tests/test_cli_distributed.py's pattern, on the CPU).

Two processes join a local gloo process group with ``--platform cpu``; rank
0 writes the gathered dataset and alone prints ``wrote``.  Five points over
two ranks are the ragged shards 3 + 2; the file equals the per-rank
``generate`` runs under ``seed + rank`` bit for bit."""

import dataclasses
import sys

import numpy as np

from mcmc_qec_tpu_torch.pipeline import Dataset, RunConfig, generate

from torch_dist_common import launch

N_RANKS = 2
FLAGS = ["-n", "5", "--code", "planar", "--method", "STDC", "--size", "3",
         "--p-error", "0.08", "--p-sampling", "0.25", "--droplets", "1",
         "--steps", "300", "--batch", "4", "--seed", "11"]


def test_cli_distributed_generate_end_to_end(tmp_path):
    out = str(tmp_path / "dist.npz")

    def argv(rank, port):
        return [sys.executable, "-m", "mcmc_qec_tpu_torch", "generate",
                "--distributed", "--coordinator", f"localhost:{port}",
                "--platform", "cpu", "--num-processes", str(N_RANKS),
                "--process-id", str(rank), "--out", out, *FLAGS]

    rcs, outs = launch(argv, N_RANKS)
    for r, (rc, o) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{o[-4000:]}"
    assert "wrote 5 points" in outs[0]  # rank 0 writes and reports
    assert "wrote" not in outs[1]

    ds = Dataset.load(out)
    assert len(ds) == 5 and np.all(ds.true_classes >= 0)
    cfg = RunConfig(code="planar", method="STDC", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=1, steps=300, batch=4, seed=11,
                    device="cpu")
    assert ds.config == cfg
    parts = [generate(None, dataclasses.replace(cfg, seed=cfg.seed + r), n,
                      progress=None)
             for r, n in ((0, 3), (1, 2))]
    for f in ("qubit_matrices", "distributions", "true_classes"):
        np.testing.assert_array_equal(
            getattr(ds, f), np.concatenate([getattr(p, f) for p in parts]))
