"""Exact mid-decode checkpoint/resume of the port's PTEQ host loop, and the
port's ``utils/checkpoint.py`` (tests/test_checkpoint_resume.py's pattern,
on the CPU).

A subprocess (this file run as a script) decodes with ``ckpt_dir`` set and
is hard-killed with ``os._exit(9)`` right after its 3rd snapshot lands;
the parent resumes from the surviving snapshot and must reproduce the
uninterrupted decode bit for bit, on the fused window and on the unfused
one.  The run is long enough that rows converge and the batch compacts
before the 3rd snapshot (``min_compact=2``), so the snapshot carries the
post-compact row map and buckets.  Shortest-chain tracking resumes
exactly too (preempted in process), a run that checkpoints but is never
killed equals the plain run, and a snapshot of another run is refused.

    python tests/test_torch_checkpoint.py <ckpt_dir> <engine>

runs the worker.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig, pteq_run
from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_alpha
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.utils import CheckpointManager, load_pytree, save_pytree
from mcmc_qec_tpu_torch.utils import checkpoint as ck

REPO = Path(__file__).resolve().parents[1]
FAM, D, B, NC, P_ERR, SEED = "toric", 3, 8, 3, 0.08, 5
# TOPS=2, SEQ=1 let rows converge within the run; min_compact=2 lets a
# batch of 8 compact (to 4 rows, and on the unfused window to 2)
RUN = dict(Nc=NC, window=100, iters=2, max_steps=2000, energy_chunk=4,
           TOPS=2, SEQ=1, min_compact=2, ckpt_every=5)
KILL_AFTER = 3
RESULT_FIELDS = ("distribution", "converged", "steps", "tops0")


def _states(spec, p, n, seed):
    rng = np.random.RandomState(seed)
    s = np.where(rng.uniform(size=(n, spec.nq)) < p,
                 rng.randint(1, 4, size=(n, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def run(engine, ckpt_dir=None):
    spec = get_spec(FAM, D)
    cfg = PTEQConfig(engine=engine, ckpt_dir=ckpt_dir, **RUN)
    return PTEQ(spec, _states(spec, P_ERR, B, 11), P_ERR, cfg, seed=SEED,
                device="cpu")


@functools.lru_cache(maxsize=None)
def baseline(engine):
    """The uninterrupted decode without checkpointing."""
    return run(engine)


def assert_same(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.buckets == b.buckets


class Preempted(Exception):
    pass


def preempting_save(n, then):
    """``CheckpointManager.save`` that calls ``then`` right after its n-th
    snapshot lands."""
    orig = CheckpointManager.save
    count = [0]

    def save(self, step, tree, meta=None):
        p = orig(self, step, tree, meta)
        count[0] += 1
        if count[0] >= n:
            then(step)
        return p

    return save


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread in every test here: under the tier-1 command's
    workers, per-core threads in each worker oversubscribe the CPU
    (tests/test_torch_ladder_window.py::one_torch_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("engine", ["auto", "sweep"])
def test_pteq_kill_and_resume_bit_identical(engine, tmp_path):
    base = baseline(engine)
    assert base.buckets, "the run must compact for this test to hold rows"
    ckpt_dir = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, __file__, str(ckpt_dir), engine],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 9, (
        f"worker should have been preempted (rc=9): rc={proc.returncode}\n"
        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    snaps = sorted(f.name for f in ckpt_dir.iterdir())
    # keep-last-2: the 2nd and 3rd snapshots (windows 9 and 14)
    assert snaps == ["ckpt_000000000009.npz", "ckpt_000000000014.npz"], snaps
    # the snapshot's leaves in sorted key order: "buckets" first; the run
    # had compacted when it was killed
    with np.load(ckpt_dir / snaps[-1]) as z:
        assert len(z["leaf_0"]) > 0, "no compaction before the kill"
    resumed = run(engine, str(ckpt_dir))
    assert_same(resumed, base)


def test_checkpointing_does_not_perturb_results(tmp_path):
    """A run that checkpoints (never killed) equals the plain run:
    snapshots only observe the generator and the automaton."""
    with_ckpt = run("auto", str(tmp_path / "ck2"))
    assert_same(with_ckpt, baseline("auto"))


def test_shortest_tracking_resumes_exactly(tmp_path, monkeypatch):
    """With ``track_shortest`` the snapshot also holds the device's
    shortest state and its host arrays: preempted after its 2nd snapshot
    (in process) and resumed, the decode equals the uninterrupted one,
    the shortest-chain distributions included."""
    spec = get_spec("xzzx", 3)
    states = _states(spec, 0.1, 4, 3)
    ladder = beta_ladder_alpha(0.1, 1.5, 3)

    def decode(ckpt_dir=None):
        cfg = PTEQConfig(Nc=3, window=100, iters=2, max_steps=500,
                         ckpt_dir=ckpt_dir, ckpt_every=2)
        return pteq_run(spec, states, ladder, cfg, (1.5, 1.5, 1.0), seed=2,
                        track_shortest=True, shortest_beta=2.3,
                        device="cpu")

    base = decode()
    ckpt_dir = str(tmp_path / "ck")

    def stop(step):
        raise Preempted(step)

    monkeypatch.setattr(CheckpointManager, "save", preempting_save(2, stop))
    with pytest.raises(Preempted):
        decode(ckpt_dir)
    monkeypatch.undo()
    resumed = decode(ckpt_dir)
    assert_same(resumed, base)
    for f in ("shortest_boltzmann", "shortest_counts", "shortest_overflow"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(base, f),
                                      err_msg=f)


def test_stale_checkpoint_from_other_run_rejected(tmp_path):
    """A snapshot written by a run of another signature raises instead of
    resuming the wrong decode."""
    ckpt_dir = str(tmp_path / "ck3")
    spec = get_spec(FAM, D)
    cfg = PTEQConfig(Nc=NC, window=100, iters=2, max_steps=200,
                     energy_chunk=4, ckpt_dir=ckpt_dir, ckpt_every=1)
    PTEQ(spec, _states(spec, P_ERR, B, 11), P_ERR, cfg, seed=SEED,
         device="cpu")  # leaves snapshots for B=8 behind
    with pytest.raises(ValueError, match="different run"):
        PTEQ(spec, _states(spec, P_ERR, 4, 1), P_ERR, cfg, seed=1,
             device="cpu")


def test_save_load_pytree_round_trip(tmp_path):
    """Nested dicts, tuples, lists, named tuples and None of tensors,
    arrays and scalars round-trip; each leaf comes back in the form of
    ``like``'s (a tensor of its dtype, else an array); keep-last-k and
    the snapshot names hold, and a save cut short is never the latest."""
    gen = torch.Generator().manual_seed(7)
    tree = {
        "b": (torch.arange(6, dtype=torch.int32).view(2, 3),
              {"z": torch.rand(4, generator=gen), "a": np.arange(3.0)}),
        "a": [torch.tensor([True, False]), np.int64(5), None],
        "st": torch.ones(2, 2, dtype=torch.uint8),
        "g": gen.get_state(),
    }
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree, {"k": [1, 2]})
    like = {
        "b": (torch.zeros(1, dtype=torch.int32),
              {"z": torch.zeros(1), "a": np.zeros(1)}),
        "a": [torch.zeros(1, dtype=torch.bool), np.int64(0), None],
        "st": torch.zeros(1, dtype=torch.uint8),
        "g": torch.zeros(1, dtype=torch.uint8),
    }
    out, meta = load_pytree(path, like)
    assert meta == {"k": [1, 2]}
    assert torch.equal(out["b"][0], tree["b"][0])
    assert out["b"][0].dtype == torch.int32
    assert torch.equal(out["b"][1]["z"], tree["b"][1]["z"])
    assert isinstance(out["b"][1]["a"], np.ndarray)
    np.testing.assert_array_equal(out["b"][1]["a"], tree["b"][1]["a"])
    assert torch.equal(out["a"][0], tree["a"][0]) and out["a"][2] is None
    assert int(out["a"][1]) == 5
    assert isinstance(out["a"], list) and isinstance(out["b"], tuple)
    assert torch.equal(out["st"], tree["st"])
    g2 = torch.Generator()
    g2.set_state(out["g"])
    assert torch.equal(torch.rand(3, generator=g2),
                       torch.rand(3, generator=gen))
    with pytest.raises(ValueError):
        load_pytree(path, {"only": torch.zeros(1)})

    m = CheckpointManager(str(tmp_path / "m"), keep=2)
    for step in (3, 10, 7):
        m.save(step, {"x": np.full(2, step)})
    names = sorted(os.listdir(m.directory))
    assert names == ["ckpt_000000000007.npz", "ckpt_000000000010.npz"]
    # a save cut short leaves its temporary file behind
    open(m.path(11) + ".tmp.npz", "wb").close()
    assert m.latest() == m.path(10)
    got, meta = m.restore_latest({"x": np.zeros(2)})
    assert got["x"].tolist() == [10, 10] and meta["step"] == 10


def _worker(ckpt_dir: str, engine: str) -> int:
    """Decode with snapshots every RUN["ckpt_every"] windows and die, as a
    preempted host would, right after the KILL_AFTER-th snapshot lands."""
    torch.set_num_threads(1)

    def die(step):
        print(f"preempting after the snapshot of window {step}", flush=True)
        os._exit(9)

    ck.CheckpointManager.save = preempting_save(KILL_AFTER, die)
    run(engine, ckpt_dir)
    print("ERROR: the run finished without being preempted", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], sys.argv[2]))
