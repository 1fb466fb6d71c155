"""The port's command line (``python -m mcmc_qec_tpu_torch``) on the CPU:
the same flags and task-grid mapping as the JAX package's ``cli.py``,
plus ``--device``; generate, evaluate and concat end to end in
subprocesses; plot; ``--distributed``'s flag checks (its runs are in
test_torch_cli_distributed.py)."""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mcmc_qec_tpu.pipeline as jax_pipeline
import mcmc_qec_tpu_torch.pipeline as pipeline
from mcmc_qec_tpu import cli as jax_cli
from mcmc_qec_tpu_torch import cli
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class
from mcmc_qec_tpu_torch.pipeline import Dataset, RunConfig

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--code", "planar", "--method", "STDC", "--size", "7",
        "--p-error", "0.12", "--p-sampling", "0.3", "--droplets", "6",
        "--engine", "sweep", "--steps", "1234", "--mwpm-init", "true",
        "--Nc", "4", "--fixed-errors", "none", "--ckpt-dir", "ck"]


def _parsed(mod, argv):
    p = argparse.ArgumentParser()
    mod._add_config_args(p)
    return mod._config_from_args(p.parse_args(argv))


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("device", None)
    return d


def test_config_from_args_equals_jax():
    ours = _parsed(cli, ARGV)
    assert _fields(ours) == _fields(_parsed(jax_cli, ARGV))
    assert ours.code == "planar" and ours.size == 7 and ours.mwpm_init is True
    assert ours.p_sampling == 0.3 and ours.steps == 1234 and ours.Nc == 4
    assert ours.device == "cuda"
    assert _parsed(cli, ARGV + ["--device", "cpu"]).device == "cpu"
    # every JAX field is a flag of the port
    jax_flags = {f.name for f in dataclasses.fields(jax_pipeline.RunConfig)}
    assert jax_flags <= {f.name for f in dataclasses.fields(RunConfig)}


@pytest.mark.parametrize("task_id", [0, 7, 13, 25])
@pytest.mark.parametrize("steps", [[], ["--steps", "99"]], ids=["default",
                                                                "given"])
def test_task_id_grid_equals_jax(task_id, steps, monkeypatch):
    """``--task-id`` picks (p_error, size) from the grid as the JAX CLI
    does (cli.py:58-71), re-deriving the default steps per size."""
    got = {}

    def capture(name):
        def fake(out, cfg, nbr_datapoints=100, append=False, **kw):
            got[name] = cfg
            return []
        return fake

    monkeypatch.setattr(pipeline, "generate", capture("ours"))
    monkeypatch.setattr(jax_pipeline, "generate", capture("theirs"))
    argv = ["generate", "--size", "5", "--out", "x.npz", "--task-id",
            str(task_id), "--p-min", "0.02", "--p-max", "0.2",
            "--p-points", "5", "--sizes", "5,7,9"] + steps
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert jax_cli.main(argv) == 0
    assert _fields(got["ours"]) == _fields(got["theirs"])
    assert got["ours"].size == [5, 7, 9][(task_id // 5) % 3]
    if not steps:
        assert got["ours"].steps == 5 * got["ours"].size**5


def test_distributed_is_not_ported_yet():
    """``--distributed``'s flags are checked before any work: ``--append``
    with ``--distributed`` raises ``SystemExit`` (as the JAX CLI does,
    cli.py:77-78) and ``--platform cpu`` with ``--device cuda`` raises,
    both before a process group is joined.  (The name is the test's first
    form's, which pinned a ``NotImplementedError`` of ``--distributed``.)"""
    dist = ["generate", "--out", "x.npz", "--distributed", "--coordinator",
            "localhost:1234", "--num-processes", "2", "--process-id", "0",
            "--platform", "cpu"]
    with pytest.raises(SystemExit, match="--append is not supported"):
        cli.main(dist + ["--append"])
    with pytest.raises(SystemExit, match="conflicts with --device cuda"):
        cli.main(dist + ["--device", "cuda"])
    with pytest.raises(SystemExit, match="conflicts with --device cuda"):
        cli.main(["generate", "--out", "x.npz", "--platform", "cpu",
                  "--device", "cuda"])
    with pytest.raises(SystemExit, match="--platform tpu"):
        cli.main(["generate", "--out", "x.npz", "--platform", "tpu"])
    import torch.distributed

    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flags,device,platform", [
    (["--device", "cpu"], "cpu", "cpu"),
    (["--platform", "cpu"], "cpu", "cpu"),
    ([], "cuda", None),
    (["--platform", "gpu"], "cuda", "gpu"),
], ids=["device-cpu", "platform-cpu", "default", "platform-gpu"])
def test_distributed_joins_with_the_runs_platform(flags, device, platform,
                                                  monkeypatch, capsys):
    """``generate --distributed`` joins the group on the run's platform (a
    ``--device cpu`` run takes no card), decodes on the run's device, and
    rank 0 alone prints ``wrote``."""
    import torch.distributed as dist

    import mcmc_qec_tpu_torch.parallel as par

    got = {}
    monkeypatch.setattr(par, "init_distributed",
                        lambda *a, **kw: got.update(init=(a, kw)))

    def fake_generate(path, cfg, n, progress=None):
        got["cfg"] = cfg
        return [None] * n

    monkeypatch.setattr(par, "distributed_generate", fake_generate)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: got.update(destroyed=True))
    assert cli.main(["generate", "--out", "x.npz", "-n", "3", "--distributed",
                     "--coordinator", "localhost:1", "--num-processes", "2",
                     "--process-id", "0", *flags]) == 0
    assert got["init"] == (("localhost:1", 2, 0), {"platform": platform})
    assert got["cfg"].device == device and got["destroyed"]
    assert "wrote 3 points to x.npz" in capsys.readouterr().out


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "mcmc_qec_tpu_torch", *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def test_generate_evaluate_concat_in_subprocesses(tmp_path):
    common = ["--device", "cpu", "--code", "planar", "--size", "3",
              "--p-error", "0.08", "--batch", "4", "-n", "8"]
    a, b, c = (str(tmp_path / f) for f in ("a.npz", "b.npz", "c.npz"))
    out = _run(["generate", *common, "--method", "STDC", "--p-sampling",
                "0.25", "--droplets", "1", "--steps", "300", "--out", a],
               tmp_path)
    assert "wrote 8 points" in out
    _run(["generate", *common, "--method", "MWPM", "--out", b], tmp_path)
    out = _run(["concat", a, b, "--out", c], tmp_path)
    assert "wrote 16 points" in out
    out = _run(["evaluate", a, b, c], tmp_path)
    lines = out.strip().splitlines()
    assert len(lines) == 3 and all("points" in l for l in lines)
    ds = Dataset.load(c)
    spec = get_spec("planar", 3)
    assert len(ds) == 16 and ds.config.device == "cpu"
    np.testing.assert_array_equal(
        ds.true_classes, np_eq_class(spec, ds.qubit_matrices.reshape(16, -1)))
    fails = int((ds.distributions.argmax(1) != ds.true_classes).sum())
    assert f"16 points, {fails} failures" in lines[2]


def test_plot_to_a_file(tmp_path):
    spec = get_spec("planar", 3)
    paths = []
    for i, p in enumerate((0.05, 0.1)):
        s = np.zeros((3, spec.nq), np.uint8)
        s[1, 3] = 2
        ds = Dataset(s.reshape((3,) + spec.state_shape),
                     np.eye(4, dtype=np.float32)[[0, 1, 0]] * 100,
                     np_eq_class(spec, s).astype(np.int32),
                     RunConfig(code="planar", size=3, method="MWPM",
                               p_error=p))
        paths.append(str(tmp_path / f"d{i}.npz"))
        ds.save(paths[-1])
    out = str(tmp_path / "rates.png")
    assert cli.main(["plot", *paths, "--out", out]) == 0
    assert os.path.getsize(out) > 0
    from mcmc_qec_tpu_torch.pipeline.plot import plot_state

    for family in ("toric", "planar", "rotated", "xzzx"):
        sp = get_spec(family, 3)
        s = np.zeros(sp.nq, np.uint8)
        s[np.flatnonzero(sp.valid_mask)[:2]] = (1, 3)
        plot_state(sp, s, str(tmp_path / f"{family}.png"))
        assert (tmp_path / f"{family}.png").exists()
