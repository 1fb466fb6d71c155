"""The harness's arithmetic on synthetic numbers, the readers, and the
check that nothing measured loads JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

PB = Path(__file__).resolve().parents[1]


def test_p90():
    xs = [float(i) for i in range(1, 101)]
    assert harness.p90(xs) == pytest.approx(90.1)
    assert harness.p90([0.4]) == 0.4
    assert harness.p90([1.0, 3.0]) == pytest.approx(2.8)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_edges(monkeypatch):
    """Requests start while time remains; the last one started before the
    deadline is waited for; the window runs from the first hand-off to its
    return; the rate counts exactly those requests."""
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    durations = iter([0.3, 0.4, 0.5, 0.6, 0.7, 0.8])

    def step(i, deadline):
        clock.t += next(durations)

    w = harness.Window(1.0)
    w.run(step)
    # 0.3, 0.4 (0.7 s), 0.5 (1.2 s: started before the deadline, ends past)
    assert w.batch_seconds == pytest.approx([0.3, 0.4, 0.5])
    assert w.seconds_run == pytest.approx(1.2)


def test_window_stop_across_ranks(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    calls = []

    def step(i, deadline):
        clock.t += 1.0
        calls.append(i)
        return i == 4  # rank 0's flag, gathered

    harness.Window(1.0).run(step)
    assert calls == [0, 1, 2, 3, 4]


def test_foreign_modules_whole_names():
    mods = {"mcmc_qec_tpu_torch": 1, "mcmc_qec_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen.x": 1, "numpy": 1}
    assert harness.foreign_modules(mods) == []
    mods.update({"jax.numpy": 1, "mcmc_qec_tpu.ops": 1, "jaxlib": 1})
    assert harness.foreign_modules(mods) == ["jax", "jaxlib", "mcmc_qec_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (PB / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_jax_in_the_benchmark_sources():
    for p in _sources():
        assert not set(_imports(p)) & set(harness.FOREIGN), p


def test_reference_imports_nothing_of_the_port():
    for p in _sources("reference") + _sources("roofline") + [PB / "inputs.py"]:
        assert "mcmc_qec_tpu_torch" not in set(_imports(p)), p


def test_a_run_loads_no_jax():
    """What a run imports (harness, drivers, the port's entries) leaves no
    JAX or JAX package in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import port_bench.run, port_bench.drivers.pteq, "
        "port_bench.drivers.stdc, port_bench.drivers.ranks\n"
        "import mcmc_qec_tpu_torch.decoders.pteq, "
        "mcmc_qec_tpu_torch.decoders.stdc, "
        "mcmc_qec_tpu_torch.parallel.multihost\n"
        "from port_bench import harness\n"
        "print(harness.foreign_modules())\n" % str(PB.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload",
         "pteq_toric5.p015_b2603", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _reader(name):
    return harness.reader(name)


def test_readers_read_nothing_from_nothing():
    for m in harness.manifest()["per_layer"]:
        assert _reader(m["name"])({}) is None


def test_readers_on_a_synthetic_record():
    from port_bench.reference import codes

    rec = dict(window_s=10.0, busy_s=7.0, pteq_call_s=9.0, k2_launches=400,
               kernels={"void mqt::ladder_window_kernel<1, 1, true>(x)":
                        [6.0, 400],
                        "void mqt::sweep_kernel<1, 1, true, true>(y)":
                        [2.0, 16]},
               code=codes.toric(5), n_sm=132, clock_hz=1.98e9,
               k2_shapes=[(2048, 5, 600, 2, 12, True, True)] * 400,
               k1_shapes=[(65536, 1024, 1, True)] * 16,
               stream_ms={"merge": 160.0, "sample": 320.0}, stream_windows=4,
               rank_spans=[[1.0, 2.0], [1.0, 1.0]])
    assert _reader("device.idle_pct")(rec) == pytest.approx(30.0)
    assert _reader("device.idle_pct.stdc")(rec) == pytest.approx(30.0)
    assert _reader("pteq.gap_ms_per_window")(rec) == pytest.approx(7.5)
    assert _reader("stream.merge_ms_per_window")(rec) == pytest.approx(40.0)
    assert _reader("ranks.slowest_over_mean")(rec) == pytest.approx(
        (1.0 + 2.0 / 1.5) / 2)
    for name in ("k1_roofline", "k2_roofline"):
        v = _reader(name)(rec)
        assert 0.0 < v < 100.0
