"""Shared pieces of the benchmark's CPU tests: a cell cut to toric d=3 and
few steps, run through the harness on the CPU (the card check is skipped,
the rest of a run is the benchmark's own), and the ``chip`` marker."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port there")


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(name: str, ranks: int = 1) -> dict:
    """The cell ``name`` of BENCHMARK.json at toric d=3 and few steps."""
    from port_bench import harness

    cell = harness.cell(name)
    cfg = copy.deepcopy(cell["config_data"])
    cfg["code"]["size"] = 3
    if cfg["driver"] == "pteq":
        cfg["decoder"].update(Nc=3, max_steps=1200, window=60, energy_chunk=12)
        cfg["check"].update(every=2, replay_every=2, replay_rows=8)
        cell["traffic_data"] = dict(p=0.15, batch=16, pool_batches=4,
                                    ranks=ranks)
    else:
        # 4 droplets stream in windows of 1024 steps: two windows here
        cfg["decoder"].update(droplets=4, steps=1100, stream=True,
                              stream_capacity=64)
        cfg["check"].update(every=1, rows=2)
        cell["traffic_data"] = dict(p=0.1, batch=4, pool_batches=4,
                                    ranks=ranks)
    cell["config_data"] = cfg
    return cell


def run_small(name: str, seed: int = 2**31 + 7, seconds: float = 0.5,
              control=None):
    """One run of the small cell on the CPU: (result, quality)."""
    from port_bench.run import run_cell

    return run_cell(small_cell(name), seed, seconds, False, device="cpu",
                    control=control)
