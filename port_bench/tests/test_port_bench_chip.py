"""The cells on the card, as the benchmark runs them: each one-card cell
for a few seconds comes out correct, and with the control (the plain
reference in bfloat16 in the kernel's place, at the cell's own size) not.
Skipped without a card; on a host with one:
``python -m pytest port_bench/tests -m chip``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

RUN = Path(__file__).resolve().parents[1] / "run.py"
CELLS = ["pteq_toric5.p015_b2603", "stdc_toric5.p010_b1024"]


def _run(cell, *extra):
    out = subprocess.run([sys.executable, str(RUN), "--workload", cell,
                          "--seed", str(2**31 + 21), "--trace", "0", *extra],
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    result = _run(cell, "--seconds", "5")
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    result = _run(cell, "--seconds", "1", "--control", "bf16")
    assert not result["correct"], result["checks"]
