"""A cell of several ranks on the CPU, two processes joined by gloo: a
sound run is correct; one whose gather leaves the exchange out is not; a
worker that holds JAX is seen by rank 0."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).resolve().parent / "rank_worker.py"


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(fault):
    port = _port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2",
                               str(port), fault], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    assert all(rc == 0 for rc, _, _ in outs), [e[-2000:] for *_, e in outs]
    return json.loads(outs[0][1].strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("none", True),
                                           ("no_exchange", False)])
def test_two_ranks(fault, correct):
    result = _run(fault)
    assert result["correct"] is correct, result["checks"]
    assert result["device"]["count"] == 2
    assert result["foreign"] == []
    if not correct:
        assert result["checks"]["gather_rows_differing"][0] > 0


def test_a_worker_holding_jax_is_seen_by_rank_0():
    result = _run("jax_on_worker")
    assert result["foreign"] == ["jax"]
