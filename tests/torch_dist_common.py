"""Launching the port's multi-process runs from a test: one subprocess per
rank on a free local port, each with a time limit, torch on one thread, and
the whole launch tried once more if another process took the port between
the probe and the rendezvous."""

import os
import socket
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# per rank; the process group's own join timeout is 120 s
RANK_TIMEOUT_S = 180


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # six test workers, each with several ranks: one torch thread a rank
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch_once(argv_for_rank, n_ranks, port):
    procs = [subprocess.Popen(argv_for_rank(r, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env(), cwd=REPO,
                              text=True)
             for r in range(n_ranks)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\n[killed after {RANK_TIMEOUT_S} s]"
        outs.append(out)
    return [p.returncode for p in procs], outs


def launch(argv_for_rank, n_ranks):
    """Run ``argv_for_rank(rank, port)`` for every rank at once; returns
    (exit codes, outputs) by rank."""
    for attempt in range(2):
        rcs, outs = _launch_once(argv_for_rank, n_ranks, free_port())
        if attempt == 0 and any("address already in use" in o.lower()
                                for o in outs):
            continue
        return rcs, outs
