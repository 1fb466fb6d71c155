"""The port's multi-device runs on every NVIDIA GPU of one host.

    python3 chip_multichip.py

Needs two or more cards (run it with as many as the host has); imports no
jax.  Builds both kernels, then on R = ``torch.cuda.device_count()`` cards:

1. ``graft_entry.dryrun_multichip(R)``: the PT ladder step, the STDC
   sampler (K1) and the fused window (K2) over a mesh of every card, each
   kernel launched once a card;
2. STDC at ``chip_smoke.py``'s bench-key shape (toric d=5, p=0.1,
   p_sampling=0.25, droplets=4, steps=450) at 1024 syndromes a card through
   ``parallel.map_shards`` over the mesh of every card: each shard runs on
   its own card (the thread's current device is the shard's) and equals a
   direct call on that shard under seed + i bit for bit; ms against the
   same decode of 1024 syndromes on one card;
3. ``python -m mcmc_qec_tpu_torch generate --distributed``, one rank per
   card, for 1, 2 and R ranks: PTEQ at the production shape (toric d=5,
   B=2048, p=0.15, iters=2, window=600, max_steps=24000) with one batch of
   2048 a rank, and STDC at the bench-key shape with 1024 points a rank.
   Each merged file equals the ranks' ``generate`` runs (seed + r) in
   process bit for bit; every rank ran on a card of its own and allocated
   on no other; the launches per rank; the merged syn/s over the ranks'
   span against one process's ``generate`` of the same points on one card.

The ranks are ``chip_smoke.py --rank-worker`` processes (a warm-up on the
rank's card, then the counts and the span of its ``distributed_generate``
call).  One line per part; exits 1 on a failed check, else prints the
card's name and power limit and the device record last.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from mcmc_qec_tpu_torch.decoders import STDC
from mcmc_qec_tpu_torch.graft_entry import dryrun_multichip
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.models.noise import sample_depolarizing
from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts
from mcmc_qec_tpu_torch.ops.sweep import sweep_counts
from mcmc_qec_tpu_torch.parallel import make_mesh, map_shards, shard_batch
from mcmc_qec_tpu_torch.pipeline import Dataset, RunConfig, generate

check = cs.check
PTEQ_M = cs.DIST_PTEQ
STDC_M = cs.DIST_STDC


def part_dryrun(R: int) -> str:
    ladder_window_counts.reset()
    sweep_counts.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(R)
    k2, k1 = ladder_window_counts.launches, sweep_counts.launches
    plain = ladder_window_counts.plain_calls + sweep_counts.plain_calls
    check(k2 == R and k1 == R and plain == 0,
          f"dry run: K2 {k2}, K1 {k1} launches, {plain} plain calls")
    return f"1 {buf.getvalue().strip()} ({k2} K2, {k1} K1 launches)"


def part_mesh(R: int) -> str:
    m = STDC_M
    spec = get_spec("toric", m["d"])
    B = m["B"] * R
    gen = torch.Generator().manual_seed(m["seed"])
    states = sample_depolarizing(gen, spec, m["p"], (B,)).numpy()
    placed = {}

    def decode(shard, seed):
        placed[seed] = (torch.cuda.current_device(), shard.device.index)
        return STDC(spec, shard, m["p"], m["p_sampling"],
                    droplets=m["droplets"], steps=m["steps"], seed=seed,
                    device=shard.device)

    mesh = make_mesh()
    check(mesh.size == R, f"mesh of {mesh.size} cards, {R} present")
    map_shards(decode, shard_batch(states, mesh), 100)  # warm-up, each card
    sweep_counts.reset()
    got, dt = cs._sync_time(lambda: map_shards(
        decode, shard_batch(states, mesh), 7))
    k1 = sweep_counts.launches
    check(sorted(placed[7 + i] for i in range(R)) == [(i, i) for i in
                                                      range(R)],
          f"shards ran on {placed}")
    check(k1 == R, f"{k1} K1 launches over {R} shards")
    one_card = torch.as_tensor(states[:m["B"]], device="cuda:0")
    _, dt1 = cs._sync_time(lambda: decode(one_card, 7))
    shards = shard_batch(states, mesh)

    def in_turn():
        out = []
        for i, shard in enumerate(shards):
            with torch.cuda.device(i):
                out.append(decode(shard, 7 + i))
        return out

    direct, dt_turn = cs._sync_time(in_turn)
    for i in range(R):
        sl = slice(i * m["B"], (i + 1) * m["B"])
        check(np.array_equal(got[sl], direct[i]),
              f"shard {i} differs from its direct call")
    return (f"2 STDC toric d={m['d']} B={m['B']} a card over the mesh of "
            f"{R} cards: each shard on its own card, equal to its direct "
            f"call under seed + i bit for bit, {k1} K1 launches; "
            f"{B / dt:.1f} syn/s ({dt * 1e3:.1f} ms, one thread a card) "
            f"against one card's {m['B'] / dt1:.1f} ({dt1 * 1e3:.1f} ms for "
            f"{m['B']}): {(B / dt) / (m['B'] / dt1):.3f}x; the {R} shards' "
            f"direct calls in turn from one thread {dt_turn * 1e3:.1f} ms")


def _cli_args(method: str, n: int, path: str):
    if method == "PTEQ":
        m = PTEQ_M
        return ["--code", "toric", "--size", m["d"], "--method", "PTEQ",
                "--p-error", m["p"], "--batch", m["B"], "-n", n, "--iters",
                m["iters"], "--window", m["window"], "--max-steps",
                m["max_steps"], "--seed", m["seed"], "--out", path]
    m = STDC_M
    return ["--code", "toric", "--size", m["d"], "--method", "STDC",
            "--p-error", m["p"], "--p-sampling", m["p_sampling"],
            "--droplets", m["droplets"], "--steps", m["steps"], "--batch",
            m["B"], "-n", n, "--seed", m["seed"], "--out", path]


def part_distributed(method: str, ranks: int, tmp: str) -> str:
    m = PTEQ_M if method == "PTEQ" else STDC_M
    per = m["B"]
    n = per * ranks
    path = os.path.join(tmp, f"{method}_{ranks}.npz")
    recs, outs = cs._dist_run(ranks, _cli_args(method, n, path))
    check(f"wrote {n} points" in outs[0], f"rank 0 printed {outs[0][-300:]}")
    devices = [r["device"] for r in recs]
    check(sorted(devices) == list(range(ranks)), f"ranks on cards {devices}")
    for r in recs:
        others = [b for i, b in enumerate(r["peak_by_card"])
                  if i != r["device"]]
        check(not any(others), f"rank on card {r['device']} allocated "
              f"{r['peak_by_card']} bytes by card")
    ds = Dataset.load(path)
    counter = ladder_window_counts if method == "PTEQ" else sweep_counts
    key = "k2" if method == "PTEQ" else "k1"
    parts, direct = cs._per_rank(ds.config, [per] * ranks, counter)
    cs._check_merged(ds, parts, method)
    got = [(r[key], r[key + "_plain"]) for r in recs]
    check(got == direct and all(k > 0 and p == 0 for k, p in got),
          f"{method} ranks' ({key}, plain) {got}, in process {direct}")
    _, dt1 = cs._sync_time(lambda: generate(None, ds.config, n,
                                            progress=None))
    span = cs._span(recs)
    each = ", ".join(f"{r['end'] - r['start']:.3f}" for r in recs)
    return (f"3 {method} generate --distributed, {ranks} rank(s) on cards "
            f"{devices}, {per} points a rank: merged equal to the per-rank "
            f"runs bit for bit, {key} launches per rank "
            f"{[k for k, _ in got]}; merged {n / span:.1f} syn/s over "
            f"{span:.3f} s (ranks {each} s) against one process's generate on one card "
            f"{n / dt1:.1f} ({dt1:.3f} s): {dt1 / span:.3f}x")


def main() -> int:
    t0 = time.time()
    try:
        card = cs.phase_device()
        R = torch.cuda.device_count()
        check(R >= 2, f"{R} card(s): this script needs two or more")
        cs.phase_build()
        print(part_dryrun(R), flush=True)
        print(part_mesh(R), flush=True)
        counts = sorted({1, 2, R})
        with tempfile.TemporaryDirectory() as tmp:
            # one decode of each method on one card first: the in-process
            # comparisons run warm
            for method in ("PTEQ", "STDC"):
                m = PTEQ_M if method == "PTEQ" else STDC_M
                cfg = RunConfig(
                    code="toric", method=method, size=m["d"], p_error=m["p"],
                    batch=cs.DIST_WARM, seed=1, max_steps=1200,
                    iters=m.get("iters", 10), window=m.get("window", 200),
                    p_sampling=m.get("p_sampling"), steps=m.get("steps"),
                    droplets=m.get("droplets", 4))
                generate(None, cfg, cs.DIST_WARM, progress=None)
                for ranks in counts:
                    print(part_distributed(method, ranks, tmp), flush=True)
    except cs.PhaseFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(f"{time.time() - t0:.1f} s; card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
