"""Run the port's studies on NVIDIA GPUs: the threshold grids with
their fits, and the other studies at their defaults.

    python3 chip_studies.py [--out DIR] [--runs depol,eta10,others]
    python3 chip_studies.py --runs scaling      # on a host with 2+ cards
    python3 chip_studies.py --runs compare --out mcmc_qec_tpu_torch/studies/results
    python3 chip_studies.py --runs depol --sizes 13   # one column of a grid

Runs ``mcmc_qec_tpu_torch.studies`` at the sizes of the grids the JAX
package committed under ``examples/``:

- ``depol``: depolarizing PTEQ on toric d = 5, 9, 13, 7, 11 (in that order,
  so a cut run holds d = 5, 9, 13 first) at p = 0.175 ... 0.2125 (six
  points), 2048 syndromes a cell in batches of 512, at the caps recorded in
  ``examples/threshold_grid_r4.json`` (48000 at d = 5 and 7, 50 d^3 from
  d = 9 on), through ``studies.threshold_fit collect``, into
  ``DIR/threshold_grid_h100.json``;
- ``eta10``: ``PTEQ_alpha`` on xzzx d = 5 ... 13 under biased noise at
  eta = 10, the ten p of ``examples/threshold_eta10_r5.json``, 2048 a
  cell, at that file's caps (24000, 15 d^3 at d = 13), through
  ``studies.threshold_fit_biased collect``, into
  ``DIR/threshold_eta10_h100.json``.

Each cell is one call of the study's ``main``: a grid file already in DIR
is resumed, its cells skipped.  Per cell it prints the window kernel's
launches (``ladder_window_counts``), and per grid the seconds; then it
fits each grid (``studies.fss.fit``, 400 bootstrap refits, p0 0.189 and
0.30) into ``DIR/<grid>_fit.json``.

- ``others``: ``stepcap_study``, ``compare_decoders``, ``xzzx_eta_sweep``
  and ``head_to_head --phase ours -n 64`` at their defaults, each with its
  stdout in ``DIR/<study>.txt`` (and its JSON where it writes one);
- ``scaling``: ``scaling_bench`` over 1, 2, 4 and 8 cards, as many as
  there are, its stdout in ``DIR/scaling_bench.txt``;
- ``compare`` (alone, no card needed): each grid in DIR against the TPU's
  cell by cell (also printed after each grid's fit).

``--sizes`` runs only those columns of the grids (no fit: the scaling fit
needs every size), e.g. the depolarizing grid's d=13 column alone.

DIR defaults to ``output/studies``.  The first line is each card as
nvidia-smi names it with its power limit.  Needs a CUDA device, except for
``compare``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types

import torch

from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts
from mcmc_qec_tpu_torch.studies import (
    compare_decoders,
    fss,
    head_to_head,
    scaling_bench,
    stepcap_study,
    threshold_fit,
    threshold_fit_biased,
    xzzx_eta_sweep,
)

DEPOL_PS = (0.175, 0.1825, 0.19, 0.1975, 0.205, 0.2125)
DEPOL_SIZES = (5, 9, 13, 7, 11)
DEPOL_CAP = {5: 48000, 7: 48000}  # else the study's default, 50 d^3
ETA10_PS = (0.2, 0.2125, 0.225, 0.2375, 0.25, 0.2625, 0.275, 0.2875, 0.3,
            0.3125)
ETA10_SIZES = (5, 7, 9, 11, 13)

GRIDS = {
    "depol": dict(file="threshold_grid_h100.json", p0=0.189,
                  tpu="threshold_grid_r4.json"),
    "eta10": dict(file="threshold_eta10_h100.json", p0=0.30,
                  tpu="threshold_eta10_r5.json"),
}
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")


def _cells(grid, sizes=None):
    if grid == "depol":
        for d in sizes or DEPOL_SIZES:
            cap = ["--cap", str(DEPOL_CAP[d])] if d in DEPOL_CAP else []
            for p in DEPOL_PS:
                yield d, p, threshold_fit.main, ["collect", *cap]
    else:
        for d in sizes or ETA10_SIZES:
            for p in ETA10_PS:
                yield d, p, threshold_fit_biased.main, ["collect", "--eta",
                                                         "10"]


def collect(grid, path, sizes=None):
    t0 = time.perf_counter()
    for d, p, main, head in _cells(grid, sizes):
        ladder_window_counts.reset()
        main([*head, "--sizes", str(d), "--ps", str(p), "-n", "2048",
              "--batch", "512", "--data", path, "--device", "cuda"])
        print(f"cell {grid} d={d} p={p}: window kernel launches "
              f"{ladder_window_counts.launches}, plain calls "
              f"{ladder_window_counts.plain_calls}", flush=True)
        if ladder_window_counts.plain_calls:
            raise RuntimeError("a study ran the plain window on the card")
    print(f"grid {grid}: {time.perf_counter() - t0:.1f} s in this run",
          flush=True)


def compare(grid, path):
    """Each cell's failure rate against the TPU grid's cell of the same
    (d, p), in units of the two binomials' standard deviation; prints one
    line a cell and the count beyond 3 sigma."""
    with open(path) as f:
        ours = {(r["d"], r["p"]): r for r in json.load(f)}
    with open(os.path.join(EXAMPLES, GRIDS[grid]["tpu"])) as f:
        tpu = {(r["d"], r["p"]): r for r in json.load(f)}
    zs = []
    for key in sorted(ours):
        a, b = ours[key], tpu[key]
        fa, fb = a["failure_rate"], b["failure_rate"]
        sigma = math.sqrt(fa * (1 - fa) / a["n"] + fb * (1 - fb) / b["n"])
        zs.append((fa - fb) / sigma)
        print(f"{grid} d={key[0]} p={key[1]}: card {fa:.4f} (converged "
              f"{a['converged_frac']:.4f}, {a['seconds']} s) TPU {fb:.4f} "
              f"(converged {b['converged_frac']:.4f}): {zs[-1]:+.2f} sigma")
    print(f"{grid}: {len(zs)} cells, {sum(abs(z) > 3 for z in zs)} beyond 3 "
          f"sigma, {sum(abs(z) > 2 for z in zs)} beyond 2, largest "
          f"{max(abs(z) for z in zs):.2f}, card seconds "
          f"{sum(r['seconds'] for r in ours.values()):.1f}", flush=True)


def others(out):
    """The other studies at their defaults, each timed."""
    runs = {
        "stepcap_study": (stepcap_study.main,
                          ["--out", os.path.join(out, "stepcap_study.json")]),
        "compare_decoders": (compare_decoders.main, []),
        "xzzx_eta_sweep": (xzzx_eta_sweep.main, []),
        "head_to_head": (head_to_head.main,
                         ["--phase", "ours", "-n", "64", "--out",
                          os.path.join(out, "head_to_head.json")]),
    }
    for name, (main, argv) in runs.items():
        run_to_file(out, name, main, argv)


def run_to_file(out, name, main, argv):
    t0 = time.perf_counter()
    with open(os.path.join(out, f"{name}.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        main([*argv, "--device", "cuda"])
    print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/studies")
    ap.add_argument("--runs", default="depol,eta10,others")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated code sizes: the grids' columns to "
                         "run (default: all of each grid's)")
    args = ap.parse_args(argv)
    sizes = args.sizes and [int(d) for d in args.sizes.split(",")]
    if args.runs == "compare":
        for grid, g in GRIDS.items():
            compare(grid, os.path.join(args.out, g["file"]))
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for card in smi.stdout.strip().splitlines():
        print(f"card: {card} | torch {torch.__version__}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    for run in args.runs.split(","):
        if run == "others":
            others(args.out)
            continue
        if run == "scaling":
            run_to_file(args.out, "scaling_bench", scaling_bench.main, [])
            continue
        grid = run
        g = GRIDS[grid]
        path = os.path.join(args.out, g["file"])
        collect(grid, path, sizes)
        if not sizes:  # some columns alone leave the scaling fit nothing to fit
            out = fss.fit(types.SimpleNamespace(data=path, boot=400,
                                                min_converged=0.0,
                                                correction=False, p0=g["p0"]))
            with open(path.replace(".json", "_fit.json"), "w") as f:
                json.dump(out, f, indent=1)
        compare(grid, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
