"""Logical failure-rate curves of STDC.

Decodes batches of sampled syndromes at a grid of physical error rates and
lattice sizes, reporting logical failure rates per (d, p) with Monte-Carlo
error bars.  A correct decoder family shows failure rates that *decrease*
with d below threshold (~0.19 for depolarizing toric MCMC decoding) and
increase above it.  The port's copy of ``examples/failure_rates.py``, plus
``--device``; the syndromes are drawn from a generator on the device seeded
with ``seed`` (the script's ``PRNGKey(seed)``).  On the card the default
engine ``sweep`` runs the whole sampling loop of a decode as one launch of
the sweep kernel's recording sampler.

Run:  python -m mcmc_qec_tpu_torch.studies.failure_rates --sizes 5,7 --ps 0.05,0.10,0.15 -n 256
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..decoders import STDC
from ..models import get_spec, np_eq_class
from ..models.noise import sample_depolarizing
from ..ops.engines import resolve_device


def failure_rate(family, d, p, n, steps, droplets, engine, seed=0,
                 device="cuda"):
    device = resolve_device(device)
    spec = get_spec(family, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = sample_depolarizing(gen, spec, p, (n,))
    truth = np_eq_class(spec, states.cpu().numpy())
    t0 = time.perf_counter()
    distr = STDC(spec, states, p, p_sampling=min(3 * p, 0.4),
                 droplets=droplets, steps=steps, engine=engine, seed=seed,
                 device=device)
    dt = time.perf_counter() - t0
    fails = int((np.argmax(distr, -1) != truth).sum())
    rate = fails / n
    err = np.sqrt(max(rate * (1 - rate), 1e-9) / n)
    return rate, err, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="toric")
    ap.add_argument("--sizes", default="5,7")
    ap.add_argument("--ps", default="0.05,0.10,0.15")
    ap.add_argument("-n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--droplets", type=int, default=4)
    ap.add_argument("--engine", default="sweep")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    sizes = [int(s) for s in args.sizes.split(",")]
    ps = [float(x) for x in args.ps.split(",")]
    results = []
    for d in sizes:
        # sweep budget ~ reference's 5 d^5 proposals / (2 d^2 per sweep)
        steps = args.steps or max(200, int(2.5 * d**3))
        for p in ps:
            rate, err, dt = failure_rate(
                args.family, d, p, args.n, steps, args.droplets, args.engine,
                device=args.device,
            )
            rec = {"family": args.family, "d": d, "p": p, "n": args.n,
                   "steps": steps, "failure_rate": rate, "mc_err": err,
                   "seconds": round(dt, 2)}
            results.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
