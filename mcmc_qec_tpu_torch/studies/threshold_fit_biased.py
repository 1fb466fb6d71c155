"""Biased-noise XZZX threshold grid: for a fixed bias eta, biased noise
(p, eta) is sampled per qubit and decoded as its alpha equivalent
(pz_tilde, alpha) with ``PTEQ_alpha`` on the XZZX code (as the reference's
generate_data.py:147-150 does; ``models.noise.biased_alpha_equivalent``).

The port's copy of ``examples/threshold_fit_biased.py``: the same flags,
output lines and JSON records (those of ``threshold_fit``, plus eta,
pz_tilde and alpha), plus ``--device``.  Each batch is drawn on the device
from ``sampling.batch_generator(device, 7000 * rep + 31 * d, p)`` and
decoded with decoder seed ``rep + 1``.  The grid is fitted by the shared
finite-size-scaling fit (``fss.fit``):

  python -m mcmc_qec_tpu_torch.studies.threshold_fit_biased collect \
      --eta 10 --sizes 5,7,9,11,13 --ps 0.28,0.30 -n 2048 --data thr_eta10.json
  python -m mcmc_qec_tpu_torch.studies.threshold_fit fit \
      --data thr_eta10.json --p0 0.30
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .threshold_fit import pteq_config


def collect(args):
    from ..decoders.pteq import PTEQ_alpha
    from ..models import get_spec, np_eq_class
    from ..models.noise import (
        biased_alpha_equivalent,
        sample_xyz,
        xyz_probs_from_biased,
    )
    from ..ops.engines import resolve_device
    from .sampling import batch_generator

    device = resolve_device(args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    ps = [float(x) for x in args.ps.split(",")]
    done = {}
    results = []
    if os.path.exists(args.data):
        results = json.load(open(args.data))
        done = {(r["d"], r["p"], r["n"]) for r in results}
    for d in sizes:
        spec = get_spec("xzzx", d)
        # d-scaled step cap, same convention as the depolarizing study;
        # converged_frac is recorded per point regardless
        cap = args.cap or max(24000, int(args.cap_c * d**3))
        cfg = pteq_config(cap)
        for p in ps:
            B = min(args.batch, args.n)
            n_total = B * (-(-args.n // B))
            tag = (d, p, n_total)
            if tag in done:
                continue
            px, py, pz = xyz_probs_from_biased(p, args.eta)
            pz_tilde, alpha = biased_alpha_equivalent(p, args.eta)
            fails = conv = 0
            t0 = time.perf_counter()
            for rep in range(-(-args.n // B)):
                # p is part of the seed: one generator across the p-grid
                # would draw common random numbers along p, correlating
                # the fit's points (the bootstrap assumes independence)
                gen = batch_generator(device, 7000 * rep + 31 * d, p)
                states = sample_xyz(gen, spec, px, py, pz, (B,))
                truth = np_eq_class(spec, states.cpu().numpy())
                res = PTEQ_alpha(spec, states, pz_tilde, alpha, cfg,
                                 seed=rep + 1, device=device)
                fails += int(
                    (np.argmax(res.distribution, -1) != truth).sum()
                )
                conv += int(res.converged.sum())
            rec = {
                "d": d, "p": p, "n": n_total, "eta": args.eta,
                "pz_tilde": round(pz_tilde, 6), "alpha": round(alpha, 6),
                "fails": fails,
                "failure_rate": fails / n_total,
                "mc_err": float(np.sqrt(
                    max(fails / n_total * (1 - fails / n_total), 1e-9)
                    / n_total
                )),
                "converged_frac": conv / n_total,
                "cap": cap,
                "seconds": round(time.perf_counter() - t0, 1),
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.data, "w") as f:
                json.dump(results, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("--eta", type=float, default=10.0)
    c.add_argument("--sizes", default="5,7,9,11,13")
    c.add_argument("--ps", required=True)
    c.add_argument("-n", type=int, default=2048)
    c.add_argument("--batch", type=int, default=512)
    c.add_argument("--cap", type=int, default=0)
    c.add_argument("--cap-c", type=float, default=15.0)
    c.add_argument("--data", required=True)
    c.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    c.set_defaults(fn=collect)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
