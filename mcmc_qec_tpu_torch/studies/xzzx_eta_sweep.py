"""XZZX biased-noise failure-rate scan (the reference's
decoders_biasednoise.py __main__ experiment, 240-277), batched.

For a fixed bias eta, sweep the physical error rate and report the logical
failure rate of ``PTEQ_alpha`` on the XZZX code (biased noise converted to
its alpha-equivalent parameters as in generate_data.py:147-150), one JSON
line a point.  The port's copy of ``examples/xzzx_eta_sweep.py``, plus
``--device``; the i-th point's syndromes are drawn from a generator on the
device seeded with i (the script's ``PRNGKey(i)``).

Run:  python -m mcmc_qec_tpu_torch.studies.xzzx_eta_sweep --eta 10 --size 5 -n 128
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..decoders import PTEQ_alpha, PTEQConfig
from ..models import get_spec, np_eq_class
from ..models.noise import biased_alpha_equivalent, sample_xyz, xyz_probs_from_biased
from ..ops.engines import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--eta", type=float, default=10.0)
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--ps", default="0.05,0.10,0.15,0.20,0.25,0.30")
    ap.add_argument("-n", type=int, default=128)
    ap.add_argument("--max-steps", type=int, default=6000)
    ap.add_argument("--engine", default="fused")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = get_spec("xzzx", args.size)
    for i, p in enumerate(float(x) for x in args.ps.split(",")):
        px, py, pz = xyz_probs_from_biased(p, args.eta)
        gen = torch.Generator(device=device).manual_seed(i)
        states = sample_xyz(gen, spec, px, py, pz, (args.n,))
        truth = np_eq_class(spec, states.cpu().numpy())
        pz_tilde, alpha = biased_alpha_equivalent(p, args.eta)
        t0 = time.perf_counter()
        res = PTEQ_alpha(
            spec, states, pz_tilde, alpha,
            PTEQConfig(max_steps=args.max_steps, window=200, iters=2,
                       engine=args.engine),
            seed=i, device=device,
        )
        dt = time.perf_counter() - t0
        fails = int((np.argmax(res.distribution, -1) != truth).sum())
        print(json.dumps({
            "eta": args.eta, "p": p, "n": args.n,
            "failure_rate": fails / args.n,
            "converged": int(res.converged.sum()),
            "seconds": round(dt, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
