"""Golden-corpus replay: decode the reference's hard-syndrome set.

The reference's data/drl_failures_p_0.15.xz holds 2603 d=5 toric syndromes
on which a trained deep-RL decoder failed at p=0.15.  Replaying them
measures how much of the DRL decoder's failure set the MCMC decoders
recover.  The port's copy of ``examples/golden_replay.py``, plus
``--device``; ``--corpus`` is required (the corpus is not in this
repository).  ``main`` reads the corpus (``pipeline.load_golden_corpus``,
which needs pandas) and ``run`` decodes it and prints the script's lines,
so a caller holding the syndromes runs ``run`` without pandas.

Run:  python -m mcmc_qec_tpu_torch.studies.golden_replay --corpus drl_failures_p_0.15.xz --decoder PTEQ --limit 256
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..decoders import PTEQ, STDC, PTEQConfig
from ..ops.engines import resolve_device


def run(spec, flat, trues, decoder="PTEQ", limit=256, steps=8000,
        droplets=8, engine="fused", device="cuda"):
    """Decode the first ``limit`` syndromes of ``flat`` (N, nq) with
    ``decoder`` and print the script's lines; returns (recovered, N)."""
    device = resolve_device(device)
    states, truth = flat[:limit], trues[:limit]
    N = len(states)
    t0 = time.perf_counter()
    if decoder == "STDC":
        distr = STDC(spec, states, 0.15, 0.40, droplets=droplets, steps=steps,
                     engine=engine, device=device)
    else:
        # the production-recorded configuration (RESULTS.md)
        res = PTEQ(
            spec, states, 0.15,
            PTEQConfig(max_steps=steps, window=600, iters=2, energy_chunk=12,
                       engine=engine),
            device=device,
        )
        distr = res.distribution
        print(f"converged: {int(res.converged.sum())}/{N}")
    dt = time.perf_counter() - t0
    ok = int((np.argmax(distr, -1) == truth).sum())
    print(f"{decoder}: recovered {ok}/{N} ({100*ok/N:.1f}%) of the DRL "
          f"failure set in {dt:.1f}s")
    return ok, N


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True,
                    help="the reference's drl_failures_p_0.15.xz")
    ap.add_argument("--decoder", default="PTEQ", choices=["PTEQ", "STDC"])
    ap.add_argument("--limit", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--droplets", type=int, default=8)
    ap.add_argument("--engine", default="fused")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..pipeline import load_golden_corpus

    spec, flat, trues = load_golden_corpus(args.corpus)
    return run(spec, flat, trues, args.decoder, args.limit, args.steps,
               args.droplets, args.engine, args.device)


if __name__ == "__main__":
    main()
