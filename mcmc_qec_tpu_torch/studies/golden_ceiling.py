"""Golden-corpus recovery CEILING: what fraction of the DRL failure set is
recoverable at a near-reference step budget?

Production replays cap PTEQ at 8k steps (RESULTS.md); the reference's own
budget is 5e7 ladder steps of 10 proposals (decoders.py:25).  This script
runs ONE high-budget PTEQ pass over all 2603 hard d=5 toric syndromes of
the reference's data/drl_failures_p_0.15.xz (default cap 320k steps = 40x
production) and prints recovery %, convergence % and wall time, plus MWPM /
eMWPM context rows from the port's matcher (``matching/``).  The port's
copy of ``examples/golden_ceiling.py``, plus ``--device``; ``--corpus`` is
required (the corpus is not in this repository).  ``main`` reads the
corpus (``pipeline.load_golden_corpus``, which needs pandas) and ``run``
decodes it and prints the script's lines, so a caller holding the
syndromes runs ``run`` without pandas.

Run:  python -m mcmc_qec_tpu_torch.studies.golden_ceiling --corpus drl_failures_p_0.15.xz
      python -m mcmc_qec_tpu_torch.studies.golden_ceiling --corpus drl_failures_p_0.15.xz --limit 256 --cap 32000
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..decoders import PTEQ, PTEQConfig
from ..ops.engines import resolve_device


def run(spec, flat, trues, cap=320_000, engine="auto", iters=2, window=200,
        skip_mwpm=False, device="cuda"):
    """Print the MWPM and eMWPM rows (unless ``skip_mwpm``) and decode
    ``flat`` (N, nq) with one PTEQ pass at ``cap`` steps; returns a dict
    of the MWPM classes (None when skipped) and the ``PTEQResult``."""
    device = resolve_device(device)
    N = len(flat)
    print(f"{N} syndromes, {spec.family} d={spec.size}")

    mw = None
    if not skip_mwpm:
        from ..matching.graph import class_sorted_mwpm_batch, regular_mwpm_batch

        t0 = time.perf_counter()
        mw = regular_mwpm_batch(spec, flat)
        t_mw = time.perf_counter() - t0
        print(f"MWPM : {100 * np.mean(mw == trues):.2f}% in {t_mw:.1f}s")

        if spec.family == "planar":
            # eMWPM: shortest total-length class (generate_data.py:210-220);
            # class-constrained solutions are planar-only, as in the
            # reference (mwpm.py:417-437)
            t0 = time.perf_counter()
            seeds = class_sorted_mwpm_batch(spec, flat)
            em = (seeds != 0).sum(axis=-1).argmin(axis=1)
            t_em = time.perf_counter() - t0
            print(f"eMWPM: {100 * np.mean(em == trues):.2f}% in {t_em:.1f}s")
        else:
            print("eMWPM: n/a (class-constrained MWPM is planar-only, "
                  "mwpm.py:417-437)")

    t0 = time.perf_counter()
    res = PTEQ(
        spec, flat, 0.15,
        PTEQConfig(max_steps=cap, window=window, iters=iters, engine=engine),
        seed=1, device=device,
    )
    dt = time.perf_counter() - t0
    pred = res.distribution.argmax(axis=-1)
    ok = int((pred == trues).sum())
    print(
        f"PTEQ cap={cap} engine={engine}: recovered {ok}/{N} "
        f"({100 * ok / N:.2f}%), converged {100 * res.converged.mean():.1f}%, "
        f"{dt:.1f}s ({N / dt:.1f} syn/s), buckets={res.buckets}"
    )
    return {"mwpm": mw, "pteq": res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True,
                    help="the reference's drl_failures_p_0.15.xz")
    ap.add_argument("--cap", type=int, default=320_000)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--window", type=int, default=200)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--skip-mwpm", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from ..pipeline import load_golden_corpus

    spec, flat, trues = load_golden_corpus(args.corpus)
    if args.limit:
        flat, trues = flat[: args.limit], trues[: args.limit]
    return run(spec, flat, trues, args.cap, args.engine, args.iters,
               args.window, args.skip_mwpm, args.device)


if __name__ == "__main__":
    main()
