"""Head-to-head: the port's decoders against the executing reference
implementation's distributions, on a fixed set of d=5 toric syndromes.

The port's copy of ``examples/head_to_head.py`` for ``--phase ours``: it
loads the reference's distributions (two PTEQ runs, STDC and STRC), the
syndromes and the MWPM warm starts from a cache the JAX script's ``--phase
ref`` wrote (``examples/h2h_ref_cache_r5.npz`` by default), runs the
port's PTEQ, STDC, STRC and the literal STDC engine on them, and prints
and writes the script's comparison records: per-syndrome total variation
between estimators, calibrated against the reference's own run-to-run TV,
argmax agreement with its Wilson interval, and truth recovery.  The cache
holds the JAX-sampled syndromes and warm starts, which the port cannot
draw, so the first ``-n`` of them are decoded.  ``--phase ref`` and
``all`` run the executing reference, which is not in the repository, and
raise.

Run:  python -m mcmc_qec_tpu_torch.studies.head_to_head --phase ours -n 64 --out h2h.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..decoders import PTEQ, STDC, STRC
from ..decoders.pteq import PTEQConfig
from ..models import get_spec, np_eq_class
from ..ops.engines import resolve_device

REF_CACHE = Path(__file__).resolve().parents[2] / "examples" / "h2h_ref_cache_r5.npz"


def tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a, float) - np.asarray(b, float)).sum())


def wilson_ci(k, m, z=1.96):
    ph = k / m
    den = 1 + z * z / m
    ctr = (ph + z * z / (2 * m)) / den
    hw = z * np.sqrt(ph * (1 - ph) / m + z * z / (4 * m * m)) / den
    return round(float(ctr - hw), 3), round(float(ctr + hw), 3)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=12, help="syndromes per source")
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--p", type=float, default=0.15)
    ap.add_argument("--stdc-steps", type=int, default=10000)
    ap.add_argument("--stdc-droplets", type=int, default=2)
    ap.add_argument("--skip-literal", action="store_true")
    ap.add_argument("--strc-steps", type=int, default=10000,
                    help="also compare STRC (0 disables)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--phase", choices=["all", "ref", "ours"], default="all")
    ap.add_argument("--ref-cache", default=str(REF_CACHE))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.phase != "ours":
        raise SystemExit(
            f"--phase {args.phase} runs the executing reference "
            f"implementation, which is not in the repository; run --phase "
            f"ours on a cache its --phase ref wrote")
    device = resolve_device(args.device)

    spec = get_spec("toric", args.d)
    cache = np.load(args.ref_cache)
    if args.n > len(cache["states"]) or cache["states"].shape[1] != spec.nq:
        raise ValueError(
            f"the cache holds {cache['states'].shape} syndromes; -n {args.n} "
            f"at d={args.d} needs ({args.n}, {spec.nq})")
    if "budgets" in cache:  # caches from before round 5 lack the field
        budgets = tuple(int(x) for x in cache["budgets"])
        if budgets != (args.stdc_steps, args.stdc_droplets, args.strc_steps):
            raise ValueError(
                f"ref cache budgets {budgets} != this run's "
                f"({args.stdc_steps}, {args.stdc_droplets}, "
                f"{args.strc_steps})")
    n = args.n
    states = cache["states"][:n]
    warm = cache["warm"][:n]
    truth = np_eq_class(spec, states)
    ref_pteq_a = cache["ref_pteq_a"][:n]
    ref_pteq_b = cache["ref_pteq_b"][:n]
    ref_stdc = cache["ref_stdc"][:n]
    ref_strc = cache["ref_strc"][:n] if "ref_strc" in cache else None

    print("this framework: PTEQ (production fused engine)...", flush=True)
    cfg = PTEQConfig(engine="auto", max_steps=48000, window=600, iters=2,
                     energy_chunk=12)
    ours_pteq = PTEQ(spec, states, args.p, cfg, seed=1,
                     device=device).distribution.astype(float)

    print("this framework: STDC (production engine, same warm starts)...",
          flush=True)
    ours_stdc = STDC(spec, warm, args.p, 0.25,
                     droplets=args.stdc_droplets, steps=args.stdc_steps,
                     seed=1, device=device).astype(float)

    ours_strc = None
    if ref_strc is not None:
        print("this framework: STRC (same warm starts)...", flush=True)
        ours_strc = STRC(spec, warm, args.p, 0.25,
                         droplets=args.stdc_droplets,
                         steps=args.strc_steps, seed=1,
                         device=device).astype(float)

    ours_lit = None
    if not args.skip_literal:
        print("this framework: STDC (literal parity engine)...", flush=True)
        ours_lit = STDC(spec, warm, args.p, 0.25,
                        droplets=args.stdc_droplets,
                        steps=min(args.stdc_steps, 4000),
                        engine="literal", seed=1, device=device).astype(float)

    def compare(name, a, b):
        tvs = [tv(a[i] / 100.0, b[i] / 100.0) for i in range(n)]
        agree = int((np.argmax(a, -1) == np.argmax(b, -1)).sum())
        rec = {
            "pair": name,
            "argmax_agree": f"{agree}/{n}",
            "agree_ci95": wilson_ci(agree, n),
            "tv_mean": round(float(np.mean(tvs)), 4),
            "tv_max": round(float(np.max(tvs)), 4),
        }
        print(json.dumps(rec), flush=True)
        return rec

    results = {
        "n": n, "d": args.d, "p": args.p,
        "stdc_steps": args.stdc_steps, "stdc_droplets": args.stdc_droplets,
        "comparisons": [
            compare("ref_PTEQ_A vs ref_PTEQ_B (self)", ref_pteq_a, ref_pteq_b),
            compare("ref_PTEQ vs ours_PTEQ", ref_pteq_a, ours_pteq),
            compare("ref_STDC vs ours_STDC", ref_stdc, ours_stdc),
            compare("ref_PTEQ vs ref_STDC (cross-alg)", ref_pteq_a, ref_stdc),
            compare("ours_PTEQ vs ours_STDC (cross-alg)", ours_pteq, ours_stdc),
        ],
    }
    if ours_strc is not None:
        results["comparisons"].append(
            compare("ref_STRC vs ours_STRC", ref_strc, ours_strc)
        )
        results["comparisons"].append(
            compare("ref_STRC vs ref_STDC (cross-alg)", ref_strc, ref_stdc)
        )
    if ours_lit is not None:
        results["comparisons"].append(
            compare("ref_STDC vs ours_STDC_literal", ref_stdc, ours_lit)
        )
    # ground-truth recovery per estimator (hard syndromes: not all recoverable)
    for nm, d_ in [("ref_PTEQ", ref_pteq_a), ("ours_PTEQ", ours_pteq),
                   ("ref_STDC", ref_stdc), ("ours_STDC", ours_stdc)] + (
                   [("ref_STRC", ref_strc), ("ours_STRC", ours_strc)]
                   if ours_strc is not None else []):
        results[f"correct_{nm}"] = int(
            (np.argmax(d_, -1) == truth).sum()
        )
    print(json.dumps({k: v for k, v in results.items()
                      if k != "comparisons"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
