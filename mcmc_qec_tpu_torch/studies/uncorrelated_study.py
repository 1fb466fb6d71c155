"""Uncorrelated-noise comparison study, end to end at production scale
(the reference's second generation/analysis pair,
generate_data_noise_models.py:141-153 -> plot_uncorrelated.py:200-301):
MWPM against STDC_general_noise on the planar code under uncorrelated X/Z
noise, over the reference's own p-grid and sizes.

Grid conventions reproduced exactly from the reference's __main__
(generate_data_noise_models.py:198-237): sizes 5 + 2k; p_error =
0.05 + k/180 (a subset of the 32-point grid); p_uncorrelated =
1 - sqrt(1 - p_error); p_xyz = [p(1-p), p^2, p(1-p)]; steps = d^4;
droplets = 1; p_sampling = 0.25; MWPM warm starts (mwpm_init=True).

The port's copy of ``examples/uncorrelated_study.py``: the same flags,
output lines and rows (``examples/uncorrelated_r5.json``'s schema), through
the port's ``pipeline.generate`` and ``evaluate_submethods``, plus
``--device``.  The defaults of ``--data`` and ``--fig`` are files in the
working directory, not the JAX study's committed ones; ``--fig ""`` skips
the figure (matplotlib is imported only to draw it).

Run:   python -m mcmc_qec_tpu_torch.studies.uncorrelated_study \
           --sizes 5,7,9,11,13 --pk 0,4,8,12,16,20,24,28 -n 1024
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def collect(args):
    """Decode every (d, p) cell not yet in ``args.data``, appending one row
    a cell and rewriting the file after each; returns all rows."""
    from ..ops.engines import resolve_device
    from ..pipeline import RunConfig, generate
    from ..pipeline.evaluate import evaluate_submethods

    resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    sizes = [int(s) for s in args.sizes.split(",")]
    pks = [int(k) for k in args.pk.split(",")]
    rows = []
    if os.path.exists(args.data):
        rows = json.load(open(args.data))
    done = {(r["d"], r["p"]) for r in rows}
    for d in sizes:
        for k in pks:
            p = round(0.05 + k / 180.0, 3)
            if (d, p) in done:
                continue
            cfg = RunConfig(
                code="planar", method="uncorrelated_comparison", size=d,
                noise="uncorrelated", p_error=p, p_sampling=0.25,
                droplets=1, steps=int(d**4), mwpm_init=True,
                batch=min(args.batch, args.n), device=args.device,
            )
            path = os.path.join(args.outdir, f"uncorr_d{d}_p{p}.npz")
            t0 = time.perf_counter()
            ds = generate(path, cfg, nbr_datapoints=args.n, progress=None)
            sub = evaluate_submethods(ds)
            rec = {
                "d": d, "p": p, "n": len(ds),
                "steps": cfg.steps,
                "seconds": round(time.perf_counter() - t0, 1),
            }
            for name, res in sub.items():
                rec[f"fail_{name}"] = res.n_failures
                rec[f"rate_{name}"] = round(1.0 - res.success_rate, 5)
            rows.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.data, "w") as f:
                json.dump(rows, f, indent=1)
    return rows


def figure(rows, path):
    """Failure rate against p, MWPM dashed / STDC solid, one ordinal blue
    per size (plot_uncorrelated.py:200-301 curve shapes)."""
    from ..pipeline.plot import _pyplot

    plt = _pyplot()
    ramp = ["#86b6ef", "#5598e7", "#2a78d6", "#1c5cab", "#104281"]
    fig, ax = plt.subplots(figsize=(6.4, 4.4))
    for i, d in enumerate(sorted({r["d"] for r in rows})):
        sub = sorted((r for r in rows if r["d"] == d), key=lambda r: r["p"])
        ps = [r["p"] for r in sub]
        c = ramp[i % len(ramp)]
        ax.plot(ps, [r["rate_STDC"] for r in sub], "o-", color=c,
                label=f"STDC d={d}")
        ax.plot(ps, [r["rate_MWPM"] for r in sub], "s--", color=c,
                alpha=0.55, label=f"MWPM d={d}")
    ax.set_yscale("log")
    ax.set_xlabel("physical error rate p (depolarizing-equivalent)")
    ax.set_ylabel("logical failure rate")
    ax.set_title("Uncorrelated noise: MWPM vs STDC_general_noise (planar)")
    ax.grid(alpha=0.3, which="both")
    ax.legend(fontsize=7, ncol=2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    print(f"wrote {path}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="5,7,9,11,13")
    ap.add_argument("--pk", default="0,4,8,12,16,20,24,28",
                    help="indices k into the reference grid p=0.05+k/180")
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--outdir",
                    default=os.path.join(tempfile.gettempdir(), "uncorr_r5"))
    ap.add_argument("--data", default="uncorrelated_r5.json")
    ap.add_argument("--fig", default="uncorrelated_r5.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = collect(args)
    if args.fig:
        figure(rows, args.fig)
    return rows


if __name__ == "__main__":
    main()
