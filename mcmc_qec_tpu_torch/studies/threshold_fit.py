"""Threshold estimate with uncertainties: the finite-size-scaling fit of
the PTEQ failure-rate crossing on toric codes under depolarizing noise.

The port's copy of ``examples/threshold_fit.py``: the same subcommands,
flags, output lines and JSON records, plus ``--device`` on ``collect``.
Each batch is drawn on the device from ``sampling.batch_generator(device,
1000 * rep + d, p)`` and decoded with decoder seed ``rep + 1``; the fit is
``fss.fit``.

Usage:
  # collect (runs PTEQ on the card; resumable, appends to --data):
  python -m mcmc_qec_tpu_torch.studies.threshold_fit collect \
      --sizes 5,7,9,11,13 --ps 0.175,0.1825,0.19,0.1975 -n 2048 \
      --data thr.json
  # fit:
  python -m mcmc_qec_tpu_torch.studies.threshold_fit fit --data thr.json
  # on the CPU (the kernels' plain versions), a tiny grid:
  python -m mcmc_qec_tpu_torch.studies.threshold_fit collect --device cpu \
      --sizes 3 --ps 0.1 -n 16 --batch 16 --cap 1200 --data thr.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .fss import _fit_once, fit


def pteq_config(cap: int):
    """The study's PTEQ settings at step cap ``cap`` (Nc = d, the default)."""
    from ..decoders.pteq import PTEQConfig

    return PTEQConfig(engine="auto", max_steps=cap, window=600, iters=2,
                      energy_chunk=12)


def collect(args):
    from ..decoders.pteq import PTEQ
    from ..models import get_spec, np_eq_class
    from ..models.noise import sample_depolarizing
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
        spec = get_spec("toric", d)
        # step cap: scaled with d for >= 90% convergence at threshold
        # (the JAX study's calibration; the reference's convention is
        # proposals ~ 5 d^5, generate_data.py:296)
        cap = args.cap or max(24000, int(args.cap_c * d**3))
        cfg = pteq_config(cap)
        for p in ps:
            B = min(args.batch, args.n)
            n_total = B * (-(-args.n // B))  # the n actually stored
            tag = (d, p, n_total)
            if tag in done:
                continue
            fails = conv = 0
            t0 = time.perf_counter()
            for rep in range(-(-args.n // B)):
                # p is part of the seed: one generator across the p-grid
                # would draw common random numbers along p (correlated
                # points; the bootstrap assumes independence)
                gen = batch_generator(device, 1000 * rep + d, p)
                states = sample_depolarizing(gen, spec, p, (B,))
                truth = np_eq_class(spec, states.cpu().numpy())
                res = PTEQ(spec, states, p, cfg, seed=rep + 1, device=device)
                fails += int(
                    (np.argmax(res.distribution, -1) != truth).sum()
                )
                conv += int(res.converged.sum())
            n = B * (-(-args.n // B))
            rec = {
                "d": d, "p": p, "n": n, "fails": fails,
                "failure_rate": fails / n,
                "mc_err": float(np.sqrt(max(fails / n * (1 - fails / n), 1e-9) / n)),
                "converged_frac": conv / n,
                "cap": cap,
                "seconds": round(time.perf_counter() - t0, 1),
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.data, "w") as f:
                json.dump(results, f, indent=1)


def plot(args):
    """Two-panel threshold figure: failure-rate curves per d with the
    fitted p_th, and the finite-size-scaling data collapse.

    Encoding: d is an ordered magnitude, so it wears a single-hue ordinal
    blue ramp (light -> dark = small -> large d; lightness-monotone, so
    the order survives every color-vision deficiency); identity is
    double-encoded by the legend and the distinct marker per d.  One axis
    per panel; recessive grid; text in ink, not series color.  matplotlib
    is imported here, not with the module."""
    from ..pipeline.plot import _pyplot

    plt = _pyplot()
    results = json.load(open(args.data))
    ds_all = sorted({r["d"] for r in results})
    ramp = ["#86b6ef", "#5598e7", "#2a78d6", "#1c5cab", "#104281",
            "#0d366b"]
    markers = ["o", "s", "D", "^", "v", "P"]
    color = {d: ramp[i % len(ramp)] for i, d in enumerate(ds_all)}
    mark = {d: markers[i % len(markers)] for i, d in enumerate(ds_all)}

    ds = np.array([r["d"] for r in results], float)
    ps = np.array([r["p"] for r in results], float)
    fs = np.array([r["failure_rate"] for r in results], float)
    ns = np.array([r["n"] for r in results], float)
    errs = np.sqrt(np.maximum(fs * (1 - fs), 1.0 / ns) / ns)
    ws = 1.0 / errs
    theta = _fit_once(ds, ps, fs, ws, p0=float(np.median(ps)))
    p_th, inv_nu = float(theta[0]), float(theta[1])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.4), dpi=150)
    ink, muted = "#1a1a1a", "#6b6b6b"
    for ax in (ax1, ax2):
        ax.grid(True, color="#e8e7e4", linewidth=0.8, zorder=0)
        ax.spines[["top", "right"]].set_visible(False)
        ax.tick_params(colors=muted)
    for d in ds_all:
        sel = ds == d
        o = np.argsort(ps[sel])
        ax1.errorbar(ps[sel][o], fs[sel][o], yerr=errs[sel][o],
                     color=color[d], marker=mark[d], ms=4.5, lw=2,
                     capsize=2, label=f"d={d}", zorder=3)
        x = (ps[sel] - p_th) * d**inv_nu
        ax2.errorbar(x[o], fs[sel][o], yerr=errs[sel][o], ls="none",
                     color=color[d], marker=mark[d], ms=5, capsize=2,
                     label=f"d={d}", zorder=3)
    ax1.axvline(p_th, color=muted, lw=1, ls="--", zorder=1)
    ax1.annotate(f"$p_{{th}}$ = {p_th:.4f}", (p_th, ax1.get_ylim()[0]),
                 xytext=(4, 6), textcoords="offset points", color=ink,
                 fontsize=9)
    ax1.set_xlabel("physical error rate p", color=ink)
    ax1.set_ylabel("logical failure rate", color=ink)
    ax1.set_title("PTEQ failure rates near threshold", color=ink,
                  fontsize=11)
    ax1.legend(frameon=False, fontsize=8, loc="upper left")
    xx = np.linspace(min((ps - p_th) * ds**inv_nu),
                     max((ps - p_th) * ds**inv_nu), 100)
    ax2.plot(xx, theta[2] + theta[3] * xx + theta[4] * xx**2,
             color=muted, lw=1, ls="--", zorder=2)
    ax2.set_xlabel(r"$x = (p - p_{th})\,d^{1/\nu}$", color=ink)
    ax2.set_ylabel("logical failure rate", color=ink)
    ax2.set_title(
        rf"data collapse  ($\nu$ = {1.0 / inv_nu:.2f})", color=ink,
        fontsize=11)
    ax2.legend(frameon=False, fontsize=8, loc="upper left")
    fig.tight_layout()
    fig.savefig(args.out)
    print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("--sizes", default="5,7,9,11,13")
    c.add_argument("--ps", default="0.175,0.1825,0.19,0.1975")
    c.add_argument("-n", type=int, default=2048)
    c.add_argument("--batch", type=int, default=512)
    c.add_argument("--cap", type=int, default=None,
                   help="fixed step cap (default: cap_c * d^3)")
    c.add_argument("--cap-c", type=float, default=50.0)
    c.add_argument("--data", required=True)
    c.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    f = sub.add_parser("fit")
    f.add_argument("--data", required=True)
    f.add_argument("--boot", type=int, default=400)
    f.add_argument("--min-converged", type=float, default=0.0)
    f.add_argument("--p0", type=float, default=0.189,
                   help="initial p_th guess (e.g. ~0.3 for biased XZZX)")
    f.add_argument("--correction", action="store_true",
                   help="add the leading D/d correction-to-scaling term")
    pl = sub.add_parser("plot")
    pl.add_argument("--data", required=True)
    pl.add_argument("--out", default="threshold.png")
    args = ap.parse_args(argv)
    if args.cmd == "collect":
        collect(args)
    elif args.cmd == "plot":
        plot(args)
    else:
        fit(args)


if __name__ == "__main__":
    main()
