"""The finite-size-scaling fit of a failure-rate grid.

The port's copy of ``examples/threshold_fit.py``'s estimator
(``_fit_once``, ``fit``, ``_model``), unchanged: near threshold the logical
failure rate obeys

    f(p, d) = A + B x + C x^2,     x = (p - p_th) d^(1/nu)

(quadratic expansion of the universal scaling function; e.g. Wang,
Harrington & Preskill 2003 for the toric-code random-bond mapping).
(p_th, nu, A, B, C) are fitted by weighted least squares over a (d, p) grid
with binomial errors, and p_th +/- CI comes from a parametric bootstrap.
Deterministic numpy/scipy: on the same grid it returns the script's dict
exactly (tests/test_torch_studies_fit.py).  It reads the JSON records that
both packages' threshold studies write.
"""

from __future__ import annotations

import json

import numpy as np


def _fit_once(ds, ps, fs, ws, correction=False, p0=0.189):
    """Weighted LS fit of (p_th, nu, A, B, C[, D]); with ``correction`` the
    model adds the leading non-universal finite-size term D d^-1 (cf. the
    correction-to-scaling treatment in Wang-Harrington-Preskill 2003)."""
    from scipy.optimize import least_squares

    def resid(theta):
        p_th, inv_nu, A, B, C = theta[:5]
        x = (ps - p_th) * ds**inv_nu
        model = A + B * x + C * x**2
        if correction:
            model = model + theta[5] / ds
        return (model - fs) * ws

    th0 = [p0, 1.0 / 1.5, np.mean(fs), 1.0, 0.0]
    if correction:
        th0.append(0.0)
    sol = least_squares(resid, np.array(th0), method="lm", max_nfev=20000)
    return sol.x


def fit(args):
    """Fit the grid at ``args.data`` (``boot``, ``min_converged``,
    ``correction`` and optionally ``p0`` from ``args``); prints and returns
    the result dict."""
    results = json.load(open(args.data))
    if args.min_converged:
        results = [r for r in results
                   if r.get("converged_frac", 1.0) >= args.min_converged]
    ds = np.array([r["d"] for r in results], float)
    ps = np.array([r["p"] for r in results], float)
    fs = np.array([r["failure_rate"] for r in results], float)
    ns = np.array([r["n"] for r in results], float)
    # variance floor ~ binomial zero-count scale 1/n (a fixed 1e-9 floor
    # would give zero-failure points ~10^4x the weight of typical ones)
    errs = np.sqrt(np.maximum(fs * (1 - fs), 1.0 / ns) / ns)
    ws = 1.0 / errs
    p0 = getattr(args, "p0", 0.189)
    theta = _fit_once(ds, ps, fs, ws, correction=args.correction, p0=p0)
    p_th, inv_nu = theta[0], theta[1]
    # parametric bootstrap: resample each point from Binomial(n, f_fit-ish)
    rng = np.random.RandomState(0)
    boots = []
    for _ in range(args.boot):
        fb = rng.binomial(ns.astype(int), np.clip(fs, 1e-6, 1 - 1e-6)) / ns
        try:
            tb = _fit_once(ds, ps, fb, ws, correction=args.correction, p0=p0)
            if abs(tb[0] - theta[0]) < 0.1:
                boots.append(tb[:2])
        except Exception:
            pass
    boots = np.array(boots)
    nu = 1.0 / inv_nu
    if len(boots):
        lo, hi = np.percentile(boots[:, 0], [2.5, 97.5])
        nus = 1.0 / boots[:, 1]
        nlo, nhi = np.percentile(nus, [2.5, 97.5])
    else:  # every bootstrap refit failed: report the point estimate only
        lo = hi = p_th
        nlo = nhi = nu
    n_par = 6 if args.correction else 5
    out = {
        "p_th": round(float(p_th), 5),
        "p_th_ci95": [round(float(lo), 5), round(float(hi), 5)],
        "nu": round(float(nu), 3),
        "nu_ci95": [round(float(nlo), 3), round(float(nhi), 3)],
        "correction": bool(args.correction),
        "n_points": len(results),
        "n_boot_ok": len(boots),
        "residual_chi2_per_dof": round(
            float(np.sum(((_model(theta, ds, ps) - fs) * ws) ** 2)
                  / max(len(fs) - n_par, 1)), 2),
    }
    print(json.dumps(out, indent=1))
    return out


def _model(theta, ds, ps):
    p_th, inv_nu, A, B, C = theta[:5]
    x = (ps - p_th) * ds**inv_nu
    model = A + B * x + C * x**2
    if len(theta) > 5:
        model = model + theta[5] / ds
    return model
