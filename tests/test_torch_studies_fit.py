"""The port's finite-size-scaling fit (``mcmc_qec_tpu_torch.studies.fss``)
against ``examples/threshold_fit.py``'s: the same dict, exactly, on every
committed threshold grid; RESULTS.md's depolarizing threshold from the
committed grid at the script's default bootstrap; and the synthetic
recovery of tests/test_threshold_fit.py through both fits."""

import contextlib
import importlib.util
import io
import json
import types
from pathlib import Path

import numpy as np
import pytest

from mcmc_qec_tpu_torch.studies import fss

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
RESULTS = (Path(__file__).resolve().parents[1] / "mcmc_qec_tpu_torch"
           / "studies" / "results")
# grid -> the p0 its fit starts from (biased XZZX crossings sit near 0.3)
GRIDS = {
    "threshold_grid_r4": 0.189,
    "threshold_eta10_r5": 0.30,
    "threshold_eta10_r5b": 0.30,
    "threshold_eta10_r5_pooled": 0.30,
    "threshold_eta3_r5": 0.189,
    "threshold_eta05_r5": 0.189,
}
# (correction, min_converged) at boot=50
CASES = {"plain": (False, 0.0), "correction": (True, 0.0),
         "min_converged": (False, 0.95)}


def _load_script():
    path = EXAMPLES / "threshold_fit.py"
    spec = importlib.util.spec_from_file_location("threshold_fit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _load_script()
FITS = {"jax_script": SCRIPT.fit, "port": fss.fit}


def _quiet(fn, args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(args)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("grid", GRIDS)
def test_fit_equals_script_on_committed_grid(grid, case):
    correction, min_conv = CASES[case]
    args = types.SimpleNamespace(data=str(EXAMPLES / f"{grid}.json"), boot=50,
                                 min_converged=min_conv,
                                 correction=correction, p0=GRIDS[grid])
    ours, theirs = _quiet(fss.fit, args), _quiet(SCRIPT.fit, args)
    assert ours == theirs
    assert ours["n_boot_ok"] > 0


# the card's grids (chip_studies.py) -> the p0 their fit starts from
CARD_GRIDS = {"threshold_grid_h100": 0.189, "threshold_eta10_h100": 0.30}


@pytest.mark.parametrize("grid", CARD_GRIDS)
def test_card_grid_fit_committed_and_read_by_script(grid):
    """The JAX script's fit reads the card's grid and gives the port's dict,
    which is the committed fit beside the grid (400 refits)."""
    args = types.SimpleNamespace(data=str(RESULTS / f"{grid}.json"), boot=400,
                                 min_converged=0.0, correction=False,
                                 p0=CARD_GRIDS[grid])
    ours = _quiet(fss.fit, args)
    assert ours == _quiet(SCRIPT.fit, args)
    assert ours == json.loads((RESULTS / f"{grid}_fit.json").read_text())


def test_fit_gives_results_md_threshold():
    """RESULTS.md: p_th = 0.1946 (95% CI 0.1920-0.1972) from the committed
    30-point grid at the script's default 400 bootstrap refits."""
    args = types.SimpleNamespace(
        data=str(EXAMPLES / "threshold_grid_r4.json"), boot=400,
        min_converged=0.0, correction=False)
    out = _quiet(fss.fit, args)
    assert out == _quiet(SCRIPT.fit, args)
    assert round(out["p_th"], 4) == 0.1946
    assert [round(x, 4) for x in out["p_th_ci95"]] == [0.1920, 0.1972]
    assert out["n_points"] == 30 and out["n_boot_ok"] == 400


def _synth(tmp_path, p_th=0.189, nu=1.5, n=2048, seed=1):
    rng = np.random.RandomState(seed)
    recs = []
    for d in (5, 7, 9, 11, 13):
        for p in (0.175, 0.1825, 0.19, 0.1975, 0.205):
            x = (p - p_th) * d ** (1.0 / nu)
            f = np.clip(0.45 + 1.3 * x + 0.8 * x * x, 1e-4, 1 - 1e-4)
            k = int(rng.binomial(n, f))
            recs.append({"d": d, "p": p, "n": n, "fails": k,
                         "failure_rate": k / n, "mc_err": 0.01,
                         "converged_frac": 1.0})
    path = tmp_path / "synth.json"
    path.write_text(json.dumps(recs))
    return str(path)


@pytest.mark.parametrize("impl", FITS)
def test_fit_recovers_synthetic_threshold(tmp_path, impl):
    data = _synth(tmp_path)
    args = types.SimpleNamespace(data=data, boot=100, min_converged=0.0,
                                 correction=False)
    out = _quiet(FITS[impl], args)
    assert abs(out["p_th"] - 0.189) < 0.004, out
    lo, hi = out["p_th_ci95"]
    assert lo <= 0.189 <= hi or abs(out["p_th"] - 0.189) < 0.003
    assert 1.0 < out["nu"] < 2.2


@pytest.mark.parametrize("impl", FITS)
def test_fit_zero_failure_point_not_overweighted(tmp_path, impl):
    """A zero-failure point must not act as a near-hard constraint (the
    binomial variance floor is 1/n, not a fixed epsilon)."""
    data = _synth(tmp_path, seed=2)
    recs = json.loads(Path(data).read_text())
    recs.append({"d": 13, "p": 0.05, "n": 2048, "fails": 0,
                 "failure_rate": 0.0, "mc_err": 0.0005,
                 "converged_frac": 1.0})
    Path(data).write_text(json.dumps(recs))
    args = types.SimpleNamespace(data=data, boot=50, min_converged=0.0,
                                 correction=False)
    out = _quiet(FITS[impl], args)
    assert abs(out["p_th"] - 0.189) < 0.01, out
