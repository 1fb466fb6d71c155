"""The port's depolarizing threshold study against the JAX package at
toric d=3, p=0.1: on the JAX script's own sampled syndromes (its key for
rep 0) the port's PTEQ at the study's settings calls the exact posterior's
class, and the JAX script's ``collect`` gives the port's failure rate
within the two binomials' noise."""

import contextlib
import importlib.util
import io
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcmc_qec_tpu.decoders.exact import exact_mld
from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample
from mcmc_qec_tpu_torch.decoders import PTEQ
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.studies import threshold_fit

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
D, P, N = 3, 0.1, 64
# At the study's settings (iters=2, Nc = d = 3 rungs, TOPS=10) both
# packages call the exact argmax on 56-58 of these 64 syndromes (JAX's PTEQ:
# 56 at caps 1200 and 2400, 58 at 24000; the port: 54, 57, 58 at those caps,
# 58 at 6000); 6000 steps keep the test short.
EXACT_CAP = 6000
MIN_AGREE = 0.90
# the failure-rate comparison: |f_jax - f_port| within 4 sigma of the two
# binomials at n = 64 each
COLLECT_CAP = 1200
MAX_SIGMA = 4.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script_states(rep=0):
    key = jax.random.fold_in(jax.random.PRNGKey(1000 * rep + D),
                             int(round(P * 100000)))
    return np.array(jax_sample(key, jax_get_spec("toric", D), P, (N,)))


def test_argmax_agrees_with_exact_on_jax_script_states():
    states = _jax_script_states()
    exact = exact_mld(jax_get_spec("toric", D), states,
                      np.asarray(betas_depolarizing(P)))
    res = PTEQ(get_spec("toric", D), states, P,
               threshold_fit.pteq_config(EXACT_CAP), seed=1, device="cpu")
    agree = float(np.mean(res.distribution.argmax(-1) == exact.argmax(-1)))
    assert agree >= MIN_AGREE, agree


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "threshold_fit_script", EXAMPLES / "threshold_fit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_script_collect_matches_port(tmp_path):
    settings = dict(sizes=str(D), ps=str(P), n=N, batch=N, cap=COLLECT_CAP,
                    cap_c=50.0)
    with contextlib.redirect_stdout(io.StringIO()):
        _load_script().collect(types.SimpleNamespace(
            data=str(tmp_path / "jax.json"), **settings))
        threshold_fit.collect(types.SimpleNamespace(
            data=str(tmp_path / "port.json"), device="cpu", **settings))
    (a,), (b,) = (json.loads((tmp_path / f"{w}.json").read_text())
                  for w in ("jax", "port"))
    assert (a["d"], a["p"], a["n"], a["cap"]) == (b["d"], b["p"], b["n"],
                                                  b["cap"])
    fa, fb = a["failure_rate"], b["failure_rate"]
    sigma = np.sqrt(max(fa * (1 - fa), 1.0 / N) / N
                    + max(fb * (1 - fb), 1.0 / N) / N)
    assert abs(fa - fb) <= MAX_SIGMA * sigma, (a, b)
