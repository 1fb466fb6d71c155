"""The port's metrics (utils/metrics.py, a numpy-only copy of the JAX
package's) and their plumbing through PTEQ and STDC, on the CPU: the
functions equal the JAX ones on the same arrays, the decoders emit the
JAX package's records with the JAX field names (tests/
test_metrics_plumbing.py:26-85), and metrics do not perturb results.
"""

import json

import numpy as np
import pytest
import torch

import jax

from mcmc_qec_tpu.decoders import PTEQ as jax_PTEQ
from mcmc_qec_tpu.decoders import PTEQConfig as JaxPTEQConfig
from mcmc_qec_tpu.decoders import STDC as jax_STDC
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu.utils import metrics as jm
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, STDC, PTEQConfig
from mcmc_qec_tpu_torch.decoders.stdc import _class_seeds, _get_stdc_fn, _get_stdc_stream_fn
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.utils import metrics as tm


def _read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _states(d, B, seed, p):
    jspec = jax_get_spec("toric", d)
    s = np.array(jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec,
                                         p, (B,)))
    return jspec, spec_from_jax(jspec), s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_functions_equal_jax(seed):
    rng = np.random.RandomState(seed)
    # an autocorrelated trace, a short one, a constant one
    x = np.cumsum(rng.normal(size=400)) * 0.1 + rng.normal(size=400)
    for trace, lag in ((x, None), (x, 20), (x[:3], None), (np.ones(50), None)):
        assert tm.effective_sample_size(trace, lag) == \
            jm.effective_sample_size(trace, lag)
    flags = rng.randint(0, 3, size=(60, 5))
    np.testing.assert_array_equal(tm.swap_acceptance_from_traces(flags),
                                  jm.swap_acceptance_from_traces(flags))
    first = rng.uniform(size=300) < 0.3
    np.testing.assert_array_equal(tm.unique_discovery_curve(first),
                                  jm.unique_discovery_curve(first))
    lm = dict(swap_accept_rate=rng.uniform(size=4), tops0_rate=0.25,
              energy_ess=12.5, steps=600)
    assert tm.LadderMetrics(**lm).to_json() == jm.LadderMetrics(**lm).to_json()
    for o in (np.int32(3), np.float32(0.5), np.arange(3)):
        assert tm._np_default(o) == jm._np_default(o)
    with pytest.raises(TypeError):
        tm._np_default(object())


def test_logger_writes_what_jax_writes(tmp_path):
    fields = dict(a=np.int64(2), b=np.float32(0.25), c=np.arange(3), d="x")
    recs = []
    for mod, name in ((tm, "port"), (jm, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        log = mod.MetricsLogger(path)
        log.log("ev", **fields)
        log.close()
        (rec,) = _read(path)
        rec.pop("ts")
        recs.append(rec)
    assert recs[0] == recs[1] == dict(event="ev", a=2, b=0.25, c=[0, 1, 2],
                                      d="x")


def _pteq_records(tmp_path, spec, s):
    path = str(tmp_path / "p.jsonl")
    logger = tm.MetricsLogger(path)
    cfg = PTEQConfig(Nc=3, max_steps=300, window=100, iters=2)
    res = PTEQ(spec, s, 0.08, cfg, seed=1, metrics=logger, device="cpu")
    logger.close()
    return res, [r for r in _read(path) if r["event"] == "pteq_window"]


def test_pteq_emits_window_metrics_with_jax_fields(tmp_path):
    jspec, spec, s = _states(3, 8, 0, 0.08)
    res, recs = _pteq_records(tmp_path, spec, s)
    assert [r["window"] for r in recs] == list(range(len(recs)))
    assert len(recs) >= 1
    for r in recs:
        assert len(r["swap_accept_rate"]) == 2  # Nc - 1 rung pairs
        assert all(0.0 <= a <= 1.0 for a in r["swap_accept_rate"])
        assert 0.0 <= r["tops0_rate"] <= 1.0
        assert r["energy_ess_per_window"] > 0
        assert r["batch_rows"] == 8
        assert r["steps_done"] == 100 * (r["window"] + 1)
    assert max(recs[-1]["swap_accept_rate"]) > 0.05
    assert res.distribution.shape == (8, spec.n_classes)
    # the JAX package's record on the same syndromes has the same fields
    path = str(tmp_path / "j.jsonl")
    logger = jm.MetricsLogger(path)
    jax_PTEQ(jspec, s, 0.08, JaxPTEQConfig(Nc=3, engine="sweep", max_steps=300,
                                           window=100, iters=2),
             seed=1, metrics=logger)
    logger.close()
    theirs = [r for r in _read(path) if r["event"] == "pteq_window"]
    assert theirs and set(theirs[0]) == set(recs[0])


def test_pteq_metrics_do_not_perturb_results(tmp_path):
    _, spec, s = _states(3, 4, 2, 0.08)
    cfg = PTEQConfig(Nc=3, max_steps=200, window=100, iters=2)
    base = PTEQ(spec, s, 0.08, cfg, seed=3, device="cpu")
    logger = tm.MetricsLogger(str(tmp_path / "m.jsonl"))
    with_m = PTEQ(spec, s, 0.08, cfg, seed=3, metrics=logger, device="cpu")
    logger.close()
    np.testing.assert_array_equal(base.distribution, with_m.distribution)
    np.testing.assert_array_equal(base.steps, with_m.steps)


@pytest.mark.parametrize("stream", [False, True])
def test_stdc_emits_discovery_metrics_with_jax_fields(tmp_path, stream):
    jspec, spec, s = _states(3, 4, 1, 0.1)
    path = str(tmp_path / "s.jsonl")
    logger = tm.MetricsLogger(path)
    distr = STDC(spec, s, 0.1, 0.25, droplets=2, steps=150, seed=0,
                 metrics=logger, stream=stream, stream_window=64,
                 device="cpu")
    logger.close()
    (r,) = [r for r in _read(path) if r["event"] == "stdc_run"]
    assert r["n_samples"] == 300 and r["droplets"] == 2
    assert 1 <= r["unique_min"] <= r["unique_mean"] <= r["unique_max"] <= 300
    assert 0.0 <= r["late_discovery_mean"] <= r["late_discovery_max"] <= 1.0
    assert r["overflow_rows"] == 0
    assert distr.shape == (4, spec.n_classes)
    path = str(tmp_path / "j.jsonl")
    logger = jm.MetricsLogger(path)
    jax_STDC(jspec, s, 0.1, 0.25, droplets=2, steps=150, seed=0,
             engine="sweep", metrics=logger, stream=stream)
    logger.close()
    (theirs,) = [r for r in _read(path) if r["event"] == "stdc_run"]
    assert set(theirs) == set(r)


@pytest.mark.parametrize("stream", [False, True])
def test_stdc_metrics_do_not_perturb_results(tmp_path, stream):
    _, spec, s = _states(3, 4, 1, 0.1)
    kw = dict(droplets=2, steps=150, seed=0, stream=stream, stream_window=64,
              device="cpu")
    base = STDC(spec, s, 0.1, 0.25, **kw)
    logger = tm.MetricsLogger(str(tmp_path / "s.jsonl"))
    with_m = STDC(spec, s, 0.1, 0.25, metrics=logger, **kw)
    logger.close()
    np.testing.assert_array_equal(base, with_m)


def test_streamed_unique_count_equals_materialised():
    """With no overflow the stream's n_unique is the materialised path's
    u_tot: both count the distinct chains of the same samples."""
    _, spec, s = _states(3, 3, 4, 0.1)
    cs = _class_seeds(spec, torch.as_tensor(s))
    b = [torch.as_tensor(betas_depolarizing(p), dtype=torch.float32)
         for p in (0.25, 0.1)]
    mat = _get_stdc_fn(spec, 2, 150, True, "off", 0.0, "auto",
                       with_stats=True, equal_betas=True)(cs, 7, *b)
    st = _get_stdc_stream_fn(spec, 2, 150, True, "off", 0.0, "auto", True,
                             True, 4096, 64)(cs, 7, *b)
    u_tot, u_half = mat[2]
    n_unique, n_half, overflow = st[2]
    assert not overflow.any()
    assert torch.equal(n_unique.to(torch.int64), u_tot.to(torch.int64))
    assert bool((u_half <= u_tot).all()) and bool((n_half <= n_unique).all())
    assert bool((u_tot > 1).all())
