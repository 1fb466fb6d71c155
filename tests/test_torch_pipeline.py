"""The port's batch pipeline (``mcmc_qec_tpu_torch.pipeline``) on the CPU,
against the JAX package's pipeline.

(a) ``RunConfig`` serialises as the JAX one for the same fields, and
    configs and datasets written by either package load in the other;
    ``concat_datasets`` and ``evaluate_dataset`` agree on them.
(b) ``decode_batch`` for MWPM and eMWPM equals JAX's bit for bit on the
    same states; for PTEQ (engine ``sweep``), STDC, PTDC and ST at planar
    d=3 it agrees with JAX's ``decode_batch`` and with ``exact_mld`` at
    the bars of tests/test_decoders.py (PERF.md §2).
(c) ``generate`` reaches tests/test_pipeline.py's success rate; an
    ``append=True`` resume draws fresh syndromes and equals one straight
    run; ``mwpm_init`` with PTEQ raises a readable ``ValueError`` before
    any work, where the JAX package fails with a broadcast error.
(d) The retry rule of tests/test_pipeline.py:216-285 (transient errors
    retried, config errors not, exhausted retries re-raise), plus
    ``NotImplementedError`` never retried and a missing card raising at
    once.
"""

import json
import sys

import numpy as np
import pytest
import torch

from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.pipeline import Dataset as JaxDataset
from mcmc_qec_tpu.pipeline import RunConfig as JaxRunConfig
from mcmc_qec_tpu.pipeline import evaluate_dataset as jax_evaluate_dataset
from mcmc_qec_tpu.pipeline.generate import decode_batch as jax_decode_batch
from mcmc_qec_tpu_torch.decoders import exact_mld
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class
from mcmc_qec_tpu_torch.pipeline import (
    Dataset,
    MCMCDataReader,
    RunConfig,
    concat_datasets,
    evaluate_dataset,
    evaluate_submethods,
    generate,
    sample_errors,
)
from mcmc_qec_tpu_torch.pipeline.generate import (
    decode_batch,
    error_generator,
    error_seed,
)

# the JAX tests' d=3 syndromes (tests/test_decoders.py:35-40), as data
PLANAR_P01 = np.array([0, 0, 0, 2, 0, 0, 3, 1, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0],
                      np.uint8)
PLANAR_P008 = np.array([0, 3, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                       np.uint8)
gen_module = sys.modules["mcmc_qec_tpu_torch.pipeline.generate"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread in every test here: under the tier-1 command's
    workers, per-core threads in each worker oversubscribe the CPU
    (tests/test_torch_ladder_window.py::one_torch_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _states(spec, p, n, seed):
    rng = np.random.RandomState(seed)
    s = np.where(rng.uniform(size=(n, spec.nq)) < p,
                 rng.randint(1, 4, size=(n, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


def test_run_config_json_equals_jax():
    kw = dict(code="planar", method="STDC", size=7, p_error=0.12,
              p_sampling=0.3, droplets=6, engine="sweep", mwpm_init=True,
              Nc=4, ckpt_dir="ck", retries=3)
    ours = json.loads(RunConfig(device="cpu", **kw).to_json())
    theirs = json.loads(JaxRunConfig(**kw).to_json())
    assert ours.pop("device") == "cpu"
    assert ours == theirs
    assert RunConfig().device == "cuda"
    assert RunConfig(size=9).steps == 5 * 9**5
    # from_dict ignores the other package's extra keys
    assert RunConfig.from_dict(theirs) == RunConfig(**kw)
    assert JaxRunConfig.from_dict(json.loads(RunConfig(**kw).to_json())) == \
        JaxRunConfig(**kw)


def test_datasets_cross_load_and_evaluate_alike(tmp_path):
    spec = get_spec("planar", 3)
    rng = np.random.RandomState(4)

    def parts(n, seed):
        s = _states(spec, 0.1, n, seed)
        return (s.reshape((n,) + spec.state_shape),
                rng.rand(n, 4).astype(np.float32) * 100,
                np_eq_class(spec, s).astype(np.int32))

    cfg_kw = dict(code="planar", size=3, method="STDC", p_error=0.1)
    ours = Dataset(*parts(6, 1), config=RunConfig(device="cpu", **cfg_kw))
    theirs = JaxDataset(*parts(5, 2), config=JaxRunConfig(**cfg_kw))
    ours.save(str(tmp_path / "ours.npz"))
    theirs.save(str(tmp_path / "theirs.npz"))
    a = Dataset.load(str(tmp_path / "theirs.npz"))  # JAX file, port reader
    b = JaxDataset.load(str(tmp_path / "ours.npz"))  # port file, JAX reader
    assert a.config.method == "STDC" and a.config.device == "cuda"
    assert b.config.method == "STDC"
    for x, y in ((a, theirs), (b, ours)):
        for f in ("qubit_matrices", "distributions", "true_classes"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    both = concat_datasets([Dataset.load(str(tmp_path / "ours.npz")), a])
    assert len(both) == 11
    r_ours = evaluate_dataset(both)
    jboth = JaxDataset(both.qubit_matrices, both.distributions,
                       both.true_classes, JaxRunConfig(**cfg_kw))
    r_theirs = jax_evaluate_dataset(jboth)
    assert (r_ours.n_points, r_ours.n_failures, r_ours.success_rate) == \
        (r_theirs.n_points, r_theirs.n_failures, r_theirs.success_rate)
    np.testing.assert_array_equal(r_ours.per_class_counts,
                                  r_theirs.per_class_counts)
    reader = MCMCDataReader(str(tmp_path / "theirs.npz"))
    assert reader.get_capacity() == 5


@pytest.mark.parametrize("method", ["MWPM", "eMWPM"])
def test_matching_decodes_equal_jax(method):
    spec, jspec = get_spec("planar", 5), jax_get_spec("planar", 5)
    states = _states(spec, 0.1, 24, seed=9)
    ours, dec = decode_batch(spec, RunConfig(code="planar", size=5,
                                             method=method, device="cpu"),
                             states, 3)
    theirs, _ = jax_decode_batch(jspec, JaxRunConfig(code="planar", size=5,
                                                     method=method),
                                 states, 3)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.float32
    # a tensor batch on the device decodes alike
    again, _ = decode_batch(spec, RunConfig(code="planar", size=5,
                                            method=method, device="cpu"),
                            torch.as_tensor(states), 3)
    np.testing.assert_array_equal(again, ours)


# method, syndrome, p, batch, config, bar: ("tv", max TV to the exact
# posterior, with its argmax), ("top2", max TV, argmax among the exact top
# two: the unfused PTEQ at d=3) or ("argmin", None: ST's decision)
STOCHASTIC = [
    ("PTDC", PLANAR_P01, 0.1, 1,
     dict(p_sampling=0.25, droplets=2, steps=8000), ("tv", 0.05)),
    ("STDC", PLANAR_P01, 0.1, 1,
     dict(p_sampling=0.25, droplets=4, steps=1500), ("tv", 0.03)),
    ("PTEQ", PLANAR_P01, 0.1, 8,
     dict(max_steps=8000, window=200, TOPS=30, SEQ=4, iters=2), ("top2", 0.2)),
    ("ST", PLANAR_P008, 0.08, 1, dict(steps=3000), ("argmin", None)),
]


@pytest.mark.parametrize("method,s0,p,B,kw,bar", STOCHASTIC,
                         ids=[c[0] for c in STOCHASTIC])
def test_stochastic_decodes_agree_with_jax_and_exact(method, s0, p, B, kw,
                                                     bar):
    spec, jspec = get_spec("planar", 3), jax_get_spec("planar", 3)
    exact = exact_mld(spec, s0[None], betas_depolarizing(p))[0]
    states = np.tile(s0[None], (B, 1))
    common = dict(code="planar", size=3, method=method, p_error=p,
                  engine="sweep", batch=B, **kw)
    ours, decide = decode_batch(spec, RunConfig(device="cpu", **common),
                                states, 7)
    theirs, jdecide = jax_decode_batch(jspec, JaxRunConfig(**common), states,
                                       7)
    assert ours.shape == theirs.shape == (B, 4)
    mo, mt = ours.mean(0), theirs.mean(0)
    kind, limit = bar
    if kind == "argmin":
        assert decide(mo) == jdecide(mt) == int(exact.argmax())
        return
    for m in (mo, mt):
        assert tv(m / 100.0, exact) < limit, (m, exact)
    if kind == "tv":
        assert decide(mo) == jdecide(mt) == int(exact.argmax())
    else:
        top2 = np.argsort(exact)[-2:].tolist()
        assert decide(mo) in top2 and jdecide(mt) in top2


def test_generate_stdc_planar_and_round_trip(tmp_path):
    """tests/test_pipeline.py:22-37 on the port."""
    cfg = RunConfig(code="planar", method="STDC", size=3,
                    noise="depolarizing", p_error=0.08, p_sampling=0.25,
                    droplets=2, steps=1500, batch=8, device="cpu")
    path = str(tmp_path / "out.npz")
    ds = generate(path, cfg, nbr_datapoints=8, progress=None)
    assert len(ds) == 8
    assert evaluate_dataset(ds).success_rate >= 0.6
    ds2 = Dataset.load(path)
    assert np.array_equal(ds2.qubit_matrices, ds.qubit_matrices)
    assert ds2.config == cfg
    np.testing.assert_array_equal(
        ds.true_classes,
        np_eq_class(get_spec("planar", 3), ds.qubit_matrices.reshape(8, -1)))


def test_append_draws_fresh_syndromes(tmp_path):
    """The draw of the batch at datapoint ``done`` is seeded from
    (seed, done): an append resume equals one straight run and repeats no
    syndrome; the seed mix never repeats on a grid of pairs."""
    cfg = RunConfig(code="toric", method="MWPM", size=5, p_error=0.15,
                    batch=4, device="cpu")
    path = str(tmp_path / "a.npz")
    generate(path, cfg, 8, progress=None)
    ds = generate(path, cfg, 20, progress=None, append=True)
    straight = generate(None, cfg, 20, progress=None)
    np.testing.assert_array_equal(ds.qubit_matrices, straight.qubit_matrices)
    np.testing.assert_array_equal(ds.distributions, straight.distributions)
    flat = ds.qubit_matrices.reshape(20, -1)
    assert len({r.tobytes() for r in flat}) == 20
    seeds = {error_seed(s, d) for s in range(64) for d in range(0, 4096, 4)}
    assert len(seeds) == 64 * 1024
    spec = get_spec("toric", 5)
    first = sample_errors(spec, cfg, error_generator(cfg, 0))
    np.testing.assert_array_equal(first, flat[:4])
    assert first.dtype == np.uint8


def test_sample_errors_every_noise():
    spec = get_spec("xzzx", 5)
    for noise in ("depolarizing", "biased", "alpha", "uncorrelated"):
        cfg = RunConfig(code="xzzx", size=5, noise=noise, p_error=0.1,
                        eta=10.0, alpha=1.5, batch=64, device="cpu")
        s = sample_errors(spec, cfg, error_generator(cfg, 0))
        assert s.shape == (64, spec.nq) and s.dtype == np.uint8
        assert 0 < (s != 0).mean() < 0.3
    with pytest.raises(ValueError):
        sample_errors(spec, RunConfig(noise="pink", device="cpu"),
                      error_generator(RunConfig(device="cpu"), 0))


def test_mwpm_init_with_pteq_raises_before_any_work(monkeypatch):
    """The JAX package passes the matcher's (B, 4, nq) seeds to PTEQ and
    fails deep in the decode with a broadcast ValueError; the port raises
    a ValueError naming the seeds before the matcher or the decoder
    runs."""
    spec, jspec = get_spec("planar", 3), jax_get_spec("planar", 3)
    states = _states(spec, 0.1, 4, seed=1)
    kw = dict(code="planar", method="PTEQ", size=3, mwpm_init=True, batch=4,
              max_steps=200, window=100)
    with pytest.raises(ValueError):
        jax_decode_batch(jspec, JaxRunConfig(**kw), states, 0)

    def boom(*a, **k):
        raise AssertionError("work began")

    monkeypatch.setattr(gen_module, "class_sorted_mwpm_batch", boom)
    monkeypatch.setattr(gen_module, "PTEQ", boom)
    with pytest.raises(ValueError, match=r"\(B, 4, nq\)"):
        decode_batch(spec, RunConfig(device="cpu", **kw), states, 0)


def test_submethods_all():
    cfg = RunConfig(code="planar", method="all", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=2, steps=300, batch=3,
                    device="cpu")
    ds = generate(None, cfg, 3, progress=None)
    assert ds.distributions.shape == (3, 12)
    res = evaluate_submethods(ds)
    assert set(res) == {"ST", "STDC", "STRC"}


def _retry_cfg(tmp_path=None, **kw):
    base = dict(code="planar", method="STDC", size=3, noise="depolarizing",
                p_error=0.08, p_sampling=0.25, droplets=2, steps=200,
                batch=4, retries=2, retry_wait=0.0, device="cpu")
    base.update(kw)
    return RunConfig(**base)


def test_generate_retries_transient_failures(tmp_path, monkeypatch):
    """tests/test_pipeline.py:216-247: a decode that dies with a runtime
    error is retried with the same seed; the dataset equals an
    uninterrupted run's."""
    cfg = _retry_cfg(metrics_path=str(tmp_path / "m.jsonl"))
    clean = generate(None, cfg, nbr_datapoints=8, progress=None)
    real = gen_module.decode_batch
    fails = {"left": 2}

    def flaky(spec, c, states, seed, metrics=None):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("simulated device drop")
        return real(spec, c, states, seed, metrics=metrics)

    monkeypatch.setattr(gen_module, "decode_batch", flaky)
    ds = generate(None, cfg, nbr_datapoints=8, progress=None)
    assert fails["left"] == 0
    assert np.array_equal(ds.distributions, clean.distributions)
    events = [json.loads(line)["event"]
              for line in open(tmp_path / "m.jsonl") if line.strip()]
    assert events.count("decode_retry") == 2


@pytest.mark.parametrize("exc", [ValueError("bad config"),
                                 NotImplementedError("not ported")],
                         ids=["config_error", "not_implemented"])
def test_generate_does_not_retry_config_errors(exc, monkeypatch):
    """tests/test_pipeline.py:250-266, and NotImplementedError (a
    RuntimeError subclass, which the JAX rule would retry)."""
    cfg = _retry_cfg(retries=5)
    calls = {"n": 0}

    def boom(spec, c, states, seed, metrics=None):
        calls["n"] += 1
        raise exc

    monkeypatch.setattr(gen_module, "decode_batch", boom)
    with pytest.raises(type(exc)):
        generate(None, cfg, nbr_datapoints=2, progress=None)
    assert calls["n"] == 1


def test_generate_exhausted_retries_reraises(monkeypatch):
    cfg = _retry_cfg(retries=1)

    def always(spec, c, states, seed, metrics=None):
        raise RuntimeError("persistent device loss")

    monkeypatch.setattr(gen_module, "decode_batch", always)
    with pytest.raises(RuntimeError, match="persistent"):
        generate(None, cfg, nbr_datapoints=2, progress=None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without "
                    "a CUDA device")
def test_missing_card_raises_at_once(monkeypatch):
    """The default device is the card: without one, generate and the
    retry loop raise at once, with no decode attempted and no wait."""
    calls = {"n": 0}

    def count(*a, **k):
        calls["n"] += 1

    monkeypatch.setattr(gen_module, "decode_batch", count)
    monkeypatch.setattr(gen_module.time, "sleep", count)
    cfg = _retry_cfg(device="cuda", retry_wait=100.0)
    with pytest.raises(RuntimeError, match="cuda"):
        generate(None, cfg, nbr_datapoints=2, progress=None)
    with pytest.raises(RuntimeError, match="cuda"):
        gen_module._decode_with_retry(get_spec("planar", 3), cfg,
                                      np.zeros((1, 18), np.uint8), 0, None,
                                      None)
    assert calls["n"] == 0
