"""The port's depolarizing PTEQ decoder on the CPU (plain window version)
against exact posteriors and the JAX decoder, plus the slice's contract:
no kernel launches on the CPU, an explicit CUDA request fails here, the
option still to port raises (and those ported since run), and the package
imports neither jax nor triton."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_qec_tpu.decoders import PTEQ as jax_PTEQ
from mcmc_qec_tpu.decoders import PTEQConfig as JaxPTEQConfig
from mcmc_qec_tpu.decoders import exact_mld
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig, pteq_run
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.models import np_eq_class
from mcmc_qec_tpu_torch.ops import ladder_window_counts


def _depolarizing(spec, p, B, seed):
    rng = np.random.RandomState(seed)
    s = np.where(rng.uniform(size=(B, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


def test_pteq_matches_exact_posterior():
    """tests/test_decoders.py:103-118 pattern and bars, at the production
    iters=2 (the JAX test runs the default iters=10)."""
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    s0 = _depolarizing(spec, 0.1, 1, seed=5)
    exact = exact_mld(jspec, s0, betas_depolarizing(0.1))[0]
    B = 8
    ladder_window_counts.reset()
    res = PTEQ(spec, np.tile(s0, (B, 1)), 0.1,
               PTEQConfig(max_steps=10000, window=200, TOPS=30, SEQ=4,
                          iters=2),
               seed=2, device="cpu")
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) in np.argsort(exact)[-2:]
    assert tv(exact, mean_distr) < 0.2
    # the CPU path runs the plain window only and never launches the kernel
    assert ladder_window_counts.launches == 0
    assert ladder_window_counts.plain_calls > 0


def test_pteq_agrees_with_jax_pteq():
    """32 syndromes at p=0.03: both decoders recover the truth on > 85%
    (tests/test_pallas_ladder.py:34) and agree on the argmax of >= 29/32."""
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    B = 32
    states = _depolarizing(spec, 0.03, B, seed=2)
    true = np_eq_class(spec, states)
    kw = dict(max_steps=4000, window=100, iters=2)
    theirs = jax_PTEQ(jspec, states, 0.03,
                      JaxPTEQConfig(engine="sweep", **kw), seed=3)
    ours = PTEQ(spec, states, 0.03, PTEQConfig(**kw), seed=3, device="cpu")
    assert ours.distribution.shape == (B, spec.n_classes)
    assert ours.distribution.dtype == np.uint8
    a_ours = ours.distribution.argmax(axis=1)
    a_theirs = theirs.distribution.argmax(axis=1)
    assert np.mean(a_ours == true) > 0.85
    assert np.mean(a_theirs == true) > 0.85
    assert (a_ours == a_theirs).sum() >= 29


def test_config_keeps_every_jax_field():
    """Same fields, order and defaults as the JAX PTEQConfig."""
    ours = [(f.name, f.default) for f in dataclasses.fields(PTEQConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxPTEQConfig)]
    assert ours == theirs


def test_cuda_device_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    spec = spec_from_jax(jax_get_spec("toric", 3))
    states = _depolarizing(spec, 0.05, 4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        PTEQ(spec, states, 0.05, PTEQConfig(max_steps=100, window=100),
             device="cuda")
    # the card is the default: the CPU runs only when asked for
    with pytest.raises(RuntimeError, match="cuda"):
        PTEQ(spec, states, 0.05, PTEQConfig(max_steps=100, window=100))


def _run_with(change):
    spec = spec_from_jax(jax_get_spec("toric", 3))
    states = _depolarizing(spec, 0.05, 2, seed=1)
    ladder = np.stack([betas_depolarizing(p) for p in (0.05, 0.4, 0.75)])
    if change.get("ladder") == "biased":
        ladder = ladder * np.array([1.0, 1.0, 0.5])
    cfg = PTEQConfig(max_steps=100, window=100, **change.get("cfg", {}))
    return pteq_run(spec, states, ladder, cfg, device="cpu",
                    **change.get("run", {}))


@pytest.mark.parametrize("change", [
    dict(cfg=dict(engine="sweep")),
    dict(cfg=dict(engine="literal")),
    dict(cfg=dict(ckpt_dir="ckpt")),
    dict(cfg=dict(engine="pallas")),
])
def test_options_not_ported_raise(change):
    """``ckpt_dir`` is still to port and raises.  The unfused engines this
    test once refused now run the window as a loop of ladder steps
    (``sweep``, and ``literal`` and ``pallas`` on the literal update, as
    the JAX package runs them) and decode to the fused window's outputs."""
    if "ckpt_dir" in change["cfg"]:
        with pytest.raises(NotImplementedError):
            _run_with(change)
        return
    res = _run_with(change)
    assert res.distribution.shape == (2, 16)
    assert res.steps.tolist() == [100, 100]
    assert res.distribution.dtype == np.uint8


@pytest.mark.parametrize("change", [
    dict(cfg=dict(exchange="even_odd")),
    dict(run=dict(track_shortest=True, shortest_beta=1.0)),
    dict(ladder="biased"),
])
def test_options_ported_since_run(change):
    """The options the first slices refused (the even_odd exchange,
    shortest tracking, ladders with unequal per-Pauli betas) now decode."""
    res = _run_with(change)
    assert res.distribution.shape == (2, 16)
    assert (res.shortest_boltzmann is not None) == ("run" in change)


def test_unknown_engine_and_exchange_are_errors():
    spec = spec_from_jax(jax_get_spec("toric", 3))
    states = _depolarizing(spec, 0.05, 2, seed=1)
    for cfg in (dict(engine="xla"), dict(exchange="none")):
        with pytest.raises(ValueError):
            PTEQ(spec, states, 0.05, PTEQConfig(max_steps=100, **cfg),
                 device="cpu")


def test_import_pulls_in_neither_jax_nor_triton():
    """A fresh interpreter (this one has jax loaded by tests/conftest.py)."""
    code = (
        "import sys, mcmc_qec_tpu_torch.decoders, mcmc_qec_tpu_torch.convert;"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0].startswith(('jax', 'triton')));"
        "print(','.join(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "", out.stdout
