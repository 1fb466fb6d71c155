"""The port's counting decoders (STDC and its variants, STRC) on the CPU,
through the plain sweep, against exact posteriors (the patterns and bars of
tests/test_decoders.py) and against the JAX STDC; plus the slice's
contract: no kernel launches on the CPU, a CUDA request fails here, every
engine and option runs, and the package imports neither jax nor
triton.

The port samples one colored sweep per recorded step, as the JAX
``sweep``/``pallas`` engines do, so steps are sized as
tests/test_decoders.py:226 sizes them for the sweep engine."""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mcmc_qec_tpu.decoders import STDC as jax_STDC
from mcmc_qec_tpu.decoders.stdc import _pick_stream_window as jax_pick_window
from mcmc_qec_tpu.decoders.streaming import should_stream as jax_should_stream
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import (
    PTEQ,
    STDC,
    STDC_general_noise,
    STDC_general_noise_shortest,
    STDC_Nall_n_alpha,
    STRC,
    pteq_run,
    stdc_run,
)
from mcmc_qec_tpu_torch.decoders.stdc import _pick_stream_window
from mcmc_qec_tpu_torch.decoders.streaming import should_stream
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.ops import resolve_engine, sweep_counts

from reference_oracles import exact_class_posterior


def _syndrome_state(family, d, p=0.1, seed=5):
    """tests/test_decoders.py:35-40: the JAX sampler's state as numpy."""
    jspec = jax_get_spec(family, d)
    s = np.asarray(
        jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec, p, (1,))
    )[0]
    return jspec, spec_from_jax(jspec), s


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_stdc_matches_exact_posterior(family):
    jspec, spec, s0 = _syndrome_state(family, 3)
    exact = exact_class_posterior(jspec, s0, betas_depolarizing(0.1),
                                  jax_np_to_class)
    sweep_counts.reset()
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4,
                 steps=1500, device="cpu")
    assert distr.shape == (1, spec.n_classes) and distr.dtype == np.float32
    assert tv(exact, distr[0] / 100.0) < 0.03, (exact, distr[0])
    # the CPU path runs the plain sampler only, one call for the whole
    # sampling loop, and never launches the kernel
    assert sweep_counts.launches == 0
    assert sweep_counts.plain_calls == 1


def test_stdc_general_noise_matches_exact():
    """Unequal sampling betas: the general acceptance branch."""
    jspec, spec, s0 = _syndrome_state("xzzx", 3, p=0.15, seed=7)
    p_xyz = np.array([0.02, 0.01, 0.12])
    be = -np.log((p_xyz / 3.0) / (1.0 - p_xyz))
    exact = exact_class_posterior(jspec, s0, be, jax_np_to_class)
    distr = STDC_general_noise(spec, s0[None], p_xyz,
                               p_sampling=np.array([0.1, 0.05, 0.2]),
                               droplets=4, steps=1500, device="cpu")
    assert tv(exact, distr[0] / 100.0) < 0.04


def test_stdc_alpha_matches_exact():
    jspec, spec, s0 = _syndrome_state("xzzx", 3, p=0.1, seed=3)
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    exact = exact_class_posterior(jspec, s0, np.array([alpha * b, alpha * b, b]),
                                  jax_np_to_class)
    distr = STDC_Nall_n_alpha(spec, s0[None], pz_tilde_sampling=0.3,
                              alpha=alpha, pz_tilde=pz_tilde, droplets=2,
                              steps=2000, device="cpu")
    assert tv(exact, distr[0] / 100.0) < 0.05


def test_strc_matches_exact_posterior():
    jspec, spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(jspec, s0, betas_depolarizing(0.1),
                                  jax_np_to_class)
    distr = STRC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4,
                 steps=2000, device="cpu")
    assert distr.shape == (1, spec.n_classes)
    assert np.argmax(distr[0]) == np.argmax(exact)
    assert tv(exact, distr[0] / 100.0) < 0.12


def test_stdc_handles_zero_probability_pauli():
    """p_y = 0 must not produce NaNs (infinite beta handling,
    decoders.py:385-389)."""
    _, spec, s0 = _syndrome_state("planar", 3, p=0.08, seed=2)
    distr = STDC_general_noise(spec, s0[None], np.array([0.05, 0.0, 0.05]),
                               p_sampling=0.2, droplets=2, steps=600,
                               device="cpu")
    assert np.all(np.isfinite(distr))
    assert abs(distr.sum() - 100) < 1.0


def test_stdc_shortest_single_stream_matches_two_pass():
    """Both distributions of STDC_general_noise_shortest come from one
    stream; with the same seed they equal the two separate reductions."""
    _, spec, s0 = _syndrome_state("planar", 3, p=0.08, seed=3)
    p_xyz = np.array([0.04, 0.02, 0.06])
    kw = dict(p_sampling=0.25, droplets=2, steps=600, seed=7, device="cpu")
    full, short = STDC_general_noise_shortest(spec, s0[None], p_xyz, **kw)
    full_ref = STDC_general_noise(spec, s0[None], p_xyz, shortest_only=False,
                                  **kw)
    short_ref = STDC_general_noise(spec, s0[None], p_xyz, shortest_only=True,
                                   **kw)
    assert np.allclose(full, full_ref, atol=1e-4)
    assert np.allclose(short, short_ref, atol=1e-4)
    assert abs(full.sum() - 100) < 1.0 and abs(short.sum() - 100) < 1.0


def test_stdc_agrees_with_jax_stdc():
    """Four planar d=3 syndromes (tests/test_decoders.py:55-66): the port's
    STDC and the JAX STDC (sweep engine) each within TV 0.05 of the other,
    and both near the exact posterior."""
    jspec = jax_get_spec("planar", 3)
    spec = spec_from_jax(jspec)
    states = np.asarray(
        jax_sample_depolarizing(jax.random.PRNGKey(1), jspec, 0.12, (4,)))
    kw = dict(p_sampling=0.3, droplets=4, steps=1500)
    theirs = jax_STDC(jspec, states, 0.12, engine="sweep", **kw)
    ours = STDC(spec, states, 0.12, device="cpu", **kw)
    for b in range(4):
        assert tv(ours[b] / 100.0, theirs[b] / 100.0) <= 0.05, (ours[b], theirs[b])
        exact = exact_class_posterior(jspec, states[b], betas_depolarizing(0.12),
                                      jax_np_to_class)
        assert tv(exact, ours[b] / 100.0) < 0.03


def test_warm_starts_take_the_class_axis():
    """(B, K, nq) warm starts are used as given, one per class, and are
    not rained (decoders.py:277-279); the decode runs on tensors too."""
    jspec, spec, s0 = _syndrome_state("planar", 3)
    from mcmc_qec_tpu_torch.ops import all_class_states

    warm = all_class_states(spec, torch.tensor(s0)[None]).movedim(0, 1)
    assert warm.shape == (1, spec.n_classes, spec.nq)
    a = STDC(spec, warm, 0.1, 0.25, droplets=2, steps=300, seed=4, device="cpu")
    b = STDC(spec, warm.numpy(), 0.1, 0.25, droplets=2, steps=300, seed=4,
             device="cpu")
    np.testing.assert_array_equal(a, b)
    assert abs(a.sum() - 100) < 1.0


def test_cuda_device_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, spec, s0 = _syndrome_state("planar", 3)
    for fn in (STDC, STRC):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(spec, s0[None], 0.1, 0.25, droplets=2, steps=10)
        with pytest.raises(RuntimeError, match="cuda"):
            fn(spec, s0[None], 0.1, 0.25, droplets=2, steps=10, device="cuda")


@pytest.mark.parametrize("fn,change", [
    ("STDC", dict(engine="literal")),
    ("STDC", dict(engine="sweep")),
    ("STDC", dict(engine="fused")),
    ("STRC", dict(engine="literal")),
    ("STRC", dict(engine="sweep")),
    ("STRC", dict(engine="fused")),
])
def test_options_not_ported_raise(fn, change):
    """The engines this test once refused now sample, as in the JAX
    package: ``sweep`` on the sweep kernel's per-Pauli branch, ``literal``
    (five proposals a recorded step) and ``fused`` (one) on the literal
    update; the decode gives normalised percentages and, on the sweep
    engine, makes no launch on the CPU."""
    _, spec, s0 = _syndrome_state("planar", 3)
    decoder = {"STDC": STDC, "STRC": STRC}[fn]
    sweep_counts.reset()
    distr = decoder(spec, s0[None], 0.1, 0.25, droplets=2, steps=10,
                    device="cpu", **change)
    assert distr.shape == (1, spec.n_classes)
    np.testing.assert_allclose(distr.sum(-1), 100.0, rtol=1e-5)
    assert sweep_counts.launches == 0
    assert sweep_counts.plain_calls == (change["engine"] == "sweep")


@pytest.mark.parametrize("fn,change", [
    ("STDC", dict(stream=True)),
    ("STDC", dict(conv_mult=2.0)),
    ("STDC", dict(metrics="logger")),
    ("STRC", dict(stream=True)),
    ("STRC", dict(conv_mult=2.0)),
])
def test_options_ported_since_run(fn, change, tmp_path):
    """The options the first counting slice refused (the streaming
    reduction, conv_mult, metrics) now decode to normalised percentages."""
    from mcmc_qec_tpu_torch.utils.metrics import MetricsLogger

    _, spec, s0 = _syndrome_state("planar", 3)
    decoder = {"STDC": STDC, "STRC": STRC}[fn]
    if change.get("metrics"):
        change = dict(metrics=MetricsLogger(str(tmp_path / "m.jsonl")))
    distr = decoder(spec, s0[None], 0.1, 0.25, droplets=2, steps=10,
                    device="cpu", **change)
    assert distr.shape == (1, spec.n_classes)
    np.testing.assert_allclose(distr.sum(-1), 100.0, rtol=1e-5)


@pytest.mark.parametrize("stream,rows,droplets,steps", [
    ("auto", 16384, 4, 450),     # the STDC main path: materialised
    ("auto", 1024, 2, 10000),    # the h2h decode: materialised
    ("auto", 5120, 10, 20000),   # the reference's budget at B=512: streams
    (True, 1, 1, 64),
    (False, 10**6, 10, 10**6),
])
def test_stream_switch_and_window_match_jax(stream, rows, droplets, steps):
    assert should_stream(stream, rows, droplets, steps) == \
        jax_should_stream(stream, rows, droplets, steps)
    assert _pick_stream_window(droplets, steps) == jax_pick_window(droplets, steps)


def test_stream_knob_rejects_other_strings():
    with pytest.raises(ValueError):
        should_stream("off", 1, 1, 1)


def test_auto_stream_above_one_gib_raises(monkeypatch):
    """stream='auto' switches to the streaming reduction here (16384 rows
    x 4 droplets x 1e5 steps x 20 B > 1 GiB).  That path is ported now and
    too long to run here, so its factory is replaced by one that raises:
    the decode must reach it, and with stream=False must not."""
    import mcmc_qec_tpu_torch.decoders.stdc as stdc_mod

    class Streamed(Exception):
        pass

    def streamed(*args):
        raise Streamed(args)

    monkeypatch.setattr(stdc_mod, "_get_stdc_stream_fn", streamed)
    _, spec, _ = _syndrome_state("planar", 3)
    seeds = np.zeros((4096, spec.n_classes, spec.nq), np.uint8)
    b = betas_depolarizing(0.1)
    with pytest.raises(Streamed):
        stdc_run(spec, seeds, b, b, droplets=4, steps=100000, device="cpu")
    small = np.zeros((1, spec.n_classes, spec.nq), np.uint8)
    distr, _ = stdc_run(spec, small, b, b, droplets=1, steps=4, device="cpu")
    assert distr.shape == (1, spec.n_classes)


@pytest.mark.parametrize("fn", [PTEQ, pteq_run, STDC, stdc_run,
                                STDC_general_noise, STDC_general_noise_shortest,
                                STDC_Nall_n_alpha, STRC])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_resolve_engine_per_family():
    """Every engine name resolves in every family, as in the JAX package
    (tests/test_torch_engines.py holds the whole table against it): "auto"
    is the fused window, the sweep kernel's sampler and the K1 sweep; the
    "chain" family maps "pallas" to the K1 sweep."""
    assert resolve_engine("auto", "counting") == "pallas"
    assert resolve_engine("pallas", "counting") == "pallas"
    assert resolve_engine("auto", "pteq") == resolve_engine("fused", "pteq") == "fused"
    for engine in ("literal", "sweep", "fused"):
        assert resolve_engine(engine, "counting") == engine
    for engine in ("literal", "sweep", "pallas"):
        assert resolve_engine(engine, "pteq") == engine
    assert resolve_engine("auto", "chain") == resolve_engine("pallas", "chain") == "sweep"
    with pytest.raises(ValueError):
        resolve_engine("xla", "counting")
    with pytest.raises(ValueError):
        resolve_engine("auto", "window")


def test_import_pulls_in_neither_jax_nor_triton():
    """A fresh interpreter (this one has jax loaded by tests/conftest.py)."""
    code = (
        "import sys, mcmc_qec_tpu_torch.decoders, mcmc_qec_tpu_torch.ops;"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0].startswith(('jax', 'triton')) "
        "or m.split('.')[0] == 'mcmc_qec_tpu');"
        "print(','.join(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "", out.stdout
