"""The port's PT counting decoders PTDC and PTRC (decoders/ptdc.py) on the
CPU, against the JAX package and exact posteriors.

(a) ``_ptrc_reduce`` equals the JAX function on the same inputs (rtol
    1e-5) and the f64 oracle of tests/test_ptrc_reduce.py:56-78.
(b) The streamed decode draws the materialised decode's samples: equal
    percentages while no buffer overflows, and the JAX tests' bars with
    the default capacity (tests/test_streaming.py:349-388); the
    ``conv_mult`` knob.
(c) PTDC within TV 0.05 of ``exact_mld``'s posterior at planar d=3 with
    its argmax, PTRC on its argmax (tests/test_decoders.py:175-187), and
    both near the JAX decoders on the same syndromes.
(d) ``engine="pallas"`` is the K1 sweep for this family; the entry
    points default to the card; no kernel launches on the CPU.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders import PTDC as jax_PTDC
from mcmc_qec_tpu.decoders import PTRC as jax_PTRC
from mcmc_qec_tpu.decoders.ptdc import _ptrc_reduce as jax_ptrc_reduce
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTDC, PTRC, exact_mld
from mcmc_qec_tpu_torch.decoders.ptdc import _pt_iters, _ptrc_reduce
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.ops import sweep_counts

from reference_oracles import exact_class_posterior
from test_ptrc_reduce import _oracle, _stats_from_m
from test_torch_ladder_window import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread in every test here: under the tier-1 command's
    workers, per-core threads in each worker oversubscribe the CPU
    (tests/test_torch_ladder_window.py::one_torch_thread)."""
    with one_torch_thread():
        yield


def _specs(family, d):
    jspec = jax_get_spec(family, d)
    return jspec, spec_from_jax(jspec)


def _depolarizing(jspec, p, B, seed):
    return np.array(jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec,
                                            p, (B,)))


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


# ---------------------------------------------------------------------------
# (a) the PTRC reduction
# ---------------------------------------------------------------------------


def _occupancy(seed, B=4, K=4, Nc=5, nq=41):
    rng = np.random.default_rng(seed)
    m_n = (rng.poisson(2.0, (B, K, Nc, nq + 1))
           * (rng.random((B, K, Nc, nq + 1)) < 0.3)).astype(np.int32)
    m_n[..., 25:] = 0
    N_n = np.minimum(rng.integers(0, 4, m_n.shape, dtype=np.int32), m_n)
    l0, l1 = _stats_from_m(m_n, nq)
    return m_n, N_n, l0.astype(np.int32), l1.astype(np.int32)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_ptrc_reduce_equals_jax_and_the_f64_oracle(seed):
    """The inputs of tests/test_ptrc_reduce.py:56-78: the port's f32
    log-space reduction equals the JAX one to rtol 1e-5 (both are f32
    logsumexps, summed in different orders) and the f64 linear-space
    oracle to its bar (0.25 percentage points)."""
    nq = 41
    m_n, N_n, l0, l1 = _occupancy(seed, nq=nq)
    beta_ladder = np.linspace(1.8, 0.0, m_n.shape[2]).astype(np.float32)
    beta_err = 1.1
    got = _ptrc_reduce(*(torch.as_tensor(a) for a in (m_n, N_n, l0, l1)),
                       beta_ladder, beta_err, nq).numpy()
    want = np.asarray(jax_ptrc_reduce(
        jnp.asarray(m_n), jnp.asarray(N_n), jnp.asarray(l0), jnp.asarray(l1),
        jnp.asarray(beta_ladder), jnp.float32(beta_err), nq))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.allclose(got, _oracle(m_n, N_n, beta_ladder, beta_err, nq),
                       atol=0.25)


def test_ptrc_reduce_empty_class_gets_zero():
    """tests/test_ptrc_reduce.py:81-95: a class with no observation on any
    rung gets 0, and a syndrome with none at all gets zeros, not NaN."""
    nq = 11
    m_n = np.zeros((2, 4, 3, nq + 1), np.int32)
    m_n[0, 1, 0, 3] = 5
    N_n = np.minimum(m_n, 2)
    l0, l1 = _stats_from_m(m_n, nq)
    out = _ptrc_reduce(*(torch.as_tensor(a) for a in (m_n, N_n, l0, l1)),
                       np.array([1.0, 0.5, 0.0], np.float32), 1.0, nq).numpy()
    np.testing.assert_allclose(out[0], [0.0, 100.0, 0.0, 0.0], atol=1e-4)
    np.testing.assert_array_equal(out[1], 0.0)


# ---------------------------------------------------------------------------
# (b) streamed against materialised
# ---------------------------------------------------------------------------


def test_ptdc_stream_matches_materialized():
    """tests/test_streaming.py:349-363 and its bars (same argmax, at most
    12 points apart), and with a capacity above every row's 3,000 samples
    the streamed decode is the materialised one, bit for bit."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 3, seed=3)
    kw = dict(droplets=2, Nc=3, steps=3000, seed=7, device="cpu")
    d_mat = PTDC(spec, states, 0.1, stream=False, **kw)
    d_str = PTDC(spec, states, 0.1, stream=True, stream_capacity=8192, **kw)
    d_cap = PTDC(spec, states, 0.1, stream=True, stream_capacity=256, **kw)
    np.testing.assert_array_equal(d_str, d_mat)
    assert np.argmax(d_mat, -1).tolist() == np.argmax(d_cap, -1).tolist()
    assert np.abs(d_mat.astype(int) - d_cap.astype(int)).max() <= 12


def test_ptrc_stream_matches_materialized():
    """tests/test_streaming.py:378-388: the same argmax streamed and
    materialised."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 3, seed=4)
    kw = dict(droplets=2, Nc=3, steps=3000, seed=9, device="cpu")
    d_mat = PTRC(spec, states, 0.1, stream=False, **kw)
    d_str = PTRC(spec, states, 0.1, stream=True, **kw)
    assert np.argmax(d_mat, -1).tolist() == np.argmax(d_str, -1).tolist()


def test_ptdc_conv_mult_knob():
    """tests/test_streaming.py:365-376: a conv_mult so large the stop point
    never binds reproduces conv_mult=0 exactly; a tiny one still gives a
    normalised distribution."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 2, seed=6)
    kw = dict(droplets=2, Nc=3, steps=1500, seed=11, stream=False,
              device="cpu")
    d_off = PTDC(spec, states, 0.1, **kw)
    np.testing.assert_array_equal(d_off, PTDC(spec, states, 0.1,
                                              conv_mult=1e9, **kw))
    s = PTDC(spec, states, 0.1, conv_mult=1e-4, **kw).astype(int).sum(-1)
    assert ((s >= 97) & (s <= 100)).all()


# ---------------------------------------------------------------------------
# (c) against the exact posterior and the JAX decoders
# ---------------------------------------------------------------------------


def _planar_syndrome():
    """tests/test_decoders.py:35-40 (planar d=3, p=0.1, seed 5)."""
    jspec, spec = _specs("planar", 3)
    s0 = _depolarizing(jspec, 0.1, 1, seed=5)[0]
    exact = exact_class_posterior(jspec, s0, betas_depolarizing(0.1),
                                  jax_np_to_class)
    return jspec, spec, s0, exact


def test_ptdc_matches_exact_posterior():
    """tests/test_decoders.py:175-180 and its bars (TV < 0.05, same
    argmax), against the port's ``exact_mld`` too."""
    _, spec, s0, exact = _planar_syndrome()
    np.testing.assert_allclose(
        exact_mld(spec, s0[None], betas_depolarizing(0.1))[0], exact, atol=1e-6)
    distr = PTDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=2,
                 steps=8000, device="cpu")
    assert np.argmax(distr[0]) == np.argmax(exact)
    assert tv(exact, distr[0] / 100.0) < 0.05


def test_ptrc_agrees_on_argmax():
    """tests/test_decoders.py:183-187."""
    _, spec, s0, exact = _planar_syndrome()
    distr = PTRC(spec, s0[None], 0.1, p_sampling=0.25, droplets=2,
                 steps=8000, device="cpu")
    assert np.argmax(distr[0]) == np.argmax(exact)


@pytest.mark.parametrize("decoder,bar", [("PTDC", 0.05), ("PTRC", 0.08)])
def test_pt_decoders_track_the_jax_decoders(decoder, bar):
    """Eight toric d=3 syndromes at p=0.18 (non-trivial posteriors) through
    both packages at the same budget (p_sampling=0.3, droplets=2, Nc=3,
    1500 steps): mean TV between the two below ``bar``, and the same
    argmax wherever JAX's top two classes are more than 0.1 apart.  The
    JAX decoders' own spread between seeds 2, 3 and 12, 13 is a mean TV of
    at most 0.002 (PTDC) and 0.033 (PTRC); the port against JAX at seeds 2
    and 3: 0.002 and 0.024."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.18, 8, seed=13)
    kw = dict(p_sampling=0.3, droplets=2, Nc=3, steps=1500)
    fn, jfn = {"PTDC": (PTDC, jax_PTDC), "PTRC": (PTRC, jax_PTRC)}[decoder]
    want = np.asarray(jfn(jspec, states, 0.18, seed=2, **kw), float) / 100
    got = fn(spec, states, 0.18, seed=2, device="cpu", **kw).astype(float) / 100
    assert np.mean([tv(a, b) for a, b in zip(got, want)]) < bar
    top2 = np.sort(want, axis=1)[:, -2:]
    apart = top2[:, 1] - top2[:, 0] > 0.1
    assert apart.sum() >= 4
    assert (got.argmax(1) == want.argmax(1))[apart].all()


# ---------------------------------------------------------------------------
# (d) engines and the contract
# ---------------------------------------------------------------------------


def test_pallas_engine_is_the_sweep_for_the_pt_decoders():
    """``engine="pallas"`` resolves to the K1 sweep for the "chain" family
    (the JAX package would run one literal proposal per ladder step,
    ptdc.py:64-73, ladder.py:372-377): the same decode as "sweep"; the
    literal engine records after ten proposals (ptdc.py:73)."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 2, seed=14)
    kw = dict(droplets=2, Nc=3, steps=600, seed=3, device="cpu")
    for fn in (PTDC, PTRC):
        np.testing.assert_array_equal(fn(spec, states, 0.1, engine="pallas", **kw),
                                      fn(spec, states, 0.1, engine="sweep", **kw))
    assert _pt_iters("pallas") == _pt_iters("sweep") == _pt_iters("auto") == 1
    assert _pt_iters("literal") == 10
    s = PTDC(spec, states, 0.1, engine="literal", **kw).astype(int).sum(-1)
    assert ((s >= 97) & (s <= 100)).all()


def test_cpu_decodes_run_the_plain_sweep():
    """One plain sampler call per ladder step on the CPU, no launch."""
    jspec, spec = _specs("planar", 3)
    states = _depolarizing(jspec, 0.1, 1, seed=15)
    sweep_counts.reset()
    PTDC(spec, states, 0.1, droplets=1, Nc=3, steps=30, device="cpu")
    assert sweep_counts.launches == 0 and sweep_counts.plain_calls == 10


@pytest.mark.parametrize("fn", [PTDC, PTRC])
def test_pt_decoders_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        jspec, spec = _specs("planar", 3)
        with pytest.raises(RuntimeError, match="cuda"):
            fn(spec, _depolarizing(jspec, 0.1, 1, seed=0), 0.1, steps=30)


@pytest.mark.parametrize("name", ["PTDC", "PTRC"])
def test_fewer_steps_than_rungs_raise_before_any_work(name):
    """``steps < Nc`` leaves each rung no step (the budget is divided by
    Nc): the port raises a ValueError naming both before any work; the JAX
    package still refuses the input, later and with an unrelated error
    (ROADMAP §3 "In the reference")."""
    jspec, spec = _specs("toric", 5)
    s = _depolarizing(jspec, 0.05, 2, seed=3)
    ours = {"PTDC": PTDC, "PTRC": PTRC}[name]
    theirs = {"PTDC": jax_PTDC, "PTRC": jax_PTRC}[name]
    sweep_counts.reset()
    with pytest.raises(ValueError, match=r"steps=4 < Nc=5"):
        ours(spec, s, 0.05, droplets=1, steps=4, device="cpu")
    assert sweep_counts.plain_calls == 0
    with pytest.raises(ZeroDivisionError):
        theirs(jspec, s, 0.05, droplets=1, steps=4)
