"""The port's single-temperature decoder (decoders/single_temp.py) on the
CPU: the reference's statistic (the mean error count over all but the
last recorded step, five literal proposals a step), its decision against
the exact posterior (tests/test_decoders.py:190-195), its agreement with
the JAX decoder on the same syndromes, and the entry point's contract."""

import inspect

import numpy as np
import pytest
import torch

import jax

from mcmc_qec_tpu.decoders import single_temp as jax_single_temp
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import single_temp
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.ops import all_class_states, count_errors, make_chain_update

from reference_oracles import exact_class_posterior
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


def test_single_temp_prefers_true_class():
    """tests/test_decoders.py:190-195: the decision (argmin of the mean
    energy) is the exact posterior's argmax."""
    jspec, spec = _specs("planar", 3)
    s0 = _depolarizing(jspec, 0.08, 1, seed=11)[0]
    exact = exact_class_posterior(jspec, s0, betas_depolarizing(0.08),
                                  jax_np_to_class)
    means = single_temp(spec, s0[None], 0.08, max_iters=3000, device="cpu")
    assert means.shape == (1, spec.n_classes) and means.dtype == np.float32
    assert np.argmin(means[0]) == np.argmax(exact)


def test_mean_skips_the_last_recorded_step():
    """With two recorded steps the score is the error count after the
    first (decoders.py:130-133: ``nbr_errors_chain[eq, :max_iters-1]``),
    drawn from a generator seeded with ``seed``; with one step it is the
    mean of nothing, NaN, as ``jnp.mean`` of an empty axis gives."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 3, seed=2)
    seeds = all_class_states(spec, torch.as_tensor(states)).movedim(0, 1)
    gen = torch.Generator().manual_seed(5)
    first = make_chain_update(spec, 5)(
        seeds, gen, torch.as_tensor(betas_depolarizing(0.1), dtype=torch.float32))
    got = single_temp(spec, states, 0.1, max_iters=2, seed=5, device="cpu")
    np.testing.assert_array_equal(got, count_errors(first).numpy().astype(np.float32))
    assert np.isnan(single_temp(spec, states, 0.1, max_iters=1,
                                device="cpu")).all()
    # (B, K, nq) warm starts are taken as given
    warm = single_temp(spec, seeds.numpy(), 0.1, max_iters=2, seed=5,
                       device="cpu")
    np.testing.assert_array_equal(warm, got)


def test_single_temp_tracks_the_jax_decoder():
    """Eight toric d=3 syndromes, 2000 recorded steps in both packages: the
    same decision on at least 7, and per (syndrome, class) mean counts
    within 0.15 errors of each other on average: twice the JAX decoder's
    own spread between two seeds (0.071-0.078 at seeds 1-3 against 11-13;
    the port against JAX at seeds 1-3: 0.068-0.070)."""
    jspec, spec = _specs("toric", 3)
    states = _depolarizing(jspec, 0.1, 8, seed=7)
    want = jax_single_temp(jspec, states, 0.1, max_iters=2000, seed=1)
    got = single_temp(spec, states, 0.1, max_iters=2000, seed=1, device="cpu")
    assert got.shape == want.shape
    assert (got.argmin(1) == want.argmin(1)).sum() >= 7
    assert np.abs(got - want).mean() < 0.15, np.abs(got - want).mean()


def test_single_temp_defaults_to_the_card():
    assert inspect.signature(single_temp).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    jspec, spec = _specs("planar", 3)
    with pytest.raises(RuntimeError, match="cuda"):
        single_temp(spec, _depolarizing(jspec, 0.1, 1, seed=0), 0.1, 10)
