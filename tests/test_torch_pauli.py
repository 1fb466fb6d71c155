"""The port's Pauli-state functions are bit-exact against the JAX package
on the same numpy inputs, for all four code families."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops import pauli as jp
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.ops import pauli as tp

FAMILIES = ["toric", "planar", "rotated", "xzzx"]


def _states(jspec, B=96, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, 0.6, size=(B, 1))
    s = np.where(rng.uniform(size=(B, jspec.nq)) < p,
                 rng.randint(1, 4, size=(B, jspec.nq)), 0)
    return (s * jspec.valid_mask).astype(np.uint8)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fn", ["syndrome", "eq_class", "class_bits"])
def test_spec_functions_bit_exact(family, fn):
    jspec = jax_get_spec(family, 5)
    spec = spec_from_jax(jspec)
    s = _states(jspec)
    ours = getattr(tp, fn)(spec, torch.as_tensor(s)).numpy()
    theirs = np.asarray(getattr(jp, fn)(jspec, jnp.asarray(s)))
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fn", ["count_errors", "count_errors_xyz"])
def test_counts_bit_exact(family, fn):
    jspec = jax_get_spec(family, 5)
    s = _states(jspec, seed=1)
    ours = getattr(tp, fn)(torch.as_tensor(s)).numpy()
    theirs = np.asarray(getattr(jp, fn)(jnp.asarray(s)))
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("family", FAMILIES)
def test_bit_planes_bit_exact(family):
    jspec = jax_get_spec(family, 5)
    s = _states(jspec, seed=2)
    for ours, theirs in zip(tp.bit_planes(torch.as_tensor(s)),
                            jp.bit_planes(jnp.asarray(s))):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_batched_leading_axes():
    """(B, Nc, nq) ladders classify rung by rung."""
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    s = _states(jspec, B=24, seed=3).reshape(4, 6, jspec.nq)
    ours = tp.eq_class(spec, torch.as_tensor(s)).numpy()
    theirs = np.asarray(jp.eq_class(jspec, jnp.asarray(s)))
    np.testing.assert_array_equal(ours, theirs)
