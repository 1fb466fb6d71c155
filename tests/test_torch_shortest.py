"""Shortest-chain tracking state and the exact posterior, port against JAX.

(a) ``_shortest_update`` equals the JAX package's dense update bit for bit
    on the random stream of tests/test_shortest_tracking.py:28-74 (ties,
    key collisions, half the steps unburned), every field including the
    key buffer, for buffer caps U = 1, 3, 8.
(b) ``_shortest_scan`` over a window's traces equals the step-by-step
    update with the per-step burn gate ``burn_any & (t >= burn_first)``.
(c) ``convert`` carries a ShortestState between the packages.
(d) ``exact_mld`` (the port's copy) equals the JAX one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders import exact_mld as jax_exact_mld
from mcmc_qec_tpu.decoders.pteq import _shortest_update as jax_update
from mcmc_qec_tpu.decoders.pteq import init_shortest as jax_init_shortest
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu_torch.convert import (
    shortest_state_from_numpy,
    shortest_state_to_numpy,
    spec_from_jax,
)
from mcmc_qec_tpu_torch.decoders import exact_mld
from mcmc_qec_tpu_torch.decoders.pteq import (
    KEY_W,
    _shortest_scan,
    _shortest_update,
    init_shortest,
)
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing, betas_xyz

FIELDS = ("val", "cnt", "nuq", "ovf", "keys")


def _stream(T, B, K, seed):
    """The random update stream of tests/test_shortest_tracking.py: few
    energy levels (ties), keys from a tiny alphabet (collisions)."""
    rng = np.random.RandomState(seed)
    for _ in range(T):
        eq = rng.randint(0, K, B)
        e = rng.randint(3, 7, B).astype(np.float32)
        kk = rng.randint(0, 4, (B, KEY_W)).astype(np.int32)
        burned = rng.randint(0, 2, B).astype(np.int32)
        yield eq, kk, e, burned


@pytest.mark.parametrize("U", [1, 3, 8])
def test_shortest_update_matches_jax_bit_for_bit(U):
    B, K = 5, 4
    theirs = jax_init_shortest(B, K, U)
    ours = init_shortest(B, K, U)
    step = jax.jit(jax_update)
    for eq, kk, e, burned in _stream(300, B, K, seed=U):
        theirs = step(theirs, jnp.asarray(eq), jnp.asarray(kk), jnp.asarray(e),
                      jnp.asarray(burned))
        ours = _shortest_update(ours, torch.as_tensor(eq), torch.as_tensor(kk),
                                torch.as_tensor(e), torch.as_tensor(burned))
    for name, a, b in zip(FIELDS, theirs, shortest_state_to_numpy(ours)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert np.asarray(theirs.ovf).any(), "the stream should overflow the buffer"


def test_shortest_scan_equals_the_step_loop():
    rng = np.random.RandomState(5)
    W, B, K, U = 40, 6, 4, 3
    eq_tr = torch.as_tensor(rng.randint(0, K, (W, B)))
    en = torch.as_tensor(rng.randint(3, 6, (W, B)).astype(np.float32))
    key_tr = torch.as_tensor(rng.randint(0, 3, (W, B, KEY_W)).astype(np.int32))
    burn_any = torch.as_tensor([True, True, False, True, True, False])
    burn_first = torch.as_tensor([0, 17, 0, 39, 5, 0], dtype=torch.int32)
    want = init_shortest(B, K, U)
    for t in range(W):
        burned = (burn_any & (t >= burn_first)).to(torch.int32)
        want = _shortest_update(want, eq_tr[t], key_tr[t], en[t], burned)
    got = _shortest_scan(init_shortest(B, K, U), eq_tr, en, key_tr, burn_any,
                         burn_first)
    for name, a, b in zip(FIELDS, want, got):
        assert torch.equal(a, b), name
    # no burned step: the state comes back unchanged
    sh = init_shortest(B, K, U)
    assert _shortest_scan(sh, eq_tr, en, key_tr, torch.zeros(B, dtype=torch.bool),
                          burn_first) is sh


def test_shortest_state_crosses_between_packages():
    """A JAX ShortestState continued in the port gives the state the JAX
    package reaches on the same stream."""
    B, K, U = 4, 4, 3
    stream = list(_stream(60, B, K, seed=9))
    step = jax.jit(jax_update)
    theirs = jax_init_shortest(B, K, U)
    for eq, kk, e, burned in stream[:30]:
        theirs = step(theirs, *map(jnp.asarray, (eq, kk, e, burned)))
    ours = shortest_state_from_numpy(*(np.asarray(a) for a in theirs),
                                     device="cpu")
    for eq, kk, e, burned in stream[30:]:
        theirs = step(theirs, *map(jnp.asarray, (eq, kk, e, burned)))
        ours = _shortest_update(ours, *map(torch.as_tensor, (eq, kk, e, burned)))
    for name, a, b in zip(FIELDS, theirs, shortest_state_to_numpy(ours)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("family", ["toric", "planar", "xzzx"])
def test_exact_mld_matches_jax(family):
    jspec = jax_get_spec(family, 3)
    spec = spec_from_jax(jspec)
    rng = np.random.RandomState(4)
    s = np.where(rng.uniform(size=(3, spec.nq)) < 0.15,
                 rng.randint(1, 4, size=(3, spec.nq)), 0)
    states = (s * spec.valid_mask).astype(np.uint8)
    for betas in (betas_depolarizing(0.1), betas_xyz(0.02, 0.02, 0.1)):
        want = jax_exact_mld(jspec, states, betas)
        got = exact_mld(spec, states, betas)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
