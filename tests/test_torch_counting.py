"""The port's counting machinery (ops/pauli.py additions and
decoders/counting.py) against the JAX package on the same numpy inputs.

Deterministic functions are bit-exact.  ``z_direct_count`` sums float32
exponentials in torch's order, not XLA's, so log Z is held to a stated
tolerance: each stream row holds at most 64 unique chains here, and a
float32 sum of n positive terms in two orders differs by at most about
n * 2**-24 relative, 4e-6 for n = 64, so |d log Z| <= 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_qec_tpu.decoders import counting as jc
from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops import pauli as jp
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import counting as tc
from mcmc_qec_tpu_torch.models import np_eq_class, np_syndrome
from mcmc_qec_tpu_torch.ops import pauli as tp

FAMILIES = ["toric", "planar", "rotated", "xzzx"]
LOGZ_ATOL = 1e-5


def _states(spec, B, seed, pmax=0.6):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, pmax, size=(B, 1))
    s = np.where(rng.uniform(size=(B, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


@pytest.mark.parametrize("family", FAMILIES)
def test_pack_key_and_mults_bit_exact(family):
    jspec = jax_get_spec(family, 5)
    spec = spec_from_jax(jspec)
    mults = tp.make_hash_mults(spec)
    np.testing.assert_array_equal(mults, jp.make_hash_mults(jspec))
    assert mults.dtype == np.uint32
    s = _states(spec, 64, seed=3)
    # all-Z states: every product is near 3 * 2**32, so the sum wraps 2**32
    # many times over
    s[:4] = 3 * spec.valid_mask
    theirs = np.asarray(jp.pack_key(jspec, jnp.asarray(s), mults))
    ours = tp.pack_key(spec, torch.as_tensor(s), mults).numpy()
    assert ours.dtype == np.int64 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs.astype(np.int64))
    assert (theirs[:4].astype(np.int64) != (s[:4].astype(np.int64)
                                             @ mults.T.astype(np.int64))).all()
    # the table as a device tensor gives the same keys
    m_t = torch.as_tensor(mults.astype(np.int64))
    assert torch.equal(tp.pack_key(spec, torch.as_tensor(s), m_t),
                       torch.as_tensor(ours))


@pytest.mark.parametrize("family", FAMILIES)
def test_to_class_and_all_class_states_bit_exact(family):
    jspec = jax_get_spec(family, 5)
    spec = spec_from_jax(jspec)
    s = _states(spec, 24, seed=4)
    eqs = np.random.RandomState(0).randint(0, spec.n_classes, 24)
    ours = tp.to_class(spec, torch.as_tensor(s), torch.as_tensor(eqs)).numpy()
    theirs = np.asarray(jp.to_class(jspec, jnp.asarray(s), jnp.asarray(eqs)))
    np.testing.assert_array_equal(ours, theirs)
    ours_all = tp.all_class_states(spec, torch.as_tensor(s)).numpy()
    theirs_all = np.asarray(jp.all_class_states(jspec, jnp.asarray(s)))
    assert ours_all.shape == (spec.n_classes, 24, spec.nq)
    np.testing.assert_array_equal(ours_all, theirs_all)
    np.testing.assert_array_equal(
        np_eq_class(spec, ours_all),
        np.broadcast_to(np.arange(spec.n_classes)[:, None], (spec.n_classes, 24)))


@pytest.mark.parametrize("family", FAMILIES)
def test_apply_stabilizers_uniform_keeps_syndrome_and_class(family):
    spec = spec_from_jax(jax_get_spec(family, 5))
    s = _states(spec, 32, seed=6)
    gen = torch.Generator().manual_seed(1)
    out = tp.apply_stabilizers_uniform(spec, torch.as_tensor(s), gen, 0.5).numpy()
    np.testing.assert_array_equal(np_syndrome(spec, out), np_syndrome(spec, s))
    np.testing.assert_array_equal(np_eq_class(spec, out), np_eq_class(spec, s))
    assert (out != s).any(axis=1).mean() > 0.9
    assert not (out * (1 - spec.valid_mask)).any()


def _stream(seed=0, lead=(2, 3), N=300, n_unique=48):
    """Key/count streams with many duplicates: every sample is one of
    ``n_unique`` chains of a toric d=3 code, and distinct chains often
    share a length."""
    jspec = jax_get_spec("toric", 3)
    rng = np.random.RandomState(seed)
    base = _states(jspec, n_unique, seed=seed + 1, pmax=0.5)
    idx = rng.randint(0, n_unique, size=lead + (N,))
    s = base[idx]
    mults = jp.make_hash_mults(jspec)
    keys = np.asarray(jp.pack_key(jspec, jnp.asarray(s), mults))  # uint32
    nxyz = np.asarray(jp.count_errors_xyz(jnp.asarray(s)))
    return jspec, keys, nxyz


def _both(keys, nxyz):
    return (jc.SampleStream(jnp.asarray(keys), jnp.asarray(nxyz)),
            tc.SampleStream(torch.as_tensor(keys.astype(np.int64)),
                            torch.as_tensor(np.array(nxyz))))


def test_first_occurrence_masks_equal():
    _, keys, _ = _stream(seed=2)
    for row in keys.reshape(-1, keys.shape[-2], 2):
        t = torch.as_tensor(row.astype(np.int64))
        order_j, first_j = jc.first_occurrence(jnp.asarray(row))
        order_t, first_t = tc.first_occurrence(t)
        np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
        np.testing.assert_array_equal(first_t.numpy(), np.asarray(first_j))
        chrono_j = np.asarray(jc.chronological_first_occurrence(jnp.asarray(row)))
        chrono_t = tc.chronological_first_occurrence(t).numpy()
        np.testing.assert_array_equal(chrono_t, chrono_j)
        assert 0 < chrono_t.sum() < len(row)


def test_occupancy_stats_exact():
    jspec, keys, nxyz = _stream(seed=3)
    js, ts = _both(keys, nxyz)
    theirs = jc.occupancy_stats(js, jspec.nq)
    ours = tc.occupancy_stats(ts, jspec.nq)
    for name, a, b in zip(theirs._fields, theirs, ours):
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)
    for a, b in zip(jc.unique_count_in_shortest(js, jspec.nq),
                    tc.unique_count_in_shortest(ts, jspec.nq)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("betas", [
    betas_depolarizing(0.1),
    # a zero-probability Pauli in the error model (stdc.py:358: 1e30)
    np.array([2.1, 1e30, 1.7]),
])
def test_z_direct_count_within_tolerance(betas):
    _, keys, nxyz = _stream(seed=4)
    js, ts = _both(keys, nxyz)
    b32 = np.asarray(betas, np.float32)
    np.testing.assert_array_equal(
        tc._weighted_length(ts.n_xyz, b32).numpy(),
        np.asarray(jc._weighted_length(js.n_xyz, jnp.asarray(b32))))
    plain_j = np.asarray(jc.z_direct_count(js, jnp.asarray(b32)))
    plain_t = tc.z_direct_count(ts, b32).numpy()
    assert plain_t.shape == plain_j.shape == (2, 3)
    np.testing.assert_allclose(plain_t, plain_j, rtol=0, atol=LOGZ_ATOL)
    short_j = np.asarray(jc.z_direct_count(js, jnp.asarray(b32),
                                           shortest_only=True))
    short_t = tc.z_direct_count(ts, b32, shortest_only=True).numpy()
    np.testing.assert_allclose(short_t, short_j, rtol=0, atol=LOGZ_ATOL)
    assert (short_t < plain_t).any()
    both_j = jc.z_direct_count(js, jnp.asarray(b32), with_shortest=True)
    both_t = tc.z_direct_count(ts, b32, with_shortest=True)
    for a, b in zip(both_j, both_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=LOGZ_ATOL)
    np.testing.assert_array_equal(both_t[0].numpy(), plain_t)
    np.testing.assert_array_equal(both_t[1].numpy(), short_t)


def test_validity_masks_not_ported_raise():
    """``valid=`` raised before the streaming slice; it is ported now, so
    the calls that raised run and agree with the JAX package: an all-true
    mask gives the maskless result bit for bit, and a random mask the JAX
    one (log Z within LOGZ_ATOL, occupancy equal)."""
    _, keys, nxyz = _stream(seed=5, lead=(1,), N=20)
    js, ts = _both(keys, nxyz)
    b = np.ones(3, np.float32)
    valid = torch.ones(keys.shape[:-1], dtype=torch.bool)
    assert torch.equal(tc.z_direct_count(ts, b, valid=valid),
                       tc.z_direct_count(ts, b))
    for a, c in zip(tc.occupancy_stats(ts, 18, valid=valid),
                    tc.occupancy_stats(ts, 18)):
        assert torch.equal(a, c)
    v = np.random.RandomState(1).uniform(size=keys.shape[:-1]) < 0.5
    np.testing.assert_allclose(
        tc.z_direct_count(ts, b, valid=torch.as_tensor(v)).numpy(),
        np.asarray(jc.z_direct_count(js, jnp.asarray(b), valid=jnp.asarray(v))),
        rtol=0, atol=LOGZ_ATOL)
    for a, c in zip(tc.occupancy_stats(ts, 18, valid=torch.as_tensor(v)),
                    jc.occupancy_stats(js, 18, valid=jnp.asarray(v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_sampler_records_every_step():
    """The sampler's stream equals pack_key / count_errors_xyz of the
    chains a step-by-step rerun of the same sweeps visits."""
    from mcmc_qec_tpu_torch.ops.sweep import make_sweep

    spec = spec_from_jax(jax_get_spec("planar", 3))
    s0 = torch.as_tensor(_states(spec, 6, seed=7).reshape(2, 3, spec.nq))
    betas = torch.as_tensor(betas_depolarizing(0.2), dtype=torch.float32)
    steps = 5
    final, stream = tc.make_sampler(spec, steps, iters_per_step=1,
                                    engine="auto", equal_betas=True)(s0, 11, betas)
    assert stream.keys.shape == (2, 3, steps, 2)
    assert stream.n_xyz.shape == (2, 3, steps, 3)
    sweep = make_sweep(spec, 1, equal_betas=True)
    seeds = torch.randint(0, 2**31 - 1, (steps,),
                          generator=torch.Generator().manual_seed(11)).tolist()
    flat = s0.reshape(-1, spec.nq)
    mults = tp.make_hash_mults(spec)
    for t in range(steps):
        flat = sweep(flat, seeds[t], betas)
        assert torch.equal(stream.keys[:, :, t].reshape(-1, 2),
                           tp.pack_key(spec, flat, mults))
        assert torch.equal(stream.n_xyz[:, :, t].reshape(-1, 3),
                           tp.count_errors_xyz(flat))
    assert torch.equal(final.reshape(-1, spec.nq), flat)
