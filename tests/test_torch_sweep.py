"""The port's colored sweep (ops/sweep.py) against the JAX Pallas kernel K1.

(a) The Pallas interpreter injects ``log(jax.random.uniform(...))`` in its
    packed-tile layout (pallas_sweep.py:211-230).  The test rebuilds that
    tensor, maps it into the port's (n_sweeps, n_colors, B, W_max) layout,
    and the plain version must then equal ``make_pallas_sweep(...,
    interpret=True)`` bit for bit, in both acceptance branches.
(b) In Philox mode the sweep samples the exact stationary length
    distribution (the bar of tests/test_pallas_sweep.py:18-40).
(c) With equal betas both branches give identical trajectories under the
    same Philox draws (tests/test_pallas_sweep.py:125-140).
(d) Syndromes are preserved for a ragged batch (tests/test_pallas_sweep.py:43).
(e) On the CPU the wrapper runs the plain version and never launches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.mcmc.ladder import betas_xyz
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops.dense_sweep import _color_tables as jax_color_tables
from mcmc_qec_tpu.ops.pallas_sweep import make_pallas_sweep
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.models import np_syndrome
from mcmc_qec_tpu_torch.ops import count_errors
from mcmc_qec_tpu_torch.ops.sweep import (
    make_sweep,
    stab_width,
    sweep_counts,
    sweep_reference,
)

from test_metropolis import empirical_length_distribution, exact_length_distribution


def _round_up(x, m):
    return -(-x // m) * m


def _states(spec, B, seed, p=0.2):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


def _pallas_logu(jspec, B0, n_sweeps, batch_tile, seed):
    """The interpreter's injected logu mapped to the port's layout: chain b
    sits in padded row b // n_pack, slot b % n_pack; the row is tile
    row // batch_tile, local row row % batch_tile; stabilizer i of color c
    is column slot * W_pad + i (pallas_sweep.py:53-67, 195-230)."""
    tables = jax_color_tables(jspec)
    inner = _round_up(jspec.nq, 32)
    n_pack = max(1, 128 // inner)
    W_pad = _round_up(max(max(sel.shape[0] for sel, _, _ in tables), 8), 8)
    W_out = n_pack * W_pad
    W_max = max(sel.shape[0] for sel, _, _ in tables)
    rows = _round_up(-(-B0 // n_pack), batch_tile)
    n_tiles = rows // batch_tile
    logu = np.asarray(jnp.log(jax.random.uniform(
        jax.random.PRNGKey(seed),
        (n_tiles, n_sweeps, len(tables), batch_tile, W_out), minval=1e-12,
    )))
    b = np.arange(B0)
    row, slot = b // n_pack, b % n_pack
    tile, local = row // batch_tile, row % batch_tile
    cols = slot[:, None] * W_pad + np.arange(W_max)[None, :]  # (B0, W_max)
    # (n_sweeps, n_colors, B0, W_max)
    out = logu[tile[:, None], :, :, local[:, None], cols]  # (B0, W_max, t, c)
    return torch.as_tensor(np.ascontiguousarray(out.transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("equal_betas", [True, False])
@pytest.mark.parametrize("family,d", [("toric", 3), ("toric", 5),
                                      ("planar", 3), ("xzzx", 3)])
def test_plain_equals_pallas_interpret(family, d, equal_betas):
    jspec = jax_get_spec(family, d)
    spec = spec_from_jax(jspec)
    B, n_sweeps, batch_tile, seed = 37, 3, 8, 7
    states = _states(spec, B, seed=d + 11, p=0.3)
    # the general branch gets unequal betas; the equal one beta 0.9, where a
    # proposal raising the count is accepted with probability < 0.41
    betas = (np.full(3, 0.9, np.float32) if equal_betas
             else betas_xyz(0.05, 0.02, 0.1).astype(np.float32))
    fn, _ = make_pallas_sweep(jspec, n_sweeps=n_sweeps, batch_tile=batch_tile,
                              interpret=True, equal_betas=equal_betas)
    theirs = np.asarray(fn(jnp.asarray(states), seed, jnp.asarray(betas)))
    logu = _pallas_logu(jspec, B, n_sweeps, batch_tile, seed)
    assert logu.shape == (n_sweeps, len(jspec.color_stabs), B, stab_width(spec))
    ours = sweep_reference(spec, torch.as_tensor(states), 0, betas, n_sweeps,
                           equal_betas, logu=logu).numpy()
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, states), "the chains never moved"


def test_infinite_beta_rejects_like_pallas_interpret():
    """A Pauli of probability 0 in the sampling betas has beta = inf; inf
    times a zero count change is NaN and NaN rejects, in both versions."""
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    B, n_sweeps, batch_tile, seed = 37, 3, 8, 3
    states = _states(spec, B, seed=5, p=0.4)
    with np.errstate(divide="ignore"):
        betas = betas_xyz(0.1, 0.0, 0.1).astype(np.float32)
    assert np.isinf(betas[1])
    fn, _ = make_pallas_sweep(jspec, n_sweeps=n_sweeps, batch_tile=batch_tile,
                              interpret=True)
    theirs = np.asarray(fn(jnp.asarray(states), seed, jnp.asarray(betas)))
    logu = _pallas_logu(jspec, B, n_sweeps, batch_tile, seed)
    ours = sweep_reference(spec, torch.as_tensor(states), 0, betas, n_sweeps,
                           False, logu=logu).numpy()
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("equal_betas", [True, False])
def test_philox_stationary(equal_betas):
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    rng = np.random.RandomState(5)
    state0 = ((rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.2))
              .astype(np.uint8) * spec.valid_mask)
    betas = (np.full(3, 0.7) if equal_betas else betas_xyz(0.05, 0.02, 0.1))
    exact = exact_length_distribution(jspec, state0, betas)
    fn = make_sweep(spec, n_sweeps=2, equal_betas=equal_betas)
    states = torch.as_tensor(np.tile(state0, (64, 1)))
    betas_t = torch.as_tensor(betas, dtype=torch.float32)
    samples = []
    for r in range(120):
        states = fn(states, r + 1, betas_t)
        if r >= 40:
            samples.append(count_errors(states).numpy())
    emp = empirical_length_distribution(np.concatenate(samples), spec.nq)
    tv = 0.5 * np.abs(exact - emp).sum()
    assert tv < 0.08, f"TV distance {tv:.3f} too large"
    final = states.numpy()
    assert np.array_equal(np_syndrome(spec, final),
                          np.tile(np_syndrome(spec, state0), (len(final), 1)))


def test_equal_and_general_branches_agree_under_philox():
    spec = spec_from_jax(jax_get_spec("toric", 5))
    states = torch.as_tensor(_states(spec, 37, seed=11))
    betas = torch.full((3,), 0.9)
    a = make_sweep(spec, 3, equal_betas=False)(states, 7, betas)
    b = make_sweep(spec, 3, equal_betas=True)(states, 7, betas)
    assert torch.equal(a, b)
    assert not torch.equal(a, states)
    # another seed gives another trajectory
    assert not torch.equal(a, make_sweep(spec, 3)(states, 8, betas))


@pytest.mark.parametrize("family,d", [("toric", 3), ("planar", 5)])
def test_ragged_batch_preserves_syndromes(family, d):
    spec = spec_from_jax(jax_get_spec(family, d))
    states0 = _states(spec, 37, seed=11)
    out = make_sweep(spec, 3)(torch.as_tensor(states0), 7,
                              betas_xyz(0.1, 0.1, 0.1)).numpy()
    assert out.shape == states0.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(np_syndrome(spec, out),
                                  np_syndrome(spec, states0))
    assert not np.array_equal(out, states0)
    # padding cells of planar codes stay empty
    assert not (out * (1 - spec.valid_mask)).any()


def test_cpu_sweep_runs_plain_version_only():
    spec = spec_from_jax(jax_get_spec("toric", 3))
    states = torch.as_tensor(_states(spec, 5, seed=1))
    sweep_counts.reset()
    out = make_sweep(spec, 2)(states, 3, torch.full((3,), 0.5))
    assert (sweep_counts.launches, sweep_counts.plain_calls) == (0, 1)
    assert out.device.type == "cpu"



def test_kernel_refuses_codes_above_six_words():
    """The kernel is built for up to 12 words per plane (toric d=19 has
    nq=722; the limit was 6 words before the kernel read only the words a
    stabilizer spans); the wrapper refuses toric d=21 (nq=882) before any
    launch, in both modes."""
    from mcmc_qec_tpu_torch.ops.sweep import MAX_WORDS, _launch

    assert MAX_WORDS == 12
    assert -(-jax_get_spec("toric", 19).nq // 64) <= MAX_WORDS
    spec = spec_from_jax(jax_get_spec("toric", 21))
    states = torch.zeros((2, spec.nq), dtype=torch.uint8)
    for seeds in (None, torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(NotImplementedError, match="words per plane"):
            _launch(spec, states, torch.zeros(3), steps=3, iters=1,
                    equal_betas=True, seeds=seeds, device_tables={})
