"""The port's biased, alpha and shortest-tracking PTEQ on the CPU (plain
window version) against the exact posterior, and the window cache.

Bars: tests/test_decoders.py:313 (PTEQ_biased), :175 (PTEQ_alpha) and
tests/test_shortest_tracking.py:101-148 (PTEQ_alpha_with_shortest), each
at xzzx d=3 with the same parameters; syndromes are drawn with the port's
sampler from the model's per-Pauli probabilities.
"""

import numpy as np
import pytest
import torch

from mcmc_qec_tpu_torch.decoders import (
    PTEQ,
    PTEQ_alpha,
    PTEQ_alpha_with_shortest,
    PTEQ_biased,
    PTEQConfig,
    exact_mld,
)
from mcmc_qec_tpu_torch.decoders import pteq as pteq_mod
from mcmc_qec_tpu_torch.mcmc.ladder import betas_xyz
from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.models.noise import sample_xyz, xyz_probs_from_biased
from mcmc_qec_tpu_torch.ops import ladder_window_counts

ALPHA, PZ_TILDE = 2.0, 0.15


def _xyz_state(spec, px, py, pz, seed):
    """One state from the port's X/Y/Z sampler on a seeded CPU generator."""
    return sample_xyz(torch.Generator().manual_seed(seed), spec, px, py, pz).numpy()


def _alpha_betas():
    b = -np.log(PZ_TILDE)
    return np.array([ALPHA * b, ALPHA * b, b])


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


def test_pteq_biased_matches_exact_posterior():
    spec = get_spec("xzzx", 3)
    p, eta = 0.12, 4.0
    px, py, pz = xyz_probs_from_biased(p, eta)
    s0 = _xyz_state(spec, px, py, pz, seed=4)
    exact = exact_mld(spec, s0[None], betas_xyz(px, py, pz))[0]
    ladder_window_counts.reset()
    res = PTEQ_biased(spec, np.tile(s0[None], (8, 1)), p, eta,
                      PTEQConfig(max_steps=6000, window=200, TOPS=20, SEQ=4),
                      seed=6, device="cpu")
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact), (mean_distr, exact)
    assert tv(exact, mean_distr) < 0.2
    assert ladder_window_counts.launches == 0 and ladder_window_counts.plain_calls > 0


def test_pteq_alpha_matches_exact_posterior():
    spec = get_spec("xzzx", 3)
    s0 = _xyz_state(spec, 0.1 / 3, 0.1 / 3, 0.1 / 3, seed=3)
    exact = exact_mld(spec, s0[None], _alpha_betas())[0]
    res = PTEQ_alpha(spec, np.tile(s0[None], (8, 1)), PZ_TILDE, ALPHA,
                     PTEQConfig(max_steps=6000, window=200, TOPS=20, SEQ=4),
                     seed=4, device="cpu")
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact), (mean_distr, exact)
    assert tv(exact, mean_distr) < 0.2
    assert res.shortest_boltzmann is None


def test_pteq_alpha_with_shortest_matches_exact_argmax():
    """Three distributions summing to 100, no buffer overflow, and the
    shortest-chain Boltzmann argmax equal to the exact posterior's, with
    an energy_chunk > 1 (the window runs at chunk 1 and the host gets the
    chunk means)."""
    spec = get_spec("xzzx", 3)
    # one error, exact posterior 0.892 on class 1 (a syndrome whose top two
    # classes are near-equal can tie in the shortest-chain count)
    s0 = _xyz_state(spec, 0.1 / 3, 0.1 / 3, 0.1 / 3, seed=0)
    exact = exact_mld(spec, s0[None], _alpha_betas())[0]
    res = PTEQ_alpha_with_shortest(
        spec, s0[None], PZ_TILDE, ALPHA,
        PTEQConfig(max_steps=3000, window=200, TOPS=10, SEQ=2, energy_chunk=4),
        seed=1, device="cpu",
    )
    for name in ("shortest_boltzmann", "shortest_counts"):
        d = getattr(res, name)
        assert d.shape == (1, 4), name
        assert abs(d.sum() - 100) < 1.0, name
    assert abs(int(res.distribution.sum()) - 100) <= 4
    assert res.shortest_overflow is not None and not res.shortest_overflow.any()
    assert np.argmax(res.shortest_boltzmann[0]) == np.argmax(exact)


def test_pteq_alpha_with_shortest_tiny_cap_sets_overflow_flag():
    spec = get_spec("xzzx", 3)
    s0 = _xyz_state(spec, 0.1 / 3, 0.1 / 3, 0.1 / 3, seed=0)
    res = PTEQ_alpha_with_shortest(
        spec, s0[None], PZ_TILDE, ALPHA,
        PTEQConfig(max_steps=2000, window=200, TOPS=8, SEQ=2,
                   shortest_unique_cap=1),
        seed=2, device="cpu",
    )
    assert res.shortest_overflow.any()
    assert abs(res.shortest_counts.sum() - 100) < 1.0


def test_window_cache_keeps_branches_apart():
    """PTEQ and then PTEQ_alpha at the same (family, d, Nc, window, ...)
    must not share a window: the second decode equals PTEQ_alpha run on a
    cleared cache."""
    spec = get_spec("xzzx", 3)
    states = np.stack([_xyz_state(spec, 0.03, 0.03, 0.03, seed=s)
                       for s in range(4)])
    cfg = PTEQConfig(max_steps=400, window=100, iters=2, TOPS=5, SEQ=2)
    pteq_mod._WINDOW_CACHE.clear()
    alone = PTEQ_alpha(spec, states, PZ_TILDE, ALPHA, cfg, seed=5, device="cpu")
    pteq_mod._WINDOW_CACHE.clear()
    PTEQ(spec, states, 0.1, cfg, seed=5, device="cpu")
    after = PTEQ_alpha(spec, states, PZ_TILDE, ALPHA, cfg, seed=5, device="cpu")
    np.testing.assert_array_equal(after.distribution, alone.distribution)
    np.testing.assert_array_equal(after.steps, alone.steps)
    np.testing.assert_array_equal(after.tops0, alone.tops0)
    assert len(pteq_mod._WINDOW_CACHE) == 2


@pytest.mark.parametrize("entry", ["biased", "alpha", "alpha_with_shortest"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    spec = get_spec("xzzx", 3)
    states = np.zeros((2, spec.nq), np.uint8)
    cfg = PTEQConfig(max_steps=100, window=100)
    call = {
        "biased": lambda **kw: PTEQ_biased(spec, states, 0.1, 4.0, cfg, **kw),
        "alpha": lambda **kw: PTEQ_alpha(spec, states, PZ_TILDE, ALPHA, cfg, **kw),
        "alpha_with_shortest": lambda **kw: PTEQ_alpha_with_shortest(
            spec, states, PZ_TILDE, ALPHA, cfg, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    assert call(device="cpu").distribution.shape == (2, spec.n_classes)
