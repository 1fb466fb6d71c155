"""The port's unfused PT ladder step (mcmc/ladder.py) on the CPU: the
physical-order step (``make_ladder_step``) and the position-carrying step
of the PT counting samplers (``make_perm_ladder_step``), against the
patterns and bars of the JAX package's tests.

(a) The perm step's records are exact rung reorderings: every step's keys
    and counts equal ``pack_key``/``count_errors_xyz`` of ``perm_exit``'s
    states (tests/test_perm_ladder.py:98-128), on both engines; and its
    state converts to and from the JAX package's layout.
(b) The perm step and the physical step agree within MC error on swap
    acceptance, the tops0 clock and the per-rung energy profile
    (tests/test_perm_ladder.py:70-95); even_odd runs on the perm step.
(c) even_odd and sequential exchange give the same class occupation and a
    comparable tops0 clock (tests/test_even_odd_exchange.py:55-95).
(d) PTEQ through the unfused window (``engine="sweep"``) reaches the exact
    posterior (tests/test_decoders.py:236-249), and its bookkeeping
    matches the JAX unfused window's on the same ladder.
"""

import numpy as np
import pytest
import torch

import jax

from mcmc_qec_tpu.decoders import PTEQ as jax_PTEQ
from mcmc_qec_tpu.decoders import PTEQConfig as JaxPTEQConfig
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu_torch.convert import (
    perm_ladder_state_from_numpy,
    perm_ladder_state_to_numpy,
    spec_from_jax,
)
from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig
from mcmc_qec_tpu_torch.mcmc import (
    beta_ladder_depolarizing,
    betas_depolarizing,
    init_ladder,
    make_ladder_step,
    make_perm_ladder_step,
    perm_enter,
    perm_exit,
)
from mcmc_qec_tpu_torch.ops import count_errors_xyz, make_hash_mults, pack_key

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
    """The JAX sampler's states as numpy (the tests' inputs)."""
    return np.array(jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec,
                                            p, (B,)))


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


def _betas(p, Nc):
    return torch.as_tensor(beta_ladder_depolarizing(p, Nc), dtype=torch.float32)


def _run_perm(spec, states, Nc, steps, p, seed=0, exchange="sequential",
              engine="sweep"):
    """(pls, n_xyz (steps, B, Nc, 3), swap_acc (steps, B, Nc-1))."""
    step = make_perm_ladder_step(spec, Nc, iters=1, engine=engine,
                                 exchange=exchange)
    betas = _betas(p, Nc)
    pls = perm_enter(init_ladder(spec, torch.as_tensor(states), Nc))
    gen = torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, 2**62, (steps,), generator=gen).tolist()
    nx, acc = [], []
    for t in range(steps):
        pls, _, n, a = step(pls, seeds[t], betas, gen)
        nx.append(n)
        acc.append(a)
    return pls, torch.stack(nx).numpy(), torch.stack(acc).numpy()


def _run_phys(spec, states, Nc, steps, p, seed=0, exchange="sequential",
              p_logical=0.0, K=None):
    """(ls, n_xyz (steps, B, Nc, 3), swap_acc (steps, B, Nc-1), class
    counts (B, K) of the bottom rung)."""
    step = make_ladder_step(spec, Nc, iters=1, p_logical=p_logical,
                            engine="sweep", top_exact_accept=True,
                            exchange=exchange)
    betas = _betas(p, Nc)
    ls = init_ladder(spec, torch.as_tensor(states), Nc)
    gen = torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, 2**62, (steps,), generator=gen).tolist()
    B = states.shape[0]
    counts = torch.zeros((B, K or spec.n_classes), dtype=torch.int64)
    nx, acc = [], []
    for t in range(steps):
        ls, beq, _, a = step(ls, seeds[t], betas, gen)
        counts[torch.arange(B), beq.long()] += 1
        nx.append(count_errors_xyz(ls.state))
        acc.append(a)
    return ls, torch.stack(nx).numpy(), torch.stack(acc).numpy(), counts.numpy()


# ---------------------------------------------------------------------------
# (a) exact records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["sweep", "literal"])
@pytest.mark.parametrize("exchange", ["sequential", "even_odd"])
def test_perm_records_are_exact_rung_reorderings(engine, exchange):
    jspec, spec = _specs("toric", 3)
    Nc, B, p = 4, 64, 0.12
    states = _depolarizing(jspec, p, B, seed=1)
    step = make_perm_ladder_step(spec, Nc, iters=1, engine=engine,
                                 exchange=exchange)
    betas = _betas(p, Nc)
    pls = perm_enter(init_ladder(spec, torch.as_tensor(states), Nc))
    mults = make_hash_mults(spec)
    gen = torch.Generator().manual_seed(3)
    moved = 0
    for t in range(8):
        pls, keys, nxyz, acc = step(pls, 100 + t, betas, gen)
        ls = perm_exit(pls)
        np.testing.assert_array_equal(keys.numpy(),
                                      pack_key(spec, ls.state, mults).numpy())
        np.testing.assert_array_equal(nxyz.numpy(),
                                      count_errors_xyz(ls.state).numpy())
        pos = pls.pos.numpy()
        assert (np.sort(pos, axis=1) == np.arange(Nc)[None]).all()
        moved += int(acc.sum())
    assert moved > 0
    # the state round-trips through the JAX package's layout
    back = perm_ladder_state_from_numpy(*perm_ladder_state_to_numpy(pls),
                                        device="cpu")
    for a, b in zip(back, pls):
        assert torch.equal(a, b)
    assert perm_ladder_state_to_numpy(pls)[3].dtype == np.int32


# ---------------------------------------------------------------------------
# (b) perm step against the physical step
# ---------------------------------------------------------------------------


def test_perm_step_matches_physical_step_statistics():
    """tests/test_perm_ladder.py:70-95 and its bars."""
    jspec, spec = _specs("toric", 3)
    Nc, B, steps, p = 4, 512, 300, 0.12
    states = _depolarizing(jspec, p, B, seed=0)
    pls, n_perm, acc_p = _run_perm(spec, states, Nc, steps, p)
    ls, n_phys, acc_x, _ = _run_phys(spec, states, Nc, steps, p, seed=7)
    rate_p = acc_p.astype(float).mean(axis=(0, 1))
    rate_x = acc_x.astype(float).mean(axis=(0, 1))
    assert np.abs(rate_p - rate_x).max() < 0.05, (rate_p, rate_x)
    t_p = float(pls.tops0.float().mean())
    t_x = float(ls.tops0.float().mean())
    assert abs(t_p - t_x) / max(t_x, 1e-9) < 0.25, (t_p, t_x)
    half = steps // 2
    e_p = n_perm[half:].astype(float).sum(-1).mean(axis=(0, 1))
    e_x = n_phys[half:].astype(float).sum(-1).mean(axis=(0, 1))
    assert np.abs(e_p - e_x).max() < 1.0, (e_p, e_x)
    assert (np.diff(e_p) > -0.2).all(), e_p


def test_perm_step_even_odd_runs():
    """tests/test_perm_ladder.py:131-145: both phases propose and the
    energy rises up the ladder."""
    jspec, spec = _specs("toric", 3)
    Nc, B, steps, p = 4, 256, 200, 0.12
    states = _depolarizing(jspec, p, B, seed=2)
    _, n_eo, acc = _run_perm(spec, states, Nc, steps, p, exchange="even_odd")
    rate = acc.astype(float).mean(axis=(0, 1))
    assert (rate > 0.01).all(), rate
    e = n_eo[steps // 2:].astype(float).sum(-1).mean(axis=(0, 1))
    assert (np.diff(e) > -0.2).all(), e


# ---------------------------------------------------------------------------
# (c) even_odd against sequential
# ---------------------------------------------------------------------------


def test_even_odd_class_occupation_matches_sequential():
    """tests/test_even_odd_exchange.py:55-72 and its bar (TV < 0.05): one
    shared syndrome, class occupation of the bottom rung under both
    schedules; 256 ladders of 1000 steps here, the JAX test's 64 of 3000
    (the same 192,000 samples in fewer, cheaper plain-torch steps)."""
    jspec, spec = _specs("toric", 3)
    B = 256
    states = np.tile(_depolarizing(jspec, 0.1, B, seed=7)[:1], (B, 1))
    kw = dict(p_logical=0.5, p=0.1)
    *_, c_seq = _run_phys(spec, states, 3, 1000, seed=1, **kw)
    *_, c_eo = _run_phys(spec, states, 3, 1000, seed=2, exchange="even_odd",
                         **kw)
    d_seq = c_seq.sum(0) / c_seq.sum()
    d_eo = c_eo.sum(0) / c_eo.sum()
    assert tv(d_seq, d_eo) < 0.05, (d_seq, d_eo)


def test_even_odd_tops0_comparable():
    """tests/test_even_odd_exchange.py:75-95 and its bar: at d=5 the
    even_odd round trips stay within 2x of the sequential schedule's (64
    ladders of 600 steps here, the JAX test's 32 of 1200)."""
    jspec, spec = _specs("toric", 5)
    B = 64
    states = _depolarizing(jspec, 0.15, B, seed=9)
    ls_s, *_ = _run_phys(spec, states, 5, 600, 0.15, seed=3, p_logical=0.5)
    ls_e, *_ = _run_phys(spec, states, 5, 600, 0.15, seed=4, p_logical=0.5,
                         exchange="even_odd")
    t_seq = float(ls_s.tops0.float().mean())
    t_eo = float(ls_e.tops0.float().mean())
    assert t_eo > 0
    assert 0.5 < t_eo / max(t_seq, 1e-9) < 2.0, (t_seq, t_eo)


# ---------------------------------------------------------------------------
# (d) PTEQ through the unfused window
# ---------------------------------------------------------------------------


def test_pteq_sweep_engine_matches_exact_posterior():
    """tests/test_decoders.py:236-249 and its bars (argmax among the top
    two, TV < 0.2), at a third of its budget: 32 syndromes' ladders of at
    most 2400 steps (the JAX test: 8 of 8000), TOPS=10, SEQ=2."""
    jspec, spec = _specs("toric", 3)
    s0 = _depolarizing(jspec, 0.1, 1, seed=5)[0]
    exact = exact_class_posterior(jspec, s0, betas_depolarizing(0.1),
                                  jax_np_to_class)
    B = 32
    cfg = PTEQConfig(max_steps=2400, window=200, TOPS=10, SEQ=2, iters=2,
                     engine="sweep")
    res = PTEQ(spec, np.tile(s0[None], (B, 1)), 0.1, cfg, seed=3,
               device="cpu")
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) in np.argsort(exact)[-2:]
    assert tv(exact, mean_distr) < 0.2


@pytest.mark.parametrize("engine,iters", [("sweep", 2), ("literal", 10)])
def test_unfused_pteq_tracks_the_jax_window(engine, iters):
    """One syndrome on 32 ladders through the JAX and the port's unfused
    PTEQ (two windows of 600 steps, never converging; two sweeps a step,
    or the reference's ten literal proposals): every ladder runs the full
    1200 steps in both, the tops0 clocks are of one size (within a factor
    1.5), and the mean class occupation of the ladders past burn-in is
    within TV 0.2 of the exact posterior in both (the bar of
    tests/test_decoders.py:248; at this budget each is 0.06-0.12 off,
    seeds 0-2)."""
    jspec, spec = _specs("toric", 3)
    B = 32
    s0 = _depolarizing(jspec, 0.1, 1, seed=11)
    exact = exact_class_posterior(jspec, s0[0], betas_depolarizing(0.1),
                                  jax_np_to_class)
    states = np.tile(s0, (B, 1))
    kw = dict(max_steps=1200, window=600, TOPS=10**6, iters=iters,
              engine=engine)
    jres = jax_PTEQ(jspec, states, 0.1, JaxPTEQConfig(**kw), seed=1)
    res = PTEQ(spec, states, 0.1, PTEQConfig(**kw), seed=1, device="cpu")
    assert (res.steps == 1200).all() and (jres.steps == 1200).all()
    t_p, t_j = res.tops0.mean(), jres.tops0.mean()
    assert 1 / 1.5 < t_p / t_j < 1.5, (t_p, t_j)
    for r in (res, jres):
        burned = r.distribution.sum(1) > 90
        assert burned.sum() >= B // 2
        d = r.distribution[burned].mean(0) / 100.0
        assert tv(d, exact) < 0.2, (d, exact)
