"""The port's engines on the CPU against the JAX package: the ``sweep``
engine (``ops/dense_sweep.py::make_dense_sweep``, the sweep kernel's plain
version at a row of betas per chain), the ``literal`` engine
(``ops/metropolis.py``), ``random_logical`` and ``resolve_engine``.

(a) Under the uniforms JAX's ``make_dense_sweep`` draws from its key
    (injected in its own (n_colors, *batch, W_max) layout), the plain sweep
    with per-chain betas equals it bit for bit.
(b) Under the draws JAX's ``make_chain_stepper`` makes from its keys
    (metropolis.py:84-124, rebuilt here with the same splits), the literal
    update equals ``make_chain_update`` bit for bit, with and without
    logical proposals.
(c) Both engines sample the exact stationary length distribution (the
    patterns and bars of tests/test_metropolis.py:69-148), and the ladder's
    zero-beta top-mix fast path matches the general mix (:148).
(d) ``random_logical`` equals the JAX function under its draws, keeps the
    syndrome and spreads classes uniformly.
(e) ``resolve_engine`` gives the JAX results for every family and name,
    except ``chain``/``pallas``, which is the K1 sweep (ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops import engines as jax_engines
from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep as jax_dense_sweep
from mcmc_qec_tpu.ops.metropolis import make_chain_update as jax_chain_update
from mcmc_qec_tpu.ops.pauli import random_logical as jax_random_logical
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.mcmc.ladder import (
    beta_ladder_depolarizing,
    betas_depolarizing,
    betas_xyz,
    init_ladder,
    make_ladder_step,
)
from mcmc_qec_tpu_torch.models import np_eq_class, np_syndrome
from mcmc_qec_tpu_torch.ops import (
    count_errors,
    eq_class,
    make_chain_stepper,
    make_chain_update,
    make_dense_sweep,
    random_logical,
    resolve_engine,
    sweep_counts,
)
from mcmc_qec_tpu_torch.ops.dense_sweep import _color_tables
from mcmc_qec_tpu_torch.ops.metropolis import ChainDraws, draw_chain

from test_metropolis import empirical_length_distribution, exact_length_distribution
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


def _states(spec, shape, seed, p=0.2):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 4, shape + (spec.nq,)) * (rng.rand(*shape, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


def _chain_betas(shape, seed):
    """A row of betas per chain: random xyz rates, a depolarizing row, a
    zero row (p=0.75) and one with an infinite beta (p_y = 0)."""
    rng = np.random.RandomState(seed)
    rows = [betas_xyz(*rng.uniform(0.01, 0.2, 3)) for _ in range(6)]
    rows += [betas_depolarizing(0.1), betas_depolarizing(0.75)]
    with np.errstate(divide="ignore"):
        rows.append(betas_xyz(0.1, 0.0, 0.05))
    table = np.asarray(rows, np.float32)
    return table[rng.randint(0, len(rows), shape)]


# ---------------------------------------------------------------------------
# (a) the sweep engine against JAX make_dense_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["toric", "planar", "xzzx"])
def test_dense_sweep_equals_jax_under_injected_uniforms(family):
    """Five sweeps of a (4, 6) batch at a row of betas per chain: JAX
    ``make_dense_sweep`` draws ``log(uniform(key, (n_colors, 4, 6, W_max),
    minval=1e-38))`` (dense_sweep.py:70-73); the port's plain sweep given
    the same array must take the same decisions, bit for bit (both form
    logr as -((bx*dN_x + by*dN_y) + bz*dN_z) in f32, no contraction)."""
    jspec, spec = _specs(family, 3)
    shape = (4, 6)
    states = _states(spec, shape, seed=1, p=0.3)
    betas = _chain_betas(shape, seed=2)
    n_colors = len(_color_tables(spec))
    W = max(sel.shape[0] for sel, _, _ in _color_tables(spec))
    jsweep = jax.jit(jax_dense_sweep(jspec))
    sweep = make_dense_sweep(spec)
    js, ts = jnp.asarray(states), torch.as_tensor(states)
    key = jax.random.PRNGKey(3)
    for _ in range(5):
        key, k = jax.random.split(key)
        logu = np.array(jnp.log(jax.random.uniform(
            k, (n_colors,) + shape + (W,), minval=1e-38)))
        js = jsweep(js, k, jnp.asarray(betas))
        ts = sweep(ts, 0, torch.as_tensor(betas), logu=torch.as_tensor(logu))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (np_syndrome(spec, ts.numpy().reshape(-1, spec.nq))
            == np_syndrome(spec, states.reshape(-1, spec.nq))).all()


def test_dense_sweep_runs_the_plain_version_on_the_cpu():
    _, spec = _specs("toric", 3)
    states = torch.as_tensor(_states(spec, (2, 3), seed=4))
    sweep_counts.reset()
    out = make_dense_sweep(spec, 2)(states, 7, torch.as_tensor(
        _chain_betas((2, 3), seed=5)))
    assert out.shape == states.shape and out.dtype == torch.uint8
    assert sweep_counts.launches == 0 and sweep_counts.plain_calls == 1


# ---------------------------------------------------------------------------
# (b) the literal engine against JAX make_chain_update under its draws
# ---------------------------------------------------------------------------


def _jax_chain_draws(jspec, key, n, iters, p_logical):
    """The draws JAX's ``make_chain_update`` makes (metropolis.py:150-166
    and :84-124): per chain ``split(key, n)``, per proposal
    ``split(key_c, iters)``; returns a ``ChainDraws`` with axes (iters, n).
    ``p_logical`` (n,) or None (no logical proposals)."""
    draws = jspec.logical_draws
    nd = len(draws)

    def stab(k):
        k1, k2 = jax.random.split(k)
        s = jax.random.randint(k1, (), 0, jspec.n_stabs)
        lu = jnp.log(jax.random.uniform(k2, (), minval=1e-38, maxval=1.0))
        return s, lu

    def one(k, p):
        if p_logical is None:
            return stab(k)
        kc, kp = jax.random.split(k)
        use = jax.random.uniform(kc) < p
        keys = jax.random.split(kp, 3 * nd + 1)
        idx = jnp.stack([jnp.stack([
            jax.random.randint(keys[3 * i], (), 0, 4),
            jax.random.randint(keys[3 * i + 1], (), 0, d.x_masks.shape[0]),
            jax.random.randint(keys[3 * i + 2], (), 0, d.z_masks.shape[0]),
        ]) for i, d in enumerate(draws)])
        lul = jnp.log(jax.random.uniform(keys[-1], (), minval=1e-38,
                                         maxval=1.0))
        s, lu = stab(kp)
        return s, lu, use, idx, lul

    def chain(kc, p):
        return jax.vmap(lambda k: one(k, p))(jax.random.split(kc, iters))

    p = jnp.zeros((n,)) if p_logical is None else jnp.asarray(p_logical)
    out = jax.jit(jax.vmap(chain))(jax.random.split(key, n), p)
    out = [torch.as_tensor(np.moveaxis(np.array(a), 0, 1)) for a in out]
    out[0] = out[0].long()
    if p_logical is not None:
        out[3] = out[3].long()
    return ChainDraws(*out)


@pytest.mark.parametrize("family,logical", [
    ("toric", False), ("planar", False), ("toric", True), ("xzzx", True),
])
def test_literal_update_equals_jax_under_its_draws(family, logical):
    """Three updates of 40 proposals on a (6, 3) ladder-shaped batch with
    per-chain betas (the infinite-beta row included) and, with logical
    proposals, p_logical 0.5 on the last rung only: the JAX update and the
    port's update given JAX's draws agree bit for bit."""
    jspec, spec = _specs(family, 3)
    shape, iters = (6, 3), 40
    n = int(np.prod(shape))
    states = _states(spec, shape, seed=6, p=0.3)
    betas = _chain_betas(shape, seed=7)
    p_log = np.zeros(shape, np.float32)
    p_log[:, -1] = 0.5
    jup = jax.jit(jax_chain_update(jspec, iters, include_logical=logical))
    up = make_chain_update(spec, iters, include_logical=logical)
    js, ts = jnp.asarray(states), torch.as_tensor(states)
    key = jax.random.PRNGKey(8)
    for _ in range(3):
        key, k = jax.random.split(key)
        js = jup(js, k, jnp.asarray(betas), jnp.asarray(p_log))
        draws = _jax_chain_draws(jspec, k, n, iters,
                                 p_log.reshape(-1) if logical else None)
        draws = ChainDraws(*(None if d is None else d.reshape(
            (iters,) + shape + d.shape[2:]) for d in draws))
        ts = up(ts, None, torch.as_tensor(betas), torch.as_tensor(p_log),
                draws=draws)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if logical:
        # the top rung left its class somewhere: the logical proposals ran
        assert (np_eq_class(spec, ts.numpy()[:, -1])
                != np_eq_class(spec, states[:, -1])).any()


def test_chain_stepper_is_one_proposal_of_the_update():
    """``make_chain_stepper`` applied proposal by proposal, on the
    sentinel-extended states, equals ``make_chain_update`` under the same
    draws, with and without logical proposals."""
    jspec, spec = _specs("toric", 3)
    shape, iters = (6, 3), 12
    n = int(np.prod(shape))
    states = torch.as_tensor(_states(spec, shape, seed=16, p=0.3))
    betas = torch.as_tensor(_chain_betas(shape, seed=17))
    p_log = torch.zeros(shape)
    p_log[:, -1] = 0.5
    for logical in (False, True):
        draws = draw_chain(spec, iters, shape, torch.Generator().manual_seed(18),
                           "cpu", p_log if logical else None)
        want = make_chain_update(spec, iters, logical)(
            states, None, betas, p_log, draws=draws)
        step = make_chain_stepper(spec, logical)
        ext = torch.cat([states.reshape(n, spec.nq),
                         torch.zeros((n, 1), dtype=torch.uint8)], 1)
        for t in range(iters):
            ext = step(ext, betas.reshape(n, 3), *(
                None if d is None else d[t].reshape((n,) + d.shape[3:])
                for d in draws))
        np.testing.assert_array_equal(ext[:, :spec.nq].reshape(states.shape),
                                      want)


# ---------------------------------------------------------------------------
# (c) stationarity against exact enumeration
# ---------------------------------------------------------------------------


def _run_literal(spec, state0, betas, n_chains=64, n_rounds=300, iters=20):
    up = make_chain_update(spec, iters)
    gen = torch.Generator().manual_seed(0)
    s = torch.as_tensor(state0).expand(n_chains, spec.nq).contiguous()
    b = torch.as_tensor(betas, dtype=torch.float32)
    samples = []
    for r in range(n_rounds):
        s = up(s, gen, b)
        if r >= n_rounds // 3:
            samples.append(count_errors(s).numpy())
    return np.concatenate(samples), s.numpy()


def _run_sweep(spec, state0, betas, n_chains=64, n_rounds=200, burn=70):
    sweep = make_dense_sweep(spec)
    s = torch.as_tensor(state0).expand(n_chains, spec.nq).contiguous()
    b = torch.as_tensor(betas, dtype=torch.float32)
    samples = []
    for r in range(n_rounds):
        s = sweep(s, 1000 + r, b)
        if r >= burn:
            samples.append(count_errors(s).numpy())
    return np.concatenate(samples), s.numpy()


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_literal_stationary_distribution(p):
    """tests/test_metropolis.py:69-85 and its bar (TV < 0.05)."""
    _, spec = _specs("toric", 3)
    rng = np.random.RandomState(0)
    state0 = (rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.2)).astype(np.uint8)
    betas = betas_depolarizing(p)
    exact = exact_length_distribution(spec, state0, betas)
    lengths, final = _run_literal(spec, state0, betas)
    tv = 0.5 * np.abs(exact - empirical_length_distribution(lengths, spec.nq)).sum()
    assert tv < 0.05, f"TV distance {tv:.3f} too large"
    assert (np_syndrome(spec, final) == np_syndrome(spec, state0[None])).all()
    assert (np_eq_class(spec, final) == np_eq_class(spec, state0[None])).all()


@pytest.mark.parametrize("family", ["toric", "planar", "xzzx"])
def test_sweep_engine_stationary_distribution(family):
    """tests/test_metropolis.py:116-145 (the dense sweep) and its bar
    (TV < 0.06), at per-Pauli betas."""
    _, spec = _specs(family, 3)
    rng = np.random.RandomState(4)
    state0 = ((rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.2))
              .astype(np.uint8) * spec.valid_mask)
    betas = betas_xyz(0.05, 0.02, 0.1)
    exact = exact_length_distribution(spec, state0, betas)
    lengths, final = _run_sweep(spec, state0, betas)
    tv = 0.5 * np.abs(exact - empirical_length_distribution(lengths, spec.nq)).sum()
    assert tv < 0.06, f"TV distance {tv:.3f} too large"
    assert (np_syndrome(spec, final) == np_syndrome(spec, state0[None])).all()


def test_engines_agree():
    """tests/test_metropolis.py:98-113: literal and sweep target the same
    distribution (TV < 0.06)."""
    _, spec = _specs("planar", 3)
    rng = np.random.RandomState(3)
    state0 = ((rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.3))
              .astype(np.uint8) * spec.valid_mask)
    betas = betas_depolarizing(0.2)
    l1, _ = _run_literal(spec, state0, betas, n_rounds=200)
    l2, _ = _run_sweep(spec, state0, betas, n_rounds=150, burn=50)
    tv = 0.5 * np.abs(empirical_length_distribution(l1, spec.nq)
                      - empirical_length_distribution(l2, spec.nq)).sum()
    assert tv < 0.06, f"engines disagree, TV {tv:.3f}"


def test_top_mix_fast_path_equivalence():
    """tests/test_metropolis.py:148-177: with zero top-rung betas the
    one-XOR logical mix gives the class distribution of the general
    Metropolis mix (TV < 0.10)."""
    _, spec = _specs("toric", 3)
    Nc, B = 2, 768
    betas = torch.as_tensor(beta_ladder_depolarizing(0.75, Nc),
                            dtype=torch.float32)
    assert np.allclose(betas[-1].numpy(), 0.0, atol=1e-7)
    rng = np.random.RandomState(11)
    state0 = ((rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.2))
              .astype(np.uint8) * spec.valid_mask)
    states = torch.as_tensor(state0).expand(B, spec.nq).contiguous()
    hists = []
    for fast in (False, True):
        step = make_ladder_step(spec, Nc, iters=6, p_logical=0.5,
                                engine="sweep", top_exact_accept=fast)
        gen = torch.Generator().manual_seed(42 + fast)
        ls, _, _, _ = step(init_ladder(spec, states, Nc), 42 + fast, betas,
                           gen)
        classes = eq_class(spec, ls.state[:, -1]).numpy()
        hists.append(np.bincount(classes, minlength=spec.n_classes) / B)
    tv = 0.5 * np.abs(hists[0] - hists[1]).sum()
    assert tv < 0.10, f"fast/general top-mix class distributions differ, TV {tv:.3f}"


# ---------------------------------------------------------------------------
# (d) random_logical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_random_logical_equals_jax_under_its_draws(family):
    """JAX ``random_logical`` draws, per logical draw i, the op and the two
    positions from ``split(fold_in(key, i), 3)`` (pauli.py:127-131); given
    those indices the port applies the same masks."""
    jspec, spec = _specs(family, 3)
    B = 64
    states = _states(spec, (B,), seed=9)
    key = jax.random.PRNGKey(10)
    cols = []
    for i, d in enumerate(jspec.logical_draws):
        ko, kx, kz = jax.random.split(jax.random.fold_in(key, i), 3)
        cols.append(np.stack([
            np.asarray(jax.random.randint(ko, (B,), 0, 4)),
            np.asarray(jax.random.randint(kx, (B,), 0, d.x_masks.shape[0])),
            np.asarray(jax.random.randint(kz, (B,), 0, d.z_masks.shape[0])),
        ], -1))
    idx = torch.as_tensor(np.stack(cols, 1), dtype=torch.int64)  # (B, nd, 3)
    want = np.asarray(jax_random_logical(jspec, jnp.asarray(states), key))
    got = random_logical(spec, torch.as_tensor(states), idx=idx).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_logical_keeps_syndrome_and_spreads_classes():
    """From one state, 4096 draws keep the syndrome and land in each of
    the 16 toric classes about equally often (each count within 5 sigma
    of 256)."""
    _, spec = _specs("toric", 3)
    B = 4096
    state = torch.as_tensor(_states(spec, (1,), seed=11)).expand(B, spec.nq)
    gen = torch.Generator().manual_seed(12)
    out = random_logical(spec, state.contiguous(), gen).numpy()
    assert (np_syndrome(spec, out) == np_syndrome(spec, state[:1].numpy())).all()
    counts = np.bincount(np_eq_class(spec, out), minlength=spec.n_classes)
    expect = B / spec.n_classes
    sigma = np.sqrt(expect * (1 - 1 / spec.n_classes))
    assert (np.abs(counts - expect) < 5 * sigma).all(), counts


# ---------------------------------------------------------------------------
# (e) resolve_engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pteq", "counting", "chain"])
@pytest.mark.parametrize("engine", ["auto", "literal", "sweep", "pallas", "fused"])
def test_resolve_engine_matches_jax(kind, engine, monkeypatch):
    """The JAX results, with the JAX backend reported as a TPU (the
    counting decoders' "auto" is the sweep kernel on the card, as it is
    the Pallas kernel there); ``chain``/``pallas`` is the K1 sweep, the
    mapping the JAX pipeline makes for PTDC/PTRC."""
    monkeypatch.setattr(jax_engines.jax, "default_backend", lambda: "tpu")
    want = jax_engines.resolve_engine(engine, kind)
    if (kind, engine) == ("chain", "pallas"):
        want = "sweep"
    assert resolve_engine(engine, kind) == want


def test_resolve_engine_rejects_unknown_names():
    with pytest.raises(ValueError):
        resolve_engine("xla", "counting")
    with pytest.raises(ValueError):
        resolve_engine("auto", "window")
