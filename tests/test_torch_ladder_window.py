"""The port's PT window (ops/ladder_window.py) against the JAX package.

(a) In zeros mode every random draw is 0, which is what the Pallas TPU
    interpreter's PRNG returns on the CPU, so the plain window must
    reproduce ``make_pallas_ladder_window(..., interpret=True)`` output for
    output.  Rungs hold different random states so that the exchange both
    accepts and rejects.
(b) With Philox draws the plain window must match the JAX sweep-engine
    window in distribution (the bar of tests/test_pallas_ladder.py:98-102).
(c) Philox4x32-10 known answers (Random123 kat_vectors) and the draw layout
    the CUDA kernel shares with the plain version.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders.pteq import PTEQConfig as JaxPTEQConfig
from mcmc_qec_tpu.decoders.pteq import _get_window_fn as jax_window_fn
from mcmc_qec_tpu.mcmc.ladder import init_ladder as jax_init_ladder
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops.pallas_ladder import make_pallas_ladder_window
from mcmc_qec_tpu_torch.convert import (
    ladder_state_from_numpy,
    ladder_state_to_numpy,
    spec_from_jax,
)
from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_depolarizing
from mcmc_qec_tpu_torch.ops.ladder_window import (
    _draw_words,
    kernel_tables,
    ladder_window_counts,
    make_ladder_window,
)
from mcmc_qec_tpu_torch.ops.philox import MASK32, philox4x32

OUT_NAMES = ("state", "flag", "tops0", "eq_count", "since_burn", "energies",
             "burn_any", "burn_first", "swap_acc")
# the production branch: zero top rung, equal per-Pauli betas (the other
# branches: tests/test_torch_ladder_branches.py)
PROD_BRANCH = dict(top_exact=True, equal_betas=True)


@contextlib.contextmanager
def one_torch_thread():
    """Run torch on one thread: the plain window's large tensors otherwise
    start a thread per core in every test worker, and the workers' spinning
    threads oversubscribe the cores (a B=512 window test took 417 s instead
    of about 15 s under the tier-1 command's six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _ladder_inputs(jspec, B, Nc, seed):
    """Rung states with per-rung error rates in [0, 0.7), a few bottom
    rungs flagged, nonzero tops0 / eq_count / since_burn."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.0, 0.7, size=(B, Nc, 1))
    s = np.where(rng.uniform(size=(B, Nc, jspec.nq)) < p,
                 rng.randint(1, 4, size=(B, Nc, jspec.nq)), 0)
    state = (s * jspec.valid_mask).astype(np.uint8)
    flag = np.zeros((B, Nc), np.int32)
    flag[:, -1] = 1
    flag[::3, 0] = 1
    tops0 = rng.randint(0, 4, size=B).astype(np.int32)
    eq_count = rng.randint(0, 5, size=(B, jspec.n_classes)).astype(np.int32)
    since = rng.randint(0, 7, size=B).astype(np.int32)
    return state, flag, tops0, eq_count, since


@pytest.mark.parametrize(
    "family,d,Nc,W,C,iters,p_bottom",
    [
        ("toric", 3, 3, 24, 6, 1, 0.01),
        # bottom beta 8.0: a sweep proposal raising the count by 4 is
        # rejected even with u = 1e-12, so the sweep decision is exercised
        ("toric", 3, 4, 24, 6, 3, 0.001),
        ("toric", 5, 5, 12, 4, 2, 0.01),
        ("planar", 3, 3, 20, 4, 2, 0.01),
        # xzzx is the family with a non-identity bits_to_eq map
        ("xzzx", 3, 3, 12, 4, 2, 0.001),
    ],
)
def test_zeros_mode_matches_pallas_interpret(family, d, Nc, W, C, iters, p_bottom):
    jspec = jax_get_spec(family, d)
    spec = spec_from_jax(jspec)
    B = 24
    state, flag, tops0, eq_count, since = _ladder_inputs(jspec, B, Nc, seed=d)
    betas = beta_ladder_depolarizing(p_bottom, Nc).astype(np.float32)
    weights = np.ones(3, np.float32)

    jfn = make_pallas_ladder_window(
        jspec, Nc, W, iters, 0.5, 2, batch_tile=32, energy_chunk=C,
        interpret=True, top_exact=True, equal_betas=True,
    )
    theirs = [np.asarray(a) for a in jfn(
        jnp.asarray(state), jnp.asarray(flag), jnp.asarray(tops0),
        jnp.asarray(eq_count), jnp.asarray(since), 5, jnp.asarray(betas),
        jnp.asarray(weights),
    )]
    fn = make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, **PROD_BRANCH,
                            rng="zeros")
    ls = ladder_state_from_numpy(state, flag, tops0, "cpu")
    ours = [a.numpy() for a in fn(
        ls.state, ls.flag, ls.tops0, torch.as_tensor(eq_count),
        torch.as_tensor(since), 123, betas, weights,
    )]
    for name, a, b in zip(OUT_NAMES, theirs, ours):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)
    swaps = ours[8]
    assert (swaps > 0).any() and (swaps < W).any(), "both swap outcomes"


def test_ladder_state_round_trip():
    jspec = jax_get_spec("toric", 3)
    state, flag, tops0, _, _ = _ladder_inputs(jspec, 6, 3, seed=4)
    ls = ladder_state_from_numpy(state, flag, tops0, "cpu")
    assert (ls.state.dtype, ls.flag.dtype, ls.tops0.dtype) == (
        torch.uint8, torch.int32, torch.int32)
    for a, b in zip(ladder_state_to_numpy(ls), (state, flag, tops0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_zeros_mode_ignores_seed_and_philox_uses_it():
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    B, Nc, W = 8, 3, 8
    state, flag, tops0, eq_count, since = _ladder_inputs(jspec, B, Nc, seed=1)
    betas = beta_ladder_depolarizing(0.1, Nc).astype(np.float32)
    args = (torch.as_tensor(state), torch.as_tensor(flag),
            torch.as_tensor(tops0), torch.as_tensor(eq_count),
            torch.as_tensor(since))
    w = np.ones(3, np.float32)
    for rng, same in (("zeros", True), ("philox", False)):
        fn = make_ladder_window(spec, Nc, W, 2, 0.5, 2, 4, **PROD_BRANCH, rng=rng)
        a = fn(*args, 1, betas, w)
        b = fn(*args, 2, betas, w)
        assert torch.equal(a[0], b[0]) == same, rng
        # a given seed reproduces its trajectory
        assert all(torch.equal(x, y) for x, y in zip(a, fn(*args, 1, betas, w)))


def test_cpu_window_runs_plain_version_only():
    jspec = jax_get_spec("planar", 3)
    spec = spec_from_jax(jspec)
    B, Nc = 4, 3
    state, flag, tops0, eq_count, since = _ladder_inputs(jspec, B, Nc, seed=2)
    fn = make_ladder_window(spec, Nc, 8, 1, 0.5, 2, 4, **PROD_BRANCH)
    before = (ladder_window_counts.launches, ladder_window_counts.plain_calls)
    out = fn(torch.as_tensor(state), torch.as_tensor(flag),
             torch.as_tensor(tops0), torch.as_tensor(eq_count),
             torch.as_tensor(since), 9,
             beta_ladder_depolarizing(0.1, Nc), np.ones(3, np.float32))
    assert ladder_window_counts.launches == before[0]
    assert ladder_window_counts.plain_calls == before[1] + 1
    assert out[5].shape == (2, B) and out[8].shape == (B, Nc - 1)
    with pytest.raises(ValueError):
        make_ladder_window(spec, Nc, 8, 1, 0.5, 2, 3, **PROD_BRANCH)
    with pytest.raises(ValueError):
        make_ladder_window(spec, Nc, 8, 1, 0.5, 2, 4, **PROD_BRANCH,
                           rng="threefry")
    # the general branches (biased / alpha ladders) run the plain version
    # too, with trace outputs on request
    args = (torch.as_tensor(state), torch.as_tensor(flag),
            torch.as_tensor(tops0), torch.as_tensor(eq_count),
            torch.as_tensor(since), 9, beta_ladder_depolarizing(0.1, Nc),
            np.ones(3, np.float32))
    for top_exact, equal_betas in ((False, True), (True, False)):
        out = make_ladder_window(spec, Nc, 8, 1, 0.5, 2, 4, top_exact=top_exact,
                                 equal_betas=equal_betas, track_traces=True,
                                 exchange="even_odd")(*args)
        assert len(out) == 11
        assert out[9].shape == (8, B) and out[10].shape == (8, B, 4)
    assert ladder_window_counts.launches == before[0]
    assert ladder_window_counts.plain_calls == before[1] + 3


def test_philox_window_matches_jax_sweep_window_in_distribution():
    """Class-occupation distribution, tops0 rate, late energy and per-rung
    swap acceptance of the plain window must match the JAX sweep-engine
    window on the same replicated toric d=3 syndrome (RNG streams differ,
    so the comparison is in distribution)."""
    jspec = jax_get_spec("toric", 3)
    spec = spec_from_jax(jspec)
    Nc, B, W, iters = 3, 512, 400, 4
    K = jspec.n_classes
    rng = np.random.RandomState(3)
    one = np.where(rng.uniform(size=jspec.nq) < 0.15,
                   rng.randint(1, 4, size=jspec.nq), 0).astype(np.uint8)
    states = np.tile(one, (B, 1))
    betas = beta_ladder_depolarizing(0.15, Nc).astype(np.float32)
    w = np.ones(3, np.float32)

    cfg = JaxPTEQConfig(engine="sweep", window=W, iters=iters, tops_burn=2,
                        energy_chunk=4)
    wfn = jax_window_fn(jspec, Nc, cfg, top_exact_accept=True)
    out = wfn(jax_init_ladder(jspec, jnp.asarray(states), Nc),
              jax.random.PRNGKey(4), jnp.asarray(betas),
              jnp.zeros((B, K), jnp.int32), jnp.zeros((B,), jnp.int32),
              jnp.asarray(w))
    ls2, eq2, sb2, en2 = out[0], out[1], out[2], np.asarray(out[3])
    d_xla = np.asarray(eq2.sum(0)) / max(int(sb2.sum()), 1)
    tops_xla = float(ls2.tops0.mean())
    en_xla = float(en2[en2.shape[0] // 2 :].mean())
    sw_xla = np.asarray(out[7]).sum(0) / (B * W)

    fn = make_ladder_window(spec, Nc, W, iters, 0.5, 2, 4, **PROD_BRANCH)
    flag = np.zeros((B, Nc), np.int32)
    flag[:, -1] = 1
    ls = ladder_state_from_numpy(np.repeat(states[:, None], Nc, 1), flag,
                                 np.zeros(B, np.int32), "cpu")
    with one_torch_thread():
        st, fl, tp, eq, sb, en, ba, bf, sw = fn(
            ls.state, ls.flag, ls.tops0, torch.zeros((B, K), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int32), 11, betas, w,
        )
    d_port = eq.sum(0).numpy() / max(int(sb.sum()), 1)
    tops_port = float(tp.float().mean())
    en_port = float(en[en.shape[0] // 2 :].mean())
    sw_port = sw.numpy().sum(0) / (B * W)

    tv = 0.5 * np.abs(d_port - d_xla).sum()
    assert tv < 0.05, f"class distributions diverge, TV {tv:.3f}"
    assert abs(tops_port - tops_xla) / max(tops_xla, 1e-9) < 0.5
    assert abs(en_port - en_xla) < 1.0
    assert np.abs(sw_port - sw_xla).max() < 0.05, (sw_port, sw_xla)


@pytest.mark.parametrize(
    "ctr,key,expect",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((MASK32,) * 4, (MASK32, MASK32),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(ctr, key, expect):
    c = [torch.tensor(v, dtype=torch.int64) for v in ctr]
    got = tuple(int(v) for v in philox4x32(*c, *key))
    assert got == expect


def _philox_int(c, k):
    """Philox4x32-10 on Python ints (unbounded integers, no splitting)."""
    c, (k0, k1) = list(c), k
    for i in range(10):
        if i:
            k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & MASK32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & MASK32]
    return tuple(c)


def test_philox_matches_integer_reference_on_random_counters():
    rng = np.random.RandomState(0)
    ctr = rng.randint(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.int64)
    k = (0xDEADBEEF, 0x12345678)
    got = torch.stack(philox4x32(*torch.as_tensor(ctr), *k)).numpy()
    for j in range(ctr.shape[1]):
        assert tuple(got[:, j]) == _philox_int(ctr[:, j].tolist(), k)


def test_draw_layout():
    """Element e of (step t, row b, use u) is word e % 4 of Philox at
    counter (e // 4, u, t, b) under key (seed low, seed high) — the layout
    csrc/philox.cuh::DrawStream implements."""
    seed = (7 << 32) | 0x89ABCDEF
    k0, k1 = seed & MASK32, seed >> 32
    words = _draw_words(k0, k1, 3, 5, 4, 10, 2, 3, None, "cpu")
    assert words.shape == (2, 4, 2, 12)
    for t, b, u, e in [(3, 0, 10, 0), (4, 3, 11, 7), (3, 2, 10, 11)]:
        want = _philox_int((e // 4, u, t, b), (k0, k1))[e % 4]
        assert int(words[t - 3, b, u - 10, e]) == want


def test_kernel_tables_cover_the_spec():
    """The kernels' packed tables: one (support, X op, Z op) triple per
    stabilizer, four planes per logical-draw position, two per class
    bit, six per hash component (one per coefficient bit), ``span``
    one-word triples per stabilizer on the words its support spans, and
    the bits_to_eq map at the end of the metadata."""
    for family, d in (("toric", 5), ("planar", 3), ("xzzx", 3)):
        spec = spec_from_jax(jax_get_spec(family, d))
        tab, meta, offs = kernel_tables(spec)
        nw = offs["nw"]
        assert offs["off_draw"] == 3 * nw * spec.n_stabs
        n_pos = sum(dr.x_masks.shape[0] for dr in spec.logical_draws)
        assert offs["off_class"] == offs["off_draw"] + 4 * nw * n_pos
        assert offs["off_key"] == offs["off_class"] + 2 * nw * spec.n_class_bits
        assert offs["off_span"] == offs["off_key"] + 4 * 6 * nw
        assert offs["n_tab"] == len(tab) == (
            offs["off_span"] + 3 * offs["span"] * spec.n_stabs)
        np.testing.assert_array_equal(meta[offs["m_b2e"]:], spec.bits_to_eq)
        assert meta[offs["n_colors"]] == spec.n_stabs
