"""Every branch of the port's PT window against the Pallas kernel K2.

(a) Zeros mode: the Pallas TPU interpreter's PRNG returns zeros on the CPU
    and the port's ``rng="zeros"`` makes every draw 0, so the plain window
    must reproduce ``make_pallas_ladder_window(..., interpret=True)``
    output for output, traces included, for each sweep form and mix kind
    (general with the exact mix, general with the Metropolis mix, equal
    with the exact mix) x exchange schedule x traces on or off.
(b) Zeros draw op 0, which is the identity logical in every family, so the
    Metropolis mix never proposes a change there.  With the interpreter's
    PRNG stubbed to one constant word (the test's shim, the JAX package
    untouched) and the same word in the port (``rng=<int>``), the mix
    proposes a real logical; the top ladder's betas are large enough that
    it both accepts and rejects, and every output must still be equal.
(c) The kernel's launch shape: words per plane, lanes per rung, warps per
    syndrome and the shared-memory-aware syndromes per block.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcmc_qec_tpu.ops.pallas_ladder as pallas_ladder
import mcmc_qec_tpu_torch.ops.ladder_window as lw
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu_torch.convert import ladder_state_from_numpy, spec_from_jax
from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_depolarizing
from mcmc_qec_tpu_torch.models import get_spec

from test_torch_ladder_window import OUT_NAMES, _ladder_inputs

BRANCHES = {
    # (top_exact, equal_betas)
    "general-exact": (True, False),
    "general-mh": (False, False),
    "equal-exact": (True, True),
}
# a draw word whose 24-bit uniform is ~0.3 (a gate below p_logical = 0.5)
# and whose op index (bits24 % 4 = 1) is a nontrivial logical
FIXED_WORD = 5033165 << 8
# top-rung betas of the Metropolis-mix ladder: at log u ~ -1.2 a logical
# that adds one X error (2.0) is rejected and one that removes errors is
# accepted
MH_TOP = (2.0, 1.6, 0.8)


def _ladder(Nc, branch):
    """(betas, weights): large bottom betas so that the sweeps reject at
    log u = log(1e-12), and for the general branches distinct per-Pauli
    betas and alpha-style weights."""
    if branch == "equal-exact":
        return (beta_ladder_depolarizing(0.001, Nc).astype(np.float32),
                np.ones(3, np.float32))
    bottom, mid = np.array([9.0, 7.0, 5.0]), np.array([0.5, 0.8, 0.3])
    top = np.zeros(3) if branch == "general-exact" else np.array(MH_TOP)
    rows = [bottom] + [mid * (1 + 0.3 * k) for k in range(Nc - 2)] + [top]
    return np.stack(rows).astype(np.float32), np.array([2.5, 2.5, 1.0], np.float32)


class _FixedPRNG:
    """Stand-in for ``pltpu`` inside the Pallas kernel: every random word
    is FIXED_WORD; everything else is the real module."""

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __init__(self, real):
        self._real = real

    def prng_seed(self, *seeds):
        pass

    def prng_random_bits(self, shape):
        return jnp.full(shape, FIXED_WORD, jnp.uint32)


def _both(family, branch, exchange, traces, rng, Nc=4, B=24, W=12, C=4,
          iters=2):
    jspec = jax_get_spec(family, 3)
    spec = spec_from_jax(jspec)
    state, flag, tops0, eq_count, since = _ladder_inputs(jspec, B, Nc, seed=3)
    betas, w = _ladder(Nc, branch)
    top_exact, equal_betas = BRANCHES[branch]
    kw = dict(top_exact=top_exact, equal_betas=equal_betas,
              track_traces=traces, exchange=exchange)
    jfn = pallas_ladder.make_pallas_ladder_window(
        jspec, Nc, W, iters, 0.5, 2, batch_tile=32, energy_chunk=C,
        interpret=True, **kw)
    theirs = [np.asarray(a) for a in jfn(
        jnp.asarray(state), jnp.asarray(flag), jnp.asarray(tops0),
        jnp.asarray(eq_count), jnp.asarray(since), 5, jnp.asarray(betas),
        jnp.asarray(w),
    )]
    fn = lw.make_ladder_window(spec, Nc, W, iters, 0.5, 2, C, rng=rng, **kw)
    ls = ladder_state_from_numpy(state, flag, tops0, "cpu")
    ours = [a.numpy() for a in fn(
        ls.state, ls.flag, ls.tops0, torch.as_tensor(eq_count),
        torch.as_tensor(since), 123, betas, w,
    )]
    names = OUT_NAMES + (("eq_trace", "key_trace") if traces else ())
    assert len(theirs) == len(ours) == len(names)
    for name, a, b in zip(names, theirs, ours):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)
    swaps = ours[8]
    assert (swaps > 0).any() and (swaps < W).any(), "both swap outcomes"
    return ours


CASES = [
    (branch, exchange, traces)
    for branch in BRANCHES
    for exchange in ("sequential", "even_odd")
    for traces in (False, True)
]


@pytest.mark.parametrize("branch,exchange,traces", CASES)
def test_zeros_mode_branch_matches_pallas_interpret(branch, exchange, traces):
    # each combination on one family, all three families covered (the
    # depolarizing ladder at xzzx d=3 accepts every even_odd swap in zeros
    # mode, so that combination runs on another family)
    i = CASES.index((branch, exchange, traces))
    family = ("toric", "planar", "xzzx")[(i + 2) % 3]
    ours = _both(family, branch, exchange, traces, "zeros")
    if traces:
        W, B = ours[9].shape
        assert ours[10].shape == (W, B, 4)
        assert (ours[10] > 0).any()


@pytest.mark.parametrize("family", ["toric", "planar", "xzzx"])
def test_metropolis_mix_matches_pallas_with_fixed_draws(family, monkeypatch):
    monkeypatch.setattr(pallas_ladder, "pltpu", _FixedPRNG(pallas_ladder.pltpu))
    # record the mix's log acceptance ratios (the only weighted sums taken
    # with the top rung's betas)
    logr = []
    weighted = lw._weighted

    def spy(w, n):
        out = weighted(w, n)
        if w.shape == (3,) and n.dim() == 2 and np.allclose(w.numpy(), MH_TOP):
            logr.append(-out)
        return out

    monkeypatch.setattr(lw, "_weighted", spy)
    _both(family, "general-mh", "sequential", True, FIXED_WORD)
    log_u = float(np.log(np.float32((FIXED_WORD >> 8) * 2.0 ** -24 + 1e-12)))
    logr = torch.cat(logr)
    moved = logr != 0
    assert ((logr > log_u) & moved).any(), "a nontrivial logical accepted"
    assert (logr <= log_u).any(), "a logical rejected"


def test_fixed_word_draws_and_rng_validation():
    """An integer rng makes every draw that word; other values raise."""
    words = lw._draw_words(1, 2, 0, 2, 3, 0, 2, 2, FIXED_WORD, "cpu")
    assert words.shape == (2, 3, 2, 8) and bool((words == FIXED_WORD).all())
    spec = get_spec("toric", 3)
    for bad in ("threefry", -1, 1 << 32, True):
        with pytest.raises(ValueError):
            lw.make_ladder_window(spec, 3, 8, 1, 0.5, 2, 4, rng=bad)


@pytest.mark.parametrize("family,d,nw,lanes", [
    ("toric", 3, 1, 1), ("toric", 5, 1, 4), ("xzzx", 13, 3, 8),
    ("toric", 9, 3, 8), ("toric", 13, 6, 8), ("toric", 17, 12, 8),
    ("toric", 19, 12, 8),
])
def test_kernel_words_and_threads(family, d, nw, lanes):
    """Words per plane, lanes per rung (about one per four stabilizers of
    the widest color, at most 8), and a group of Nc * lanes threads padded
    to whole warps within the block's thread bound."""
    spec = get_spec(family, d)
    assert lw.kernel_words(spec.nq) == nw
    _, _, offs = lw.kernel_tables(spec)
    assert offs["nw"] == nw
    assert lw.lanes_per_rung(offs, d) == lanes
    shape = lw.block_shape(offs, d, spec.n_classes, 2048, 132, True, 2,
                           len(spec.logical_draws))
    assert shape.lanes == lanes
    assert shape.warps_per_group == -(-d * lanes // 32)
    assert shape.threads == 32 * shape.warps_per_group * shape.groups_per_block
    assert shape.threads <= lw.MAX_THREADS


def test_block_shape_fits_shared_memory():
    """Groups per block stay within the thread bound, the named barriers
    and 227 KB of shared memory; toric d=19's 85 KB of tables fit beside
    a 19-rung group but leave no room for a 25-rung one, whose tables are
    then read from device memory."""
    for family, d, Nc, want_tab in (("toric", 5, 5, True), ("xzzx", 13, 13, True),
                                    ("toric", 13, 13, True), ("toric", 19, 19, True),
                                    ("toric", 19, 25, False)):
        spec = get_spec(family, d)
        _, _, offs = lw.kernel_tables(spec)
        nd = len(spec.logical_draws)
        for eq in (True, False):
            shape = lw.block_shape(offs, Nc, spec.n_classes, 2048, 132, eq, 2, nd)
            assert shape.tab_in_smem == want_tab, (family, d)
            assert 1 <= shape.groups_per_block and shape.threads <= lw.MAX_THREADS
            assert shape.smem == lw.smem_bytes(
                offs, Nc, spec.n_classes, shape.groups_per_block,
                eq, 2, nd, want_tab) <= lw.SMEM_LIMIT
    # the production shape: one warp per syndrome, 16 syndromes per block
    spec = get_spec("toric", 5)
    offs = lw.kernel_tables(spec)[2]
    shape = lw.block_shape(offs, 5, 16, 2048, 132, True, 2, 2)
    assert shape[:5] == (4, 1, 16, 512, True)

