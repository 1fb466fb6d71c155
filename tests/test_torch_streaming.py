"""The port's bounded-memory streaming reduction (decoders/streaming.py),
``conv_mult_valid_mask`` and the streamed STDC/STRC against the JAX
package and the port's own materialised path, on the CPU.

Replayed streams (the pattern of tests/test_streaming.py:43-76): the same
numpy key/count windows go through the JAX ``streaming_scan`` and the
port's.  The JAX scan runs whole windows and masks the tail past ``steps``;
the port's last window holds only the steps that remain, so the JAX replay
is padded with samples that cannot count (masked, and longer than any real
chain so the conv_mult automaton ignores them).  Keys, counts, flags and
the conv_mult state must be equal; ranks are float32 sums of three
products, equal with integer betas and within 1e-6 relative with general
ones.  The conv_mult state is held against the JAX automaton
(``_conv_mult_window``) advanced over exactly the replayed windows, since
the JAX scan's padded tail may still set ``broken``.

Decoders: the streamed decode samples what the materialised one samples
(the same per-step seeds, one plain sampler call per window here), so
STRC's percentages are equal and STDC's agree to float32 rounding of the
Z sums (1e-3 percentage points).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders import counting as jc
from mcmc_qec_tpu.decoders import streaming as js
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import np_to_class as jax_np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing as jax_sample_depolarizing
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import STDC, STRC
from mcmc_qec_tpu_torch.decoders import counting as tc
from mcmc_qec_tpu_torch.decoders import streaming as ts
from mcmc_qec_tpu_torch.decoders.stdc import _get_stdc_fn, _get_stdc_stream_fn
from mcmc_qec_tpu_torch.decoders.strc import _warn_occupancy_truncation
from mcmc_qec_tpu_torch.mcmc.ladder import betas_depolarizing
from mcmc_qec_tpu_torch.ops import sweep_counts

from reference_oracles import exact_class_posterior

GENERAL = (0.7, 1.1, 1.3)
INTEGER = (1.0, 2.0, 1.0)
ONES = (1.0, 1.0, 1.0)


def _random_stream(rng, R, D, steps, nq, n_distinct=40):
    """Random stream with many key collisions; each key has one n_xyz (a
    rank is a function of the chain)."""
    pool_keys = rng.randint(0, 2**31, size=(n_distinct, 2)).astype(np.uint32)
    pool_nxyz = rng.randint(0, max(nq // 3, 2), size=(n_distinct, 3)).astype(
        np.int32)
    pick = rng.randint(0, n_distinct, size=(R, D, steps))
    return pool_keys[pick], pool_nxyz[pick]


def _jax_scan(keys, nxyz, steps, window, capacity, betas, nq, conv_mult,
              cap, track_occupancy):
    R, D = keys.shape[:2]
    n_windows = -(-steps // window)
    pad = n_windows * window - steps
    # padded tail: masked by the scan, and longer than any real chain
    kp = np.concatenate([keys, np.zeros((R, D, pad, 2), np.uint32)], 2)
    npad = np.full((R, D, pad, 3), nq, np.int32)
    na = np.concatenate([nxyz, npad], 2)
    ka = jnp.asarray(kp.reshape(R, D, n_windows, window, 2))
    nb = jnp.asarray(na.reshape(R, D, n_windows, window, 3))
    b = jnp.asarray(betas, jnp.float32)

    def chunk(i, key):
        del key
        return i + 1, jnp.take(ka, i, axis=2), jnp.take(nb, i, axis=2)

    def go():
        return js.streaming_scan(
            chunk, jnp.int32(0), jax.random.PRNGKey(0), steps=steps,
            window=window, capacity=capacity,
            rank_fn=lambda nx: jc._weighted_length(nx, b), nq=nq, R=R, D=D,
            conv_mult=conv_mult, conv_mult_unique_cap=cap,
            track_occupancy=track_occupancy)

    _, st, _ = jax.jit(go)()
    return st


def _jax_conv_mult(keys, nxyz, steps, window, nq, conv_mult, cap):
    """The JAX automaton advanced over exactly the replayed windows."""
    R, D = keys.shape[:2]
    cm = js.init_conv_mult(R, D, cap, nq, steps)
    for s0 in range(0, steps, window):
        s1 = min(steps, s0 + window)
        cm, _ = js._conv_mult_window(
            cm, jnp.asarray(keys[:, :, s0:s1]),
            jnp.asarray(nxyz[:, :, s0:s1].sum(-1)), jnp.float32(s0),
            conv_mult, steps)
    return cm


def _port_scan(keys, nxyz, steps, window, capacity, betas, nq, conv_mult,
               cap, track_occupancy):
    R, D = keys.shape[:2]
    kt = torch.as_tensor(keys.astype(np.int64))
    nt = torch.as_tensor(nxyz)
    b = torch.as_tensor(np.asarray(betas, np.float32))

    def chunk(pos, seeds_w):
        n = len(seeds_w)
        return pos + n, kt[:, :, pos:pos + n], nt[:, :, pos:pos + n]

    _, st, cm = ts.streaming_scan(
        chunk, 0, torch.zeros(steps, dtype=torch.int64), steps=steps,
        window=window, capacity=capacity,
        rank_fn=lambda nx: tc._weighted_length(nx, b), nq=nq, R=R, D=D,
        conv_mult=conv_mult, conv_mult_unique_cap=cap,
        track_occupancy=track_occupancy)
    return st, cm


# (seed, R, D, steps, window, capacity, betas, n_distinct, conv_mult, cap)
SCAN_CASES = {
    "ample-general": (0, 3, 2, 70, 16, 128, GENERAL, 40, 0.0, 64),
    # a window ends exactly at the halfway step (n_unique_half)
    "ample-integer": (1, 3, 2, 67, 11, 128, INTEGER, 40, 0.0, 64),
    "truncating": (2, 2, 2, 90, 24, 16, INTEGER, 80, 0.0, 64),
    "conv_mult": (3, 2, 3, 110, 30, 512, ONES, 25, 2.0, 64),
    "conv_mult-cap2": (4, 2, 3, 110, 30, 512, ONES, 60, 2.0, 2),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_streaming_scan_equals_jax(case):
    seed, R, D, steps, window, capacity, betas, nd, cm_mult, cap = \
        SCAN_CASES[case]
    assert steps % window, "the window must not divide steps"
    nq = 30
    keys, nxyz = _random_stream(np.random.RandomState(seed), R, D, steps, nq,
                                nd)
    args = (steps, window, capacity, betas, nq, cm_mult, cap, True)
    theirs = _jax_scan(keys, nxyz, *args)
    ours, cm = _port_scan(keys, nxyz, *args)
    for f in ("k1", "k2", "m_n", "n_unique", "n_unique_half", "overflow"):
        np.testing.assert_array_equal(
            getattr(ours, f).numpy(),
            np.asarray(getattr(theirs, f)).astype(getattr(ours, f).numpy().dtype),
            err_msg=f)
    for f in ("r", "max_kept"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
        if betas == GENERAL:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert bool(ours.overflow.any()) == (case == "truncating")
    if not cm_mult:
        assert cm is None
        return
    want = _jax_conv_mult(keys, nxyz, steps, window, nq, cm_mult, cap)
    for f in ("sh_len", "stop", "broken", "kbuf", "nk", "kovf"):
        np.testing.assert_array_equal(
            getattr(cm, f).numpy(),
            np.asarray(getattr(want, f)).astype(getattr(cm, f).numpy().dtype),
            err_msg=f)
    assert bool(cm.kovf.any()) == (cap == 2)
    assert bool(cm.broken.any())


def test_stream_reductions_equal_jax():
    """logz_from_stream (all three forms) within 1e-5 and
    occupancy_from_stream equal, on the states of the two scans, with and
    without truncation."""
    nq = 30
    for seed, capacity, nd in ((5, 256, 40), (6, 12, 80)):
        keys, nxyz = _random_stream(np.random.RandomState(seed), 3, 2, 60,
                                    nq, nd)
        for betas in (GENERAL, ONES):
            args = (60, 16, capacity, betas, nq, 0.0, 64, True)
            theirs = _jax_scan(keys, nxyz, *args)
            ours, _ = _port_scan(keys, nxyz, *args)
            np.testing.assert_allclose(
                ts.logz_from_stream(ours).numpy(),
                np.asarray(js.logz_from_stream(theirs)), rtol=1e-5)
            np.testing.assert_allclose(
                ts.logz_from_stream(ours, shortest_only=True).numpy(),
                np.asarray(js.logz_from_stream(theirs, shortest_only=True)),
                rtol=1e-5)
            for a, b in zip(ts.logz_from_stream(ours, with_shortest=True),
                            js.logz_from_stream(theirs, with_shortest=True)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        occ_t = ts.occupancy_from_stream(ours, nq)
        occ_j = js.occupancy_from_stream(theirs, nq)
        for f in ("m_n", "N_n", "shortest", "next_shortest", "trunc_at"):
            np.testing.assert_array_equal(getattr(occ_t, f).numpy(),
                                          np.asarray(getattr(occ_j, f)),
                                          err_msg=f)


def test_streamed_logz_equals_materialised_when_not_truncated():
    """With capacity above the unique count the stream's log Z is the
    materialised z_direct_count's over the same samples."""
    R, D, steps, nq = 3, 2, 64, 30
    keys, nxyz = _random_stream(np.random.RandomState(7), R, D, steps, nq)
    ours, _ = _port_scan(keys, nxyz, steps, 20, 128, GENERAL, nq, 0.0, 64,
                         False)
    stream = tc.SampleStream(
        torch.as_tensor(keys.reshape(R, D * steps, 2).astype(np.int64)),
        torch.as_tensor(nxyz.reshape(R, D * steps, 3)))
    b = np.asarray(GENERAL, np.float32)
    np.testing.assert_allclose(ts.logz_from_stream(ours).numpy(),
                               tc.z_direct_count(stream, b).numpy(), rtol=1e-6)
    for i in range(R):
        assert int(ours.n_unique[i]) == len({tuple(k) for k in
                                             keys[i].reshape(-1, 2)})


@pytest.mark.parametrize("form", ["per-sample", "per-step"])
def test_conv_mult_valid_mask_equals_jax(form):
    """Bit for bit against the JAX scan, over 12 random rows; the
    per-step form gives every step three samples (PT rungs) and lets the
    rule break only at a step's last sample."""
    rng = np.random.RandomState(8)
    rows, N, Nc = 12, 240, 3
    keys, nxyz = _random_stream(rng, rows, 1, N, 30, n_distinct=30)
    keys, n = keys[:, 0], nxyz[:, 0].sum(-1).astype(np.float32)
    t = step_end = None
    if form == "per-step":
        t = np.repeat(np.arange(N // Nc), Nc)
        step_end = (np.arange(N) % Nc) == Nc - 1
    for conv_mult, steps in ((2.0, N), (1.5, N // Nc), (1e-4, N)):
        def one(k, nn):
            return jc.conv_mult_valid_mask(
                k, nn, conv_mult, steps,
                None if t is None else jnp.asarray(t),
                None if step_end is None else jnp.asarray(step_end))

        theirs = np.asarray(jax.vmap(one)(jnp.asarray(keys), jnp.asarray(n)))
        ours = tc.conv_mult_valid_mask(
            torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(n),
            conv_mult, steps,
            None if t is None else torch.as_tensor(t),
            None if step_end is None else torch.as_tensor(step_end))
        assert ours.dtype == torch.bool
        np.testing.assert_array_equal(ours.numpy(), theirs)
        assert not theirs.all() and theirs[:, 0].all()


def test_valid_reductions_equal_jax():
    """z_direct_count(valid=) within 1e-5 relative and
    occupancy_stats(valid=) equal, on a conv_mult mask."""
    rng = np.random.RandomState(9)
    keys, nxyz = _random_stream(rng, 4, 1, 200, 30, n_distinct=35)
    keys, nxyz = keys[:, 0], nxyz[:, 0]
    n = nxyz.sum(-1).astype(np.float32)
    valid = np.asarray(jax.vmap(lambda k, nn: jc.conv_mult_valid_mask(
        k, nn, 2.0, 200))(jnp.asarray(keys), jnp.asarray(n)))
    assert not valid.all()
    js_ = jc.SampleStream(jnp.asarray(keys), jnp.asarray(nxyz))
    ts_ = tc.SampleStream(torch.as_tensor(keys.astype(np.int64)),
                          torch.as_tensor(nxyz))
    vt = torch.as_tensor(np.array(valid))
    for betas in (GENERAL, ONES):
        b = np.asarray(betas, np.float32)
        np.testing.assert_allclose(
            tc.z_direct_count(ts_, b, valid=vt).numpy(),
            np.asarray(jc.z_direct_count(js_, jnp.asarray(b),
                                         valid=jnp.asarray(valid))),
            rtol=1e-5)
    for a, b in zip(tc.occupancy_stats(ts_, 30, valid=vt),
                    jc.occupancy_stats(js_, 30, valid=jnp.asarray(valid))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _depolarizing(family, d, B, seed, p=0.1):
    jspec = jax_get_spec(family, d)
    s = np.asarray(jax_sample_depolarizing(jax.random.PRNGKey(seed), jspec,
                                           p, (B,)))
    return jspec, spec_from_jax(jspec), s


def test_stdc_streamed_equals_materialised():
    """toric d=3, 150 steps in windows of 64 (the last one 22 steps): the
    same samples, one plain sampler call per window, percentages within
    1e-3; with conv_mult, within 1e-3 on every syndrome whose droplets'
    key buffers never overflowed."""
    _, spec, s = _depolarizing("toric", 3, 3, seed=0)
    kw = dict(droplets=2, steps=150, seed=3, device="cpu")
    mat = STDC(spec, s, 0.1, 0.25, stream=False, **kw)
    sweep_counts.reset()
    ts.stream_timing.reset()
    streamed = STDC(spec, s, 0.1, 0.25, stream=True, stream_window=64, **kw)
    assert (sweep_counts.launches, sweep_counts.plain_calls) == (0, 3)
    # the timing counts windows; it records device time only on a card
    assert ts.stream_timing.windows == 3 and ts.stream_timing.ms() == {}
    np.testing.assert_allclose(streamed, mat, rtol=0, atol=1e-3)
    assert not np.array_equal(mat[0], mat[1])

    seeds = torch.as_tensor(s)
    from mcmc_qec_tpu_torch.decoders.stdc import _class_seeds

    cs = _class_seeds(spec, seeds)
    b = [torch.as_tensor(betas_depolarizing(p), dtype=torch.float32)
         for p in (0.25, 0.1)]
    fn = _get_stdc_stream_fn(spec, 2, 150, True, "off", 2.0, "auto", False,
                             True, 4096, 64)
    out = fn(cs, 3, *b)
    kovf = out[-1].numpy()
    mat_fn = _get_stdc_fn(spec, 2, 150, True, "off", 2.0, "auto",
                          equal_betas=True)
    mat_cm = mat_fn(cs, 3, *b)[0].numpy()
    # a cell's kovf moves every percentage of its syndrome (the softmax)
    ok = ~kovf.any(axis=1)
    assert ok.any()
    np.testing.assert_allclose(out[0].numpy()[ok], mat_cm[ok], rtol=0,
                               atol=1e-3)
    assert not out[-4].numpy().any()  # no Z buffer overflow


def test_strc_streamed_equals_materialised():
    """Equal percentages; and streamed STRC with conv_mult runs to its
    end (the JAX strc.py:234 NameError is not copied)."""
    _, spec, s = _depolarizing("toric", 3, 3, seed=2)
    kw = dict(droplets=2, steps=150, seed=5, device="cpu")
    mat = STRC(spec, s, 0.1, 0.3, stream=False, **kw)
    streamed = STRC(spec, s, 0.1, 0.3, stream=True, stream_window=64, **kw)
    np.testing.assert_array_equal(streamed, mat)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cm = STRC(spec, s, 0.1, 0.3, stream=True, stream_window=64,
                  conv_mult=2.0, **kw)
    assert cm.shape == mat.shape and np.isfinite(cm).all()
    np.testing.assert_allclose(cm.sum(-1), 100.0, rtol=1e-5)


def test_stdc_conv_mult_matches_exact_posterior():
    """tests/test_decoders.py:198 on the port: planar d=3, TV < 0.05, on
    both paths."""
    jspec, spec, s = _depolarizing("planar", 3, 1, seed=5)
    exact = exact_class_posterior(jspec, s[0], betas_depolarizing(0.1),
                                  jax_np_to_class)
    for stream in (False, True):
        distr = STDC(spec, s, 0.1, p_sampling=0.25, droplets=4, steps=1500,
                     conv_mult=2.0, stream=stream, device="cpu")
        tv = 0.5 * np.abs(distr[0] / 100.0 - exact).sum()
        assert tv < 0.05, (stream, tv)


def _caught(fn, *args):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn(*args)
    return [str(x.message) for x in w]


@pytest.mark.parametrize("args", [
    (np.array([[True, False]]), np.array([[3.5, np.inf]]),
     np.array([[0.0, 1.0]]), 100, "STDC", 8),
    (np.zeros((2, 2), bool), np.full((2, 2), np.inf), np.zeros((2, 2)), 100,
     "STDC", 8),
    (np.array([[True]]), np.array([[70.0]]), np.array([[10.0]]), 200_000,
     "STDC", 8),
    (np.array([[True, True]]), np.array([[30.0, 12.0]]),
     np.array([[1.0, 2.0]]), 10**6, "PTDC", 16),
])
def test_stream_overflow_warning_as_jax(args):
    assert _caught(ts.warn_stream_overflow, *args) == \
        _caught(js.warn_stream_overflow, *args)


@pytest.mark.parametrize("kovf", [np.array([[True]]), np.zeros((2, 2), bool),
                                  np.array([[True, False], [True, True]])])
def test_conv_mult_overflow_warning_as_jax(kovf):
    assert _caught(ts.warn_conv_mult_overflow, kovf, "STRC", 4) == \
        _caught(js.warn_conv_mult_overflow, kovf, "STRC", 4)


def test_occupancy_truncation_warning_as_jax():
    from mcmc_qec_tpu.decoders.strc import \
        _warn_occupancy_truncation as jax_warn

    for bad in (np.array([[True, False]]), np.zeros((3, 2), bool)):
        assert _caught(_warn_occupancy_truncation, bad, "STRC", 16) == \
            _caught(jax_warn, bad, "STRC", 16)


def test_decoders_warn_on_small_buffers():
    """A capacity far below the unique-chain count warns (and decodes)."""
    _, spec, s = _depolarizing("toric", 3, 2, seed=2)
    kw = dict(droplets=2, steps=100, stream=True, stream_capacity=4, seed=0,
              device="cpu")
    with pytest.warns(RuntimeWarning, match="stream_capacity=4"):
        STDC(spec, s, 0.1, 0.25, **kw)
    with pytest.warns(RuntimeWarning, match="stream_capacity=4"):
        STRC(spec, s, 0.1, 0.25, **kw)
