"""Codes above 1024 qubits in the port, on the CPU: the sweep kernel's
large variant (csrc/sweep.cu::sweep_kernel_wide, above 16 words per plane)
through what the CPU can reach of it.

(a) The wide spanned-word entries (ops/ladder_window.py::kernel_tables,
    ``_pack_span``/``unpack_span``) round-trip and list exactly the words
    each stabilizer's support spans, computed from the spec, at toric
    d=23, 33 and 45, planar d=23, rotated and XZZX d=33 and 63.
(b) A numpy emulation of the large variant on u64 planes, through the
    packed tables only (unpack by 32-qubit ballots, each color decided on
    the planes before it, then the accepted ops XORed in, pack), equals
    ``sweep_reference`` bit for bit on the same Philox draws
    (``_draw_words``) at toric d=23 and rotated d=33, equal and general
    betas, a shared row and a row per chain; its recording step (three
    unpacked counts, the hash over the lanes' shares) equals
    ``count_errors_xyz`` and ``pack_key``.
(c) ``sweep_reference`` with injected uniforms equals
    ``make_pallas_sweep(..., interpret=True)`` bit for bit at toric d=23
    and rotated d=33 in both branches, and the port's ``make_dense_sweep``
    equals the JAX one on the same injected uniforms.
(d) The slice as a whole: STDC at toric d=23, p=0.02, on the same 8
    syndromes through both packages (each recovers at least 7 and they
    agree on at least 7 argmaxes); PTEQ at toric d=23 with
    ``engine="sweep"`` runs the unfused window (one sweep call a ladder
    step, no window-kernel call) and its window keeps every rung's
    syndrome.
(e) ``sweep_kernel_fits`` is exactly where ``sweep_plan`` finds a launch,
    for every family up to the limit (256 words per plane) and past it;
    above it ``_launch`` raises before any work, and a failing build or
    launch raises without running the plain version.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcmc_qec_tpu.decoders as jd
from mcmc_qec_tpu.mcmc.ladder import betas_xyz
from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep as jax_dense_sweep
from mcmc_qec_tpu.ops.pallas_sweep import make_pallas_sweep
import mcmc_qec_tpu_torch.decoders.pteq as pteq_mod
import mcmc_qec_tpu_torch.ops.ladder_window as lw
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, STDC, PTEQConfig
from mcmc_qec_tpu_torch.mcmc.ladder import beta_ladder_depolarizing, init_ladder
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class, np_syndrome
from mcmc_qec_tpu_torch.ops.dense_sweep import make_dense_sweep
from mcmc_qec_tpu_torch.ops.pauli import count_errors_xyz, make_hash_mults, pack_key
from mcmc_qec_tpu_torch.ops.philox import MASK32

from test_torch_sweep import _pallas_logu

WIDE = [("toric", 23), ("toric", 33), ("toric", 45), ("planar", 23),
        ("rotated", 33), ("rotated", 63), ("xzzx", 33), ("xzzx", 63)]
EMULATED = [("toric", 23), ("rotated", 33)]
# the largest distance of each family the card takes (nq <= 16384)
LARGEST = {"toric": 89, "planar": 89, "rotated": 127, "xzzx": 127}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(spec, B, seed, p=0.3):
    rng = np.random.RandomState(seed)
    s = rng.randint(1, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


def _table_order(spec):
    """The stabilizers in the tables' order (by color)."""
    return [int(s) for color in spec.color_stabs for s in color
            if s < spec.n_stabs]


# ---------------------------------------------------------------------------
# (a) the wide spanned-word entries
# ---------------------------------------------------------------------------


def test_pack_span_is_narrow_up_to_16_words_and_wide_above():
    v, w = lw._pack_span([3, 15], 2, 1, 16)
    assert v == 2 | 2 << 4 | 1 << 8 | 3 << 12 | 15 << 16  # the form K2 reads
    assert w == 3 | 15 << 8
    assert lw.unpack_span(v) == lw.unpack_span(v, w) == ([3, 15], 2, 1)
    v, w = lw._pack_span([16, 17, 62, 63], 4, 0, 64)
    assert v == 4 | 4 << 4  # no 4-bit index above 16 words
    assert lw.unpack_span(v, w) == ([16, 17, 62, 63], 4, 0)
    v, w = lw._pack_span([255], 1, 1, 256)
    assert lw.unpack_span(v, w)[0] == [255] and w == 255
    with pytest.raises(ValueError, match="below 256"):
        lw._pack_span([256], 1, 1, 257)


@pytest.mark.parametrize("family,d", WIDE, ids=[f"{f}-{d}" for f, d in WIDE])
def test_wide_entries_list_the_spanned_words(family, d):
    spec = get_spec(family, d)
    tab, meta, offs = lw.kernel_tables(spec)
    n, nw, S = spec.n_stabs, offs["nw"], offs["span"]
    assert nw == -(-spec.nq // 64) > lw.KERNEL_WORDS[-1]
    assert S == lw.spanned_words(spec) in (2, 4)
    assert offs["m_wide"] + n == offs["n_meta"] == len(meta)
    heads = meta[offs["m_span"]: offs["m_span"] + n].astype(np.int64)
    wides = meta[offs["m_wide"]:].view(np.uint32).astype(np.int64)
    span = tab[offs["off_span"]:].view(np.uint64).reshape(n, S, 3)
    one = np.uint64(1)
    for i, s in enumerate(_table_order(spec)):
        ops = spec.stab_ops[s].astype(np.int64)
        qs = spec.stab_qubits[s][ops != 0]
        ops = ops[ops != 0]
        xq = qs[((ops & 1) ^ (ops >> 1)) == 1]  # qubits the op flips in X
        zq = qs[(ops >> 1) == 1]
        words = sorted({int(q) // 64 for q in qs})
        got = lw.unpack_span(int(heads[i]), int(wides[i]))
        assert got == (words, len(xq), len(zq)), (i, s)
        assert heads[i] >> 12 == 0
        assert lw._pack_span(words, len(xq), len(zq), nw) == (heads[i], wides[i])
        for m, w in enumerate(words):
            want = [np.bitwise_or.reduce([one << np.uint64(q % 64) for q in g
                                          if q // 64 == w] or [np.uint64(0)])
                    for g in (qs, xq, zq)]
            np.testing.assert_array_equal(span[i, m], want)
        assert not span[i, len(words):].any()


# ---------------------------------------------------------------------------
# (b) a numpy emulation of the large variant against sweep_reference
# ---------------------------------------------------------------------------


def _popc(a):
    return np.bitwise_count(a).astype(np.int64)


def _unpack(spec, states):
    """The kernel's unpack: per 32-qubit chunk k, the ballots of the X and Z
    bits are the 32-bit halves 2w, 2w + 1 of plane word w."""
    nw = lw.kernel_words(spec.nq)
    v = np.zeros((states.shape[0], 64 * nw), np.uint32)
    v[:, : spec.nq] = states
    shifts = np.arange(32, dtype=np.uint32)
    planes = []
    for bit in ((v ^ (v >> 1)) & 1, (v >> 1) & 1):
        halves = (bit.reshape(len(v), 2 * nw, 32) << shifts).sum(-1, dtype=np.uint32)
        planes.append(np.ascontiguousarray(halves).view(np.uint64))
    return planes


def _pack(spec, X, Z):
    q = np.arange(spec.nq)
    w, k = q // 64, (q % 64).astype(np.uint64)
    x = (X[:, w] >> k) & np.uint64(1)
    z = (Z[:, w] >> k) & np.uint64(1)
    return (x ^ (np.uint64(3) * z)).astype(np.uint8)


def _emulate_wide(spec, states, seed, betas, n_sweeps, equal_betas):
    """``n_sweeps`` sweeps of the large variant on u64 planes, read through
    the kernel's tables only: per color, every stabilizer decided on the
    planes before the color, with proposal_logr's f32 arithmetic, then the
    accepted ops XORed in (the atomicXor of the kernel)."""
    tab, meta, offs = lw.kernel_tables(spec)
    n, S, n_colors = spec.n_stabs, offs["span"], offs["n_colors"]
    ent = tab[offs["off_span"]:].view(np.uint64).reshape(n, S, 3)
    heads = meta[offs["m_span"]: offs["m_span"] + n].astype(np.int64)
    wides = meta[offs["m_wide"]:].view(np.uint32).astype(np.int64)
    words = (wides[:, None] >> (8 * np.arange(S))) & 255  # (n, S)
    cx, cz = (heads >> 4) & 15, (heads >> 8) & 15
    starts = meta[: n_colors + 1]
    B = len(states)
    b = np.asarray(betas, np.float32).reshape(-1, 3)
    bx, by, bz = (b[:, i:i + 1] for i in range(3))  # (1 or B, 1) columns
    n_blocks = -(-sw.stab_width(spec) // 4)
    bits = lw._draw_words(seed & MASK32, (seed >> 32) & MASK32, 0, n_sweeps, B,
                          0, n_colors, n_blocks, None, "cpu") >> 8
    # the uniforms' logarithms as the plain version forms them (torch.log)
    lu = torch.log(bits.to(torch.float32) * torch.tensor(2.0 ** -24)
                   + torch.tensor(1e-12)).numpy()
    X, Z = _unpack(spec, states)
    rows = np.arange(B)[:, None, None]
    for t in range(n_sweeps):
        for c in range(n_colors):
            c0, c1 = int(starts[c]), int(starts[c + 1])
            W = words[c0:c1]  # (m, S)
            su, xm, zm = (ent[c0:c1, :, i] for i in range(3))
            x, z = X[:, W], Z[:, W]  # (B, m, S)
            if equal_betas:
                d0 = (_popc(((x ^ xm) | (z ^ zm)) & su) - _popc((x | z) & su)).sum(-1)
                logr = -(bx * d0.astype(np.float32))
            else:
                tx, tz = _popc(x & xm).sum(-1), _popc(z & zm).sum(-1)
                d0 = (_popc((x ^ xm) & (z ^ zm) & su) - _popc(x & z & su)).sum(-1)
                d1 = ((cx[c0:c1] - 2 * tx) - d0).astype(np.float32)
                d3 = ((cz[c0:c1] - 2 * tz) - d0).astype(np.float32)
                logr = -((bx * d1 + by * d0.astype(np.float32)) + bz * d3)
            assert logr.dtype == np.float32
            acc = (logr >= 0) | (lu[t, :, c, : c1 - c0] < logr)  # (B, m)
            keep = np.where(acc[..., None], np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(0))
            idx = (np.broadcast_to(rows, x.shape), np.broadcast_to(W, x.shape))
            np.bitwise_xor.at(X, idx, xm & keep)
            np.bitwise_xor.at(Z, idx, zm & keep)
    return X, Z


@pytest.mark.parametrize("betas", ["equal", "general", "per-chain"])
@pytest.mark.parametrize("family,d", EMULATED, ids=[f"{f}-{d}" for f, d in EMULATED])
def test_emulated_large_variant_equals_the_plain_sweep(family, d, betas):
    spec = get_spec(family, d)
    B, n_sweeps, seed = 6, 2, (5 << 32) | 0x1234567
    states = _states(spec, B, seed=d, p=0.2)
    eq = betas == "equal"
    row = (np.full(3, 0.9, np.float32) if eq
           else betas_xyz(0.05, 0.02, 0.1).astype(np.float32))
    if betas == "per-chain":
        row = np.random.RandomState(d).uniform(0.2, 3.0, (B, 3)).astype(np.float32)
    X, Z = _emulate_wide(spec, states, seed, row, n_sweeps, eq)
    ours = sw.sweep_reference(spec, torch.as_tensor(states), seed,
                              torch.as_tensor(row), n_sweeps, eq).numpy()
    np.testing.assert_array_equal(_pack(spec, X, Z), ours)
    assert not np.array_equal(ours, states), "the chains never moved"
    assert (np_syndrome(spec, ours) == np_syndrome(spec, states)).all()


@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_emulated_recording_step_equals_pack_key_and_counts(lanes):
    """csrc/sweep.cu::record_step_wide: lane l popcounts the words w = l,
    l + L, ... into three 32-bit counts and hashes the qubits 64w + k with k
    = l, l + L, ... in wraparound u32; the add butterfly sums the lanes."""
    spec = get_spec("toric", 45)
    states = _states(spec, 4, seed=3, p=0.9)
    states[0] = 3 * spec.valid_mask  # every qubit Z: a count of 4050
    X, Z = _unpack(spec, states)
    nw, nq, L = X.shape[1], spec.nq, lanes
    m = make_hash_mults(spec)
    h, cnt = np.zeros((2, 4), np.uint32), np.zeros((3, 4), np.int64)
    for lane in range(L):
        for w in range(lane, nw, L):
            x, z = X[:, w], Z[:, w]
            cnt += [_popc(x & ~z), _popc(x & z), _popc(~x & z)]
        for w in range(nw):
            k = np.arange(lane, min(64, nq - 64 * w), L)
            a, z = X[:, w] ^ Z[:, w], Z[:, w]
            v = (((a[:, None] >> k.astype(np.uint64)) & np.uint64(1))
                 + np.uint64(2) * ((z[:, None] >> k.astype(np.uint64)) & np.uint64(1)))
            for i in range(2):
                h[i] += (m[i, 64 * w + k] * v.astype(np.uint32)).sum(-1, dtype=np.uint32)
    t = torch.as_tensor(states)
    np.testing.assert_array_equal(cnt.T, count_errors_xyz(t).numpy())
    np.testing.assert_array_equal(h.T.astype(np.int64), pack_key(spec, t, m).numpy())
    assert cnt[2, 0] == nq > 1023  # past the register path's 10-bit fields
    np.testing.assert_array_equal(_pack(spec, X, Z), states)


# ---------------------------------------------------------------------------
# (c) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("equal_betas", [True, False])
@pytest.mark.parametrize("family,d", EMULATED, ids=[f"{f}-{d}" for f, d in EMULATED])
def test_plain_equals_pallas_interpret_above_1024_qubits(family, d, equal_betas):
    jspec = jax_get_spec(family, d)
    spec = spec_from_jax(jspec)
    B, n_sweeps, batch_tile, seed = 8, 2, 8, 7
    states = _states(spec, B, seed=d + 11)
    betas = (np.full(3, 0.9, np.float32) if equal_betas
             else betas_xyz(0.05, 0.02, 0.1).astype(np.float32))
    fn, _ = make_pallas_sweep(jspec, n_sweeps=n_sweeps, batch_tile=batch_tile,
                              interpret=True, equal_betas=equal_betas)
    theirs = np.asarray(fn(jnp.asarray(states), seed, jnp.asarray(betas)))
    logu = _pallas_logu(jspec, B, n_sweeps, batch_tile, seed)
    ours = sw.sweep_reference(spec, torch.as_tensor(states), 0, betas, n_sweeps,
                              equal_betas, logu=logu).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, states), "the chains never moved"


def test_dense_sweep_equals_jax_above_1024_qubits():
    """Two sweeps of a (2, 3) batch of toric d=23 at a row of betas per
    chain, under the uniforms JAX's ``make_dense_sweep`` draws."""
    jspec = jax_get_spec("toric", 23)
    spec = spec_from_jax(jspec)
    shape = (2, 3)
    states = _states(spec, 6, seed=4, p=0.2).reshape(shape + (spec.nq,))
    betas = np.random.RandomState(5).uniform(0.3, 3.0, shape + (3,)).astype(np.float32)
    n_colors, W = len(spec.color_stabs), sw.stab_width(spec)
    jsweep = jax.jit(jax_dense_sweep(jspec))
    sweep = make_dense_sweep(spec)
    js, ts = jnp.asarray(states), torch.as_tensor(states)
    key = jax.random.PRNGKey(6)
    for _ in range(2):
        key, k = jax.random.split(key)
        logu = np.array(jnp.log(jax.random.uniform(
            k, (n_colors,) + shape + (W,), minval=1e-38)))
        js = jsweep(js, k, jnp.asarray(betas))
        ts = sweep(ts, 0, torch.as_tensor(betas), logu=torch.as_tensor(logu))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not np.array_equal(ts.numpy(), states)


# ---------------------------------------------------------------------------
# (d) the slice as a whole
# ---------------------------------------------------------------------------


def test_stdc_at_toric_d23_in_both_packages():
    """STDC at p_sampling 0.2, 2 droplets, 300 steps (the spread of this
    budget over seeds is about one syndrome in eight in either package)."""
    spec = get_spec("toric", 23)
    s = _states(spec, 8, seed=23, p=0.02)
    truth = np_eq_class(spec, s)
    kw = dict(droplets=2, steps=300)
    ours = STDC(spec, s, 0.02, 0.2, device="cpu", **kw).argmax(1)
    theirs = np.asarray(jd.STDC(jax_get_spec("toric", 23), s, 0.02, 0.2,
                                **kw)).argmax(1)
    assert (ours == truth).sum() >= 7 and (theirs == truth).sum() >= 7
    assert (ours == theirs).sum() >= 7


def test_pteq_at_toric_d23_runs_the_unfused_window():
    spec = get_spec("toric", 23)
    Nc, W, B, p = 3, 8, 2, 0.02
    s = _states(spec, B, seed=24, p=p)
    # the unfused window asked for by name (the window kernel's large
    # variant holds this ladder, tests/test_torch_window_above_1024.py)
    cfg = PTEQConfig(Nc=Nc, max_steps=W, window=W, iters=1, energy_chunk=4,
                     tops_burn=0, engine="sweep")
    pteq_mod._WINDOW_CACHE.clear()
    lw.ladder_window_counts.reset()
    sw.sweep_counts.reset()
    res = PTEQ(spec, s, p, cfg, device="cpu")
    assert res.window == "sweep"  # the unfused window, on the sweep kernel
    assert res.distribution.shape == (B, spec.n_classes)
    assert lw.ladder_window_counts.plain_calls == 0
    assert sw.sweep_counts.plain_calls == W  # one sweep call a ladder step
    # the window keeps every rung's syndrome
    fn = pteq_mod._get_window_fn(spec, Nc, cfg, equal_betas=True)
    ls = init_ladder(spec, torch.as_tensor(s), Nc)
    out = fn(ls, 5, torch.as_tensor(beta_ladder_depolarizing(p, Nc),
                                    dtype=torch.float32),
             torch.zeros((B, spec.n_classes), dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32), np.ones(3, np.float32))
    state = out[0].state.numpy()
    assert not np.array_equal(state, np.asarray(ls.state))
    for r in range(Nc):
        assert (np_syndrome(spec, state[:, r]) == np_syndrome(spec, s)).all()
    pteq_mod._WINDOW_CACHE.clear()


# ---------------------------------------------------------------------------
# (e) the predicate, the limit and no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(LARGEST))
def test_predicate_is_where_sweep_plan_finds_a_launch(family):
    top = LARGEST[family]
    for d in (5, 21, 23, 33, 63, top, top + 2):
        spec = get_spec(family, d)
        assert (d <= top) == (spec.nq <= 64 * sw.MAX_WORDS)
        for record in (True, False):
            fits = sw.sweep_kernel_fits(spec, record)
            launches = []
            for L in (1, 2, 4, 8, 16, 32):
                try:
                    plan = sw.sweep_plan(spec, record, L)
                except ValueError:
                    continue
                launches.append(L)
                assert plan.smem <= lw.SMEM_LIMIT
            assert fits == bool(launches) == (d <= top), (d, record)
            if fits:  # every lane count from the fewest up
                least = sw.least_lanes(spec, record)
                assert launches == [L for L in (1, 2, 4, 8, 16, 32) if L >= least]


def _no_library():
    raise AssertionError("the kernel was built or loaded")


class RecordingLibrary:
    """The sweep library's entry point without a card: records each
    launch's params and returns ``err`` (0: success)."""

    def __init__(self, err=0):
        self.params, self.err = [], err

    def mqt_sweep(self, P, bufs, stream):
        self.params.append({n: getattr(P._obj, n) for n, _ in P._obj._fields_})
        return self.err


@contextlib.contextmanager
def fake_card(monkeypatch, library):
    """The sweep wrapper's CUDA branch on CPU tensors: ``library()`` stands
    in for the built library; no plain call may happen."""
    monkeypatch.setattr(sw, "_library", library)
    monkeypatch.setattr(sw, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    sw.sweep_counts.reset()
    yield
    assert sw.sweep_counts.plain_calls == 0


def test_launch_above_the_limit_raises_before_any_work(monkeypatch):
    spec = get_spec("planar", LARGEST["planar"] + 2)
    states = torch.zeros((2, spec.nq), dtype=torch.uint8)
    with fake_card(monkeypatch, _no_library):
        for seeds in (None, torch.zeros(2, dtype=torch.int64)):
            with pytest.raises(ValueError, match=f"nq={spec.nq}.*nq <= 16384"):
                sw._launch(spec, states, torch.ones(3), steps=2, iters=1,
                           equal_betas=True, seeds=seeds, device_tables={})
    assert sw.sweep_counts.launches == 0


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_a_failing_large_variant_raises(monkeypatch, failure):
    def broken_build():
        raise RuntimeError("nvcc failed (build)")

    lib = RecordingLibrary(err=209)
    spec = get_spec("toric", 23)
    states = torch.as_tensor(_states(spec, 3, seed=1))
    with fake_card(monkeypatch, broken_build if failure == "build" else lambda: lib):
        want = ("nvcc failed" if failure == "build"
                else "sweep kernel launch failed: cudaError 209")
        with pytest.raises(RuntimeError, match=want):
            sw._launch(spec, states, torch.ones(3), steps=1, iters=2,
                       equal_betas=True, device_tables={})
    assert sw.sweep_counts.launches == 0
