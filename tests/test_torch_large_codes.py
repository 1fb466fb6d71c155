"""Codes beyond d=13 in the port, on the CPU.

(a) Each CUDA source instantiates exactly its wrapper's list (the
    ``MQT_SHAPE`` lines of ``csrc/ladder_window.cu``, ``WINDOW_SHAPES``, and
    of ``csrc/sweep.cu``, ``SWEEP_SHAPES``): the sweep kernel has a
    register instantiation for every code up to 16 words per plane, the
    window kernel for every code up to 4.
(b) ``window_forms`` says exactly where ``block_shape`` finds a launch of
    the window kernel's register form and ``wide_block_shape`` one of its
    large variant (from 12 words on no ladder is the register form's
    alone), and ``window_form`` names one of those at every batch;
    ``window_kernel_fits`` is True exactly where either does.
(c) PTEQ at rotated d=15 and toric d=21 and PTEQ_alpha at xzzx d=15 decode
    under the default ``engine="auto"`` in the port and in the JAX package
    on the same syndromes: same shapes, valid distributions, and at p=0.02
    both call the true class on every row (no tolerance).
(d) ``_get_window_fn`` picks the unfused sweep window exactly where the
    predicate says no form of the window kernel holds the ladder (the JAX
    package's fallback), keyed as the JAX cache is, and says so in
    ``PTEQResult.window``; a ladder beyond both forms (1025 rungs, more
    than a block has threads) falls back on its own; a window whose kernel
    fails to build or launch raises and does not fall back, in either
    form.
(e) Above 16 words per plane both kernels' CUDA branches pass their checks
    and launch their large variants (the launch's params and tables seen
    through a stand-in library); the window kernel's refuses, before any
    work and naming the limit, only a ladder no form holds.
"""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import mcmc_qec_tpu.decoders as jd
from mcmc_qec_tpu.models import get_spec as jax_get_spec
import mcmc_qec_tpu_torch.decoders.pteq as pteq_mod
import mcmc_qec_tpu_torch.ops.kernel_tables as kt
import mcmc_qec_tpu_torch.ops.ladder_window as lw
import mcmc_qec_tpu_torch.ops.sweep as sw
from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQ_alpha, PTEQConfig
from mcmc_qec_tpu_torch.models import get_spec, np_eq_class

from test_torch_codes_above_1024 import RecordingLibrary, fake_card

CSRC = Path(lw.__file__).resolve().parent.parent / "csrc"
# the Motivation's inputs: codes the JAX package decodes and the port
# refused before 16 words per plane and the 2-spanned-word shapes
INPUTS = [("rotated", 15, False), ("xzzx", 15, True), ("toric", 21, False)]
# a small ladder at p=0.02 from the decoded state: the burn gate open from
# the first step (tops_burn=0), so the bottom rung's class is counted at
# once
SMALL = dict(Nc=4, max_steps=200, window=100, iters=1, energy_chunk=4,
             tops_burn=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_window_cache():
    pteq_mod._WINDOW_CACHE.clear()
    yield
    pteq_mod._WINDOW_CACHE.clear()


@pytest.mark.parametrize("source", ["ladder_window.cu", "sweep.cu"])
def test_kernel_shapes_are_the_cuda_dispatch_lists(source):
    body = (CSRC / source).read_text().split("#define MQT_SHAPE")[1]
    body = body.split("#undef MQT_SHAPE")[0]
    got = tuple((int(w), int(s))
                for w, s in re.findall(r"^\s*MQT_SHAPE\((\d+), (\d+)\)$", body, re.M))
    if source == "sweep.cu":
        assert got == sw.SWEEP_SHAPES
        assert max(w for w, _ in got) == kt.KERNEL_WORDS[-1] == 16
        assert {w for w, _ in got} == set(kt.KERNEL_WORDS)
    else:
        assert got == lw.WINDOW_SHAPES
        assert {w for w, _ in got} == {1, 2, 3, 4}
        assert set(got) < set(sw.SWEEP_SHAPES)


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_every_code_up_to_1024_qubits_has_an_instantiation(family):
    for d in range(3, 35, 2):
        spec = get_spec(family, d)
        fits = spec.nq <= 1024
        nw, span = kt.kernel_words(spec.nq), kt.spanned_words(spec)
        assert sw.has_sweep_shape(spec) == fits, (family, d)
        assert lw.has_window_shape(spec) == (fits and nw <= 4), (family, d)
        if fits:
            assert (nw, span) in sw.SWEEP_SHAPES
        else:  # the large variants' shape: the code's own word count
            assert nw == -(-spec.nq // 64) > kt.KERNEL_WORDS[-1]
            assert span in (2, 4)
    # past a qubit-table entry's 14-bit qubit index no kernel takes the code
    big = get_spec(family, 91 if family in ("toric", "planar") else 129)
    assert not sw.sweep_kernel_fits(big, False)
    assert not lw.window_kernel_fits(big, 3, True, 2)
    with pytest.raises(ValueError, match="below 16384"):
        kt.qubit_table(big)


@pytest.mark.parametrize("family,d", [("toric", 5), ("xzzx", 13),
                                      ("toric", 19), ("toric", 21),
                                      ("rotated", 27), ("xzzx", 29),
                                      ("xzzx", 31), ("toric", 23)])
def test_predicate_is_where_block_shape_finds_a_launch(family, d):
    spec = get_spec(family, d)
    nd, K = len(spec.logical_draws), spec.n_classes
    offs = kt.kernel_tables(spec)[2]

    def launches(plan, Nc, eq, iters):
        try:
            plan(offs, Nc, K, 512, 132, eq, iters, nd)
            return True
        except ValueError:
            return False

    for Nc in (3, 5, d, 2 * d):
        for eq in (True, False):
            for iters in (1, 2):
                forms = lw.window_forms(spec, Nc, eq, iters)
                assert lw.window_kernel_fits(spec, Nc, eq, iters) == bool(forms)
                registers = lw.has_window_shape(spec) and launches(
                    lw.block_shape, Nc, eq, iters)
                large = launches(lw.wide_block_shape, Nc, eq, iters)
                assert forms == ("registers",) * registers + ("large",) * large, (
                    Nc, eq, iters)
                for B in (1, 512, 4096):
                    form = lw.window_form(spec, Nc, eq, iters, B, 132)
                    assert form in forms if forms else form is None
                # the register form is built up to 4 words (WINDOW_SHAPES),
                # so from 6 words on no ladder falls back to it
                assert large or not registers or offs["nw"] <= 4
    # the register form at 1 word a plane, the large variant from 8 words on
    # (toric d=15, B=512: 50.4 against 177.6 ms a window, ``window_form``)
    assert lw.window_form(get_spec("toric", 5), 5, True, 2, 512, 132) == "registers"
    assert lw.window_form(get_spec("toric", 15), 15, True, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("toric", 19), 19, True, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("toric", 21), 21, True, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("xzzx", 29), 29, False, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("xzzx", 31), 31, False, 2, 512, 132) == "large"
    assert lw.window_form(get_spec("toric", 23), 4, True, 2, 512, 132) == "large"
    assert not lw.window_kernel_fits(get_spec("toric", 5),
                                     kt.WIDE_MAX_THREADS + 1, True, 2)


def _states(spec, B, seed, p=0.02):
    rng = np.random.RandomState(seed)
    s = rng.randint(1, 4, (B, spec.nq)) * (rng.rand(B, spec.nq) < p)
    return (s * spec.valid_mask).astype(np.uint8)


def _decode(pkg, family, d, alpha, s, **cfg):
    if pkg == "jax":
        spec, cfgc, mod, kw = jax_get_spec(family, d), jd.PTEQConfig, jd, {}
    else:
        spec, cfgc, mod = get_spec(family, d), PTEQConfig, pteq_mod
        kw = dict(device="cpu")
    c = cfgc(**SMALL, **cfg)
    if alpha:
        return mod.PTEQ_alpha(spec, s, 0.02, 1.0, cfg=c, **kw)
    return mod.PTEQ(spec, s, 0.02, c, **kw)


@pytest.mark.parametrize("family,d,alpha", INPUTS,
                         ids=[f"{f}-{d}" for f, d, _ in INPUTS])
def test_large_codes_decode_on_the_cpu_in_both_packages(family, d, alpha):
    spec = get_spec(family, d)
    s = _states(spec, 4, seed=7)
    truth = np_eq_class(spec, s)
    ours = _decode("torch", family, d, alpha, s)
    theirs = _decode("jax", family, d, alpha, s)
    assert ours.window == "fused"  # the plain window; the kernel holds it
    for res in (ours, theirs):
        dist = np.asarray(res.distribution)
        assert dist.shape == (4, spec.n_classes) and dist.dtype == np.uint8
        assert bool(((dist.sum(1) > 0) & (dist.sum(1) <= 100)).all())
        np.testing.assert_array_equal(dist.argmax(1), truth)


def test_fallback_follows_the_predicate(monkeypatch):
    """The unfused sweep window runs exactly where the predicate is False,
    under the JAX package's cache key (engine "fused"), and decodes."""
    family, d, alpha = INPUTS[0]
    spec = get_spec(family, d)
    s = _states(spec, 4, seed=8)
    cfg = PTEQConfig(**SMALL)
    asked = []

    def predicate(fits):
        def fn(spec_, Nc, equal_betas, iters):
            asked.append((spec_.size, Nc, equal_betas, iters))
            return fits
        return fn

    for fits, want in ((True, "fused"), (False, "sweep")):
        pteq_mod._WINDOW_CACHE.clear()
        asked.clear()
        monkeypatch.setattr(pteq_mod, "window_kernel_fits", predicate(fits))
        fn = pteq_mod._get_window_fn(spec, 4, cfg, equal_betas=True)
        assert fn.engine == want
        assert asked == [(d, 4, True, cfg.iters)]
        key, = pteq_mod._WINDOW_CACHE
        assert "fused" in key and "sweep" not in key
        res = PTEQ(spec, s, 0.02, cfg, device="cpu")
        assert res.window == want
        np.testing.assert_array_equal(res.distribution.argmax(1),
                                      np_eq_class(spec, s))
    # an unfused engine asked for by name never consults the predicate
    asked.clear()
    fn = pteq_mod._get_window_fn(spec, 4, PTEQConfig(**SMALL, engine="sweep"))
    assert fn.engine == "sweep" and asked == []


def test_a_code_the_kernel_cannot_hold_falls_back():
    """Toric d=3 at 1025 rungs and two sweeps a step: more rungs than a
    block of the large variant has threads, so neither form of the window
    kernel holds the ladder and PTEQ runs the unfused sweep window."""
    spec = get_spec("toric", 3)
    Nc = kt.WIDE_MAX_THREADS + 1
    assert not lw.window_kernel_fits(spec, Nc, True, 2)
    s = _states(spec, 2, seed=9, p=0.1)
    cfg = PTEQConfig(Nc=Nc, max_steps=24, window=12, iters=2, energy_chunk=12,
                     tops_burn=0)
    res = PTEQ(spec, s, 0.02, cfg, device="cpu")
    assert res.window == "sweep"
    assert res.distribution.shape == (2, spec.n_classes)
    np.testing.assert_array_equal(res.distribution.argmax(1), np_eq_class(spec, s))


@pytest.mark.parametrize("family,d", [("rotated", 15), ("toric", 21),
                                      ("toric", 23)])
@pytest.mark.parametrize("error", [
    "nvcc failed (build)",
    "ladder_window kernel launch failed: cudaError 209",
])
def test_a_failing_kernel_raises_and_does_not_fall_back(monkeypatch, error,
                                                        family, d):
    """Where the predicate says a form of the kernel holds the window (the
    register form at rotated d=15, the large variant at toric d=21 and
    d=23), a
    failure to build or launch it reaches the caller: no ``try`` turns it
    into the unfused window."""
    def failing(*args, **kwargs):
        def fn(*a):
            raise RuntimeError(error)
        return fn

    def no_fallback(*args, **kwargs):
        raise AssertionError("the unfused window was built")

    monkeypatch.setattr(pteq_mod, "make_ladder_window", failing)
    monkeypatch.setattr(pteq_mod, "_unfused_window", no_fallback)
    spec = get_spec(family, d)
    assert lw.window_kernel_fits(spec, SMALL["Nc"], True, SMALL["iters"])
    with pytest.raises(RuntimeError, match=re.escape(error)):
        PTEQ(spec, _states(spec, 2, seed=10), 0.02, PTEQConfig(**SMALL),
             device="cpu")


class WindowLibrary:
    """The window library's entry point without a card: records each
    launch's params and returns 0 (success)."""

    def __init__(self):
        self.params = []

    def mqt_ladder_window(self, P, bufs, stream):
        self.params.append({n: getattr(P._obj, n) for n, _ in P._obj._fields_})
        return 0


def test_the_card_path_refuses_codes_above_1024_qubits(monkeypatch):
    """The window kernel's CUDA branch takes toric d=23 (17 words per
    plane) in its large variant: its checks pass and it launches with the
    code's word count, its qubit table's entries, the meta before the
    spanned-word entries and the plan's shared memory.  It refuses, before any work and naming the limit, only a
    ladder no form holds: a code past 256 words per plane (planar d=91,
    nq=16562) or more rungs than a block has threads.  The plain version
    runs both windows."""
    spec = get_spec("toric", 23)
    fake = WindowLibrary()
    monkeypatch.setattr(lw, "_kernel_entry", lambda: fake.mqt_ladder_window)
    monkeypatch.setattr(lw, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    B, Nc = 5, 3
    args = (torch.zeros((B, Nc, spec.nq), dtype=torch.uint8),
            torch.zeros((B, Nc), dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros((B, spec.n_classes), dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32), 0, torch.zeros((Nc, 3)),
            np.ones(3, np.float32))
    kw = dict(window=4, iters=1, p_logical=0.5, tops_burn=0, energy_chunk=4,
              top_exact=True, equal_betas=True, exchange="sequential",
              track_traces=False, fixed=None)
    lw.ladder_window_counts.reset()
    tables = {}
    out = lw._launch(spec, *args, device_tables=tables, **kw)
    assert lw.ladder_window_counts.launches == 1
    P, = fake.params
    offs = kt.kernel_tables(spec)[2]
    assert (P["wide"], P["nw"], P["n_tab"], P["n_meta"]) == (
        1, 17, spec.n_stabs, offs["m_span"])
    shape = lw.wide_block_shape(offs, Nc, spec.n_classes, B, 132, True, 1,
                                len(spec.logical_draws))
    assert (P["lanes"], P["smem"]) == (shape.lanes, shape.smem)
    assert out[0].shape == (B, Nc, spec.nq)
    _, meta = tables[torch.device("cpu")]
    assert len(meta) == offs["n_meta"] > offs["m_span"]
    # the qubit table is built for the large variant, which alone reads it
    assert len(tables[torch.device("cpu"), "qubits"]) == spec.n_stabs
    for big, n in ((get_spec("planar", 91), 3),
                   (get_spec("toric", 5), kt.WIDE_MAX_THREADS + 1)):
        state = torch.zeros((1, n, big.nq), dtype=torch.uint8)
        with pytest.raises(ValueError, match=f"nq={big.nq}.*nq <= 16384"):
            lw._launch(big, state, *[None] * 7, device_tables={}, **kw)
    assert fake.params == [P] and lw.ladder_window_counts.launches == 1
    state = args[0][:1]
    out = lw.make_ladder_window(spec, Nc, 4, 1, 0.5, 0, 4, top_exact=True,
                                equal_betas=True, rng="zeros")(
        state, *(a[:1] for a in args[1:5]), 0, args[6], args[7])
    assert out[0].shape == state.shape


@pytest.mark.parametrize("record", [False, True])
def test_the_sweep_kernel_takes_codes_above_1024_qubits(monkeypatch, record):
    """Toric d=23 (17 words per plane): the sweep kernel's CUDA branch
    passes its checks and launches the large variant (the word count and
    its 4 spanned words a stabilizer in the params, the qubit table and a
    meta of color starts in the buffers it is handed, its own thread count
    from ``wide_block``), where the window kernel refuses."""
    import mcmc_qec_tpu_torch.ops.sweep as sw

    spec = get_spec("toric", 23)
    assert sw.sweep_kernel_fits(spec, record) and kt.is_wide(spec)
    fake = RecordingLibrary()
    states = torch.zeros((5, spec.nq), dtype=torch.uint8)
    tables = {}
    seeds = torch.zeros(3, dtype=torch.int64) if record else None
    with fake_card(monkeypatch, lambda: fake):
        out = sw._launch(spec, states, torch.ones(3), steps=3 if record else 1,
                         iters=1, equal_betas=True, seeds=seeds,
                         device_tables=tables)
    assert sw.sweep_counts.launches == 1
    P, = fake.params
    assert (P["nw"], P["span"], P["nq"], P["record"]) == (17, 4, 1058, int(record))
    assert (P["lanes"], P["threads"] // 32) == sw.wide_block(spec, record, 5, 132)
    plan = sw.sweep_plan(spec, record, P["lanes"], P["threads"] // 32)
    assert P["smem"] == plan.smem <= kt.SMEM_LIMIT
    assert P["threads"] == plan.threads <= kt.WIDE_MAX_THREADS
    # a chain's slot: 2 bits a qubit, 4 * 17 + 1 words of 32 bits
    assert P["region_bytes"] >= plan.chains_per_warp * 4 * (4 * 17 + 1)
    tab, meta, _, qtab = tables[states.device]
    assert tab is None and len(meta) == len(spec.color_stabs) + 1
    np.testing.assert_array_equal(qtab.numpy(), kt.qubit_table(spec))
    if record:
        assert [t.shape for t in out[1:]] == [(5, 3, 2), (5, 3, 3)]
