"""Codes beyond d=13 in the port, on the CPU.

(a) ``KERNEL_SHAPES`` is exactly the list both CUDA sources instantiate
    (the ``MQT_SHAPE`` lines of ``csrc/ladder_window.cu`` and
    ``csrc/sweep.cu``), and every code up to 16 words per plane has one.
(b) ``window_kernel_fits`` says exactly where ``block_shape`` finds a
    launch of the window kernel.
(c) PTEQ at rotated d=15 and toric d=21 and PTEQ_alpha at xzzx d=15 decode
    under the default ``engine="auto"`` in the port and in the JAX package
    on the same syndromes: same shapes, valid distributions, and at p=0.02
    both call the true class on every row (no tolerance).
(d) ``_get_window_fn`` picks the unfused sweep window exactly where the
    predicate says the window kernel cannot hold the ladder (the JAX
    package's fallback), keyed as the JAX cache is, and says so in
    ``PTEQResult.window``; a code the kernel cannot hold (xzzx d=31 at 31
    rungs) falls back on its own; a window whose kernel fails to build or
    launch raises and does not fall back.
(e) Above 16 words per plane the window kernel's CUDA branch refuses the
    code before any work, while the sweep kernel's passes its checks and
    launches its large variant (the launch's params and tables seen
    through a stand-in library).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mcmc_qec_tpu.decoders as jd
from mcmc_qec_tpu.models import get_spec as jax_get_spec
import mcmc_qec_tpu_torch.decoders.pteq as pteq_mod
import mcmc_qec_tpu_torch.ops.ladder_window as lw
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
    assert got == lw.KERNEL_SHAPES
    assert max(w for w, _ in got) == lw.KERNEL_WORDS[-1] == 16
    assert {w for w, _ in got} == set(lw.KERNEL_WORDS)


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_every_code_up_to_1024_qubits_has_an_instantiation(family):
    for d in range(3, 35, 2):
        spec = get_spec(family, d)
        fits = spec.nq <= 1024
        assert lw.has_kernel_shape(spec) == fits, (family, d)
        if fits:
            assert lw.kernel_shape(spec) in lw.KERNEL_SHAPES
        else:
            with pytest.raises(ValueError, match="nq <= 1024"):
                lw.kernel_shape(spec)


@pytest.mark.parametrize("family,d", [("toric", 5), ("xzzx", 13),
                                      ("toric", 19), ("toric", 21),
                                      ("rotated", 27), ("xzzx", 29),
                                      ("xzzx", 31), ("toric", 23)])
def test_predicate_is_where_block_shape_finds_a_launch(family, d):
    spec = get_spec(family, d)
    nd, K = len(spec.logical_draws), spec.n_classes
    for Nc in (3, 5, d, 2 * d):
        for eq in (True, False):
            for iters in (1, 2):
                fits = lw.window_kernel_fits(spec, Nc, eq, iters)
                if not lw.has_kernel_shape(spec):
                    assert not fits
                    continue
                offs = lw.kernel_tables(spec)[2]
                try:
                    lw.block_shape(offs, Nc, K, 512, 132, eq, iters, nd)
                    launches = True
                except ValueError:
                    launches = False
                assert fits == launches, (Nc, eq, iters)
    # the largest ladders the kernel holds, and one it does not
    assert lw.window_kernel_fits(get_spec("toric", 21), 21, True, 2)
    assert lw.window_kernel_fits(get_spec("xzzx", 29), 29, False, 2)
    assert not lw.window_kernel_fits(get_spec("xzzx", 31), 31, False, 2)
    assert not lw.window_kernel_fits(get_spec("toric", 23), 4, True, 2)


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
    """xzzx d=31 at its default 31 rungs and two sweeps a step: no block of
    the window kernel holds the ladder, so PTEQ_alpha runs the unfused
    sweep window."""
    spec = get_spec("xzzx", 31)
    assert not lw.window_kernel_fits(spec, 31, False, 2)
    s = _states(spec, 2, seed=9)
    cfg = PTEQConfig(max_steps=24, window=12, iters=2, energy_chunk=12,
                     tops_burn=0)
    res = PTEQ_alpha(spec, s, 0.02, 1.0, cfg=cfg, device="cpu")
    assert res.window == "sweep"
    assert res.distribution.shape == (2, spec.n_classes)
    np.testing.assert_array_equal(res.distribution.argmax(1), np_eq_class(spec, s))


@pytest.mark.parametrize("error", [
    "nvcc failed (build)",
    "ladder_window kernel launch failed: cudaError 209",
])
def test_a_failing_kernel_raises_and_does_not_fall_back(monkeypatch, error):
    """Where the predicate says the kernel holds the window, a failure to
    build or launch it reaches the caller: no ``try`` turns it into the
    unfused window."""
    def failing(*args, **kwargs):
        def fn(*a):
            raise RuntimeError(error)
        return fn

    def no_fallback(*args, **kwargs):
        raise AssertionError("the unfused window was built")

    monkeypatch.setattr(pteq_mod, "make_ladder_window", failing)
    monkeypatch.setattr(pteq_mod, "_unfused_window", no_fallback)
    spec = get_spec("rotated", 15)
    with pytest.raises(RuntimeError, match=re.escape(error)):
        PTEQ(spec, _states(spec, 2, seed=10), 0.02, PTEQConfig(**SMALL),
             device="cpu")


def test_the_card_path_refuses_codes_above_1024_qubits():
    """Above 16 words per plane (toric and planar d >= 23) the window
    kernel's CUDA branch raises before any work, naming the largest nq it
    takes; its plain version still runs the window.  The sweep kernel takes
    such codes in its large variant
    (``test_the_sweep_kernel_takes_codes_above_1024_qubits``)."""
    spec = get_spec("toric", 23)
    state = torch.zeros((1, 3, spec.nq), dtype=torch.uint8)
    with pytest.raises(ValueError, match="nq=1058.*nq <= 1024"):
        lw._launch(spec, state, *[None] * 7, window=1, iters=1, p_logical=0.5,
                   tops_burn=0, energy_chunk=1, top_exact=True,
                   equal_betas=True, exchange="sequential",
                   track_traces=False, fixed=None, device_tables={})
    assert not lw.has_kernel_shape(spec)
    assert not lw.window_kernel_fits(spec, 3, True, 1)
    out = lw.make_ladder_window(spec, 3, 4, 1, 0.5, 0, 4, top_exact=True,
                                equal_betas=True, rng="zeros")(
        state, torch.zeros((1, 3), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.zeros((1, spec.n_classes), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), 0,
        torch.zeros((3, 3)), np.ones(3, np.float32))
    assert out[0].shape == state.shape


@pytest.mark.parametrize("record", [False, True])
def test_the_sweep_kernel_takes_codes_above_1024_qubits(monkeypatch, record):
    """Toric d=23 (17 words per plane): the sweep kernel's CUDA branch
    passes its checks and launches the large variant (the word count and
    its 4 spanned words a stabilizer in the params, the wide entries in
    the meta it is handed), where the window kernel refuses."""
    import mcmc_qec_tpu_torch.ops.sweep as sw

    spec = get_spec("toric", 23)
    assert sw.sweep_kernel_fits(spec, record) and lw.is_wide(spec)
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
    plan = sw.sweep_plan(spec, record, P["lanes"])
    assert P["smem"] == plan.smem <= lw.SMEM_LIMIT
    assert P["region_bytes"] >= plan.chains_per_warp * 8 * (2 * 17 + 1)
    _, meta, _ = tables[states.device]
    assert len(meta) == len(spec.color_stabs) + 1 + 2 * spec.n_stabs
    if record:
        assert [t.shape for t in out[1:]] == [(5, 3, 2), (5, 3, 3)]
