"""Which form of the PT window kernel (K2) runs a launch:
``ops/ladder_window.py::window_form`` from the launch's shape.

(a) On the CPU, the rule at shapes chip_window_probe.py --grid fit and
    check measured (NVIDIA H100 80GB HBM3, 132 SMs; the times in
    ``window_form``'s docstring): the form it picks is the faster one, and
    ``window_kernel_fits`` answers as the word-count rule it replaced.  At
    the shapes of 6 words a plane and more, which have no register build
    (``WINDOW_SHAPES``), the rule still picks what it picked while the
    register form was built there (``sweep.SWEEP_SHAPES``, the list both
    kernels shared): the large variant, at every ladder and batch tried;
    and every register build is picked somewhere.
(b) On a card, both forms, each forced, on one short toric d=9 window at
    Nc=9 and iters=10 give all nine outputs equal bit for bit, so the
    choice moves only time.  Skipped without a card; on a host with one:
    ``python -m pytest --noconftest -m chip tests/test_torch_window_forms.py``
    (this file imports no jax).
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mcmc_qec_tpu_torch.models import get_spec  # noqa: E402
from mcmc_qec_tpu_torch.ops import kernel_tables as kt  # noqa: E402
from mcmc_qec_tpu_torch.ops import ladder_window as lw  # noqa: E402
from mcmc_qec_tpu_torch.ops import sweep as sw  # noqa: E402

N_SM = 132  # the H100's SMs

# (family, d, B, iters, equal betas, the faster form measured, its ms, the
# other's ms); Nc = d
MEASURED = [
    ("toric", 13, 512, 10, True, "large", 209.15, 711.94),  # the study cell
    ("toric", 13, 512, 2, True, "large", 42.80, 91.53),
    ("toric", 13, 64, 10, True, "large", 95.37, 178.21),
    ("toric", 13, 2048, 10, True, "large", 650.65, 2844.52),
    ("toric", 5, 2603, 10, True, "registers", 62.78, 117.85),  # the d=5 cells
    ("toric", 5, 2603, 2, True, "registers", 15.22, 25.38),
    ("toric", 5, 300, 10, True, "registers", 22.24, 65.28),  # compacted tails
    ("toric", 5, 16, 10, True, "registers", 22.18, 64.84),
    ("toric", 7, 2048, 10, True, "registers", 175.96, 352.39),
    ("xzzx", 13, 512, 2, False, "registers", 20.93, 24.92),
    ("xzzx", 13, 512, 10, False, "large", 117.54, 129.91),
    ("rotated", 13, 512, 10, True, "large", 105.92, 121.07),
    ("xzzx", 9, 512, 10, False, "registers", 39.76, 67.44),
    ("toric", 9, 64, 2, True, "large", 14.72, 15.99),
    ("toric", 9, 2048, 10, True, "large", 412.72, 659.23),
    ("toric", 11, 512, 10, True, "large", 129.92, 465.81),
    ("xzzx", 17, 512, 2, False, "large", 38.91, 89.64),
    ("rotated", 17, 512, 10, True, "large", 166.35, 486.91),
    ("toric", 15, 2048, 2, True, "large", 160.31, 714.01),
    # --grid check: shapes the fit did not see first
    ("toric", 7, 4096, 10, True, "registers", 295.95, 532.82),
    ("toric", 7, 1024, 10, True, "large", 102.52, 118.26),
    ("xzzx", 13, 132, 10, False, "registers", 55.11, 59.74),
    ("rotated", 11, 512, 10, True, "large", 92.62, 96.98),
    ("xzzx", 15, 512, 10, False, "large", 134.57, 314.09),
    ("planar", 13, 512, 10, True, "large", 153.79, 606.55),
    ("xzzx", 21, 512, 2, False, "large", 62.20, 130.01),
]


def _word_count_fits(spec, Nc, eq, iters):
    """The predicate the word-count rule gave: the register form below 12
    words a plane where it holds the ladder, else the large variant where
    it holds it."""
    K, nd = spec.n_classes, len(spec.logical_draws)
    if lw.has_window_shape(spec) and kt.kernel_tables(spec)[2]["nw"] < 12:
        offs = kt.kernel_tables(spec)[2]
        threads = 32 * -(-Nc * kt.lanes_per_rung(offs, Nc) // 32)
        if threads <= lw.MAX_THREADS and lw.smem_bytes(
                offs, Nc, K, 1, eq, iters, nd, False) <= kt.SMEM_LIMIT:
            return True
    return (-(-spec.nq // 64) <= kt.WIDE_WORDS and 1 <= Nc <= kt.WIDE_MAX_THREADS
            and lw.wide_smem_bytes(kt.kernel_tables(spec)[2], Nc, K, 1, eq,
                                   iters, nd, False) <= kt.SMEM_LIMIT)


@contextlib.contextmanager
def _registers_at_every_shape():
    """The rule as it decided while the register form was built at every
    shape up to 16 words a plane (``sweep.SWEEP_SHAPES``): its predicate
    widened to that list, and its caches emptied around the block."""
    built = lw.has_window_shape
    lw.has_window_shape = sw.has_sweep_shape
    lw.window_forms.cache_clear()
    lw.window_form.cache_clear()
    try:
        yield
    finally:
        lw.has_window_shape = built
        lw.window_forms.cache_clear()
        lw.window_form.cache_clear()


@pytest.mark.parametrize(
    "family,d,B,iters,eq,want,faster_ms,other_ms", MEASURED,
    ids=[f"{f}{d}-B{b}-it{i}-{'eq' if e else 'gen'}"
         for f, d, b, i, e, *_ in MEASURED])
def test_window_form_picks_the_measured_faster_form(family, d, B, iters, eq,
                                                     want, faster_ms, other_ms):
    assert faster_ms < other_ms
    spec = get_spec(family, d)
    built = lw.has_window_shape(spec)
    assert lw.window_forms(spec, d, eq, iters) == ("registers",) * built + (
        "large",)
    assert lw.window_form(spec, d, eq, iters, B, N_SM) == want
    assert lw.window_kernel_fits(spec, d, eq, iters) == _word_count_fits(
        spec, d, eq, iters) is True
    if not built:
        with _registers_at_every_shape():
            assert lw.window_forms(spec, d, eq, iters) == ("registers", "large")
            assert lw.window_form(spec, d, eq, iters, B, N_SM) == want


def test_rows_held_at_once_of_the_study_window():
    """Toric d=13, Nc=13, iters=10, B=512: the register form holds 132 rows
    at once (one 4-warp group of 227,216 B an SM), 3.88 waves; the large
    variant 528 (four 7-warp groups of 896 threads, one block an SM by its
    64 registers a thread), one wave; as the occupancy calculator said."""
    spec = get_spec("toric", 13)
    offs = kt.kernel_tables(spec)[2]
    args = (offs, 13, spec.n_classes, 512, N_SM, True, 10,
            len(spec.logical_draws))
    reg, big = lw.block_shape(*args), lw.wide_block_shape(*args)
    assert lw.blocks_per_sm(reg, lw.MAX_THREADS) == 1
    assert lw.resident_rows(reg, 1, N_SM) == 132
    assert (big.threads, big.groups_per_block) == (896, 4)
    assert lw.blocks_per_sm(big, kt.WIDE_MAX_THREADS) == 1
    assert lw.resident_rows(big, 1, N_SM) == 528


def test_the_form_follows_the_batch():
    """One code, two batches, two forms: xzzx d=13 at iters=10 runs the
    register form while its rows fit one wave of it (B=132) and the large
    variant where the register form needs two waves to its one (B=512); a
    batch of none decides as a batch of one."""
    spec = get_spec("xzzx", 13)
    assert lw.window_form(spec, 13, False, 10, 132, N_SM) == "registers"
    assert lw.window_form(spec, 13, False, 10, 512, N_SM) == "large"
    assert (lw.window_form(spec, 13, False, 10, 0, N_SM)
            == lw.window_form(spec, 13, False, 10, 1, N_SM))


@pytest.mark.parametrize("family,d", [("toric", 17), ("toric", 19),
                                      ("rotated", 27), ("xzzx", 29)])
def test_codes_of_12_and_16_words_keep_the_large_variant(family, d):
    spec = get_spec(family, d)
    assert kt.kernel_words(spec.nq) in (12, 16)
    for B in (1, 64, 132, 512, 2048, 8192):
        for eq in (True, False):
            assert lw.window_form(spec, d, eq, 2, B, N_SM) == "large"
            with _registers_at_every_shape():
                assert lw.window_form(spec, d, eq, 2, B, N_SM) == "large"


# one code of each (words, span) that lost its register build
REMOVED = [("toric", 13), ("toric", 15), ("toric", 19), ("toric", 21),
           ("xzzx", 17), ("xzzx", 21), ("rotated", 27), ("rotated", 29)]
# batches of one wave and several, and the one-against-two-waves edge where
# the rule picks the register form at 3 and 4 words a plane
BATCHES = (1, 132, 512, *range(1986, 2108, 11), 4096, 8192)


@pytest.mark.parametrize("family,d", REMOVED,
                         ids=[f"{f}{d}" for f, d in REMOVED])
def test_removed_register_shapes_keep_the_fused_window(family, d):
    """No ladder was the register form's alone at these shapes: wherever
    ``block_shape`` finds it a launch, the large variant holds the ladder
    too, so PTEQ keeps the fused window; and the rule picks the large
    variant at every batch, as it did while the register form was built
    here."""
    spec = get_spec(family, d)
    assert sw.has_sweep_shape(spec) and not lw.has_window_shape(spec)
    offs = kt.kernel_tables(spec)[2]
    K, nd = spec.n_classes, len(spec.logical_draws)
    for Nc in (5, 8, d, 2 * d):
        for eq in (True, False):
            for iters in (1, 2, 10):
                try:
                    lw.block_shape(offs, Nc, K, 512, N_SM, eq, iters, nd)
                except ValueError:  # the register form never held it
                    pass
                else:
                    assert lw.window_kernel_fits(spec, Nc, eq, iters), (
                        Nc, eq, iters)
                picks = [lw.window_form(spec, Nc, eq, iters, B, N_SM)
                         for B in BATCHES]
                with _registers_at_every_shape():
                    before = [lw.window_form(spec, Nc, eq, iters, B, N_SM)
                              for B in BATCHES]
                assert picks == before == ["large"] * len(BATCHES), (
                    Nc, eq, iters)


# (family, d, Nc, iters, B, its (words, span)): a launch of each register
# build that the rule gives the register form, in both betas forms
PICKED = [("toric", 5, 5, 10, 2603, (1, 1)), ("toric", 7, 7, 10, 2048, (2, 2)),
          ("xzzx", 13, 13, 2, 512, (3, 2)), ("toric", 9, 8, 2, 2048, (3, 4)),
          ("xzzx", 15, 8, 2, 2048, (4, 2)), ("toric", 11, 8, 2, 2048, (4, 4))]


@pytest.mark.parametrize("family,d,Nc,iters,B,shape", PICKED,
                         ids=[f"{f}{d}-Nc{n}-it{i}-B{b}"
                              for f, d, n, i, b, _ in PICKED])
def test_every_register_shape_is_picked_somewhere(family, d, Nc, iters, B,
                                                  shape):
    assert sorted(s for *_, s in PICKED) == sorted(lw.WINDOW_SHAPES)
    spec = get_spec(family, d)
    assert (kt.kernel_words(spec.nq), kt.spanned_words(spec)) == shape
    assert lw.has_window_shape(spec)
    for eq in (True, False):
        assert lw.window_form(spec, Nc, eq, iters, B, N_SM) == "registers"


@pytest.mark.parametrize("family,d,Nc", [("toric", 15, 15), ("toric", 5, 129),
                                         ("toric", 5, 1025), ("planar", 91, 3)])
def test_one_form_or_none_needs_no_model(family, d, Nc):
    """Where one form or none holds the ladder, ``window_form`` names it
    at every batch, and ``window_kernel_fits`` agrees with the word-count
    rule."""
    spec = get_spec(family, d)
    forms = lw.window_forms(spec, Nc, True, 10)
    assert len(forms) < 2
    for B in (1, 512, 4096):
        assert lw.window_form(spec, Nc, True, 10, B, N_SM) == (
            forms[0] if forms else None)
    assert lw.window_kernel_fits(spec, Nc, True, 10) == _word_count_fits(
        spec, Nc, True, 10)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: both forms of the window kernel run "
                    "only there")


@pytest.mark.chip
def test_both_forms_give_equal_outputs_on_the_card(card, monkeypatch):
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing

    d, B, p = 9, 256, 0.19
    spec = get_spec("toric", d)
    gen = torch.Generator(device="cuda").manual_seed(2113)
    ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                               device="cuda"), d)
    args = (ls.state, ls.flag, ls.tops0,
            torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda"),
            torch.zeros((B,), dtype=torch.int32, device="cuda"), 77,
            torch.as_tensor(beta_ladder_depolarizing(p, d), dtype=torch.float32,
                            device="cuda"), np.ones(3, np.float32))
    assert lw.window_forms(spec, d, True, 10) == ("registers", "large")
    outs = {}
    for form in ("registers", "large"):
        monkeypatch.setattr(lw, "window_form", lambda *a, form=form: form)
        lw.ladder_window_counts.reset()
        fn = lw.make_ladder_window(spec, d, 48, 10, 0.5, 2, 12, top_exact=True,
                                   equal_betas=True)
        outs[form] = [t.cpu() for t in fn(*args)]
        assert lw.ladder_window_counts.launches == 1
    assert len(outs["large"]) == 9
    for i, (a, b) in enumerate(zip(outs["registers"], outs["large"])):
        assert torch.equal(a, b), i
    assert not torch.equal(outs["large"][0], ls.state.cpu()), "nothing moved"
