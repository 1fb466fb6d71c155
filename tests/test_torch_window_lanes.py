"""Lanes per rung of the PT window kernel's register form (K2):
``ops/ladder_window.py::window_lanes`` from the launch's shape.

(a) On the CPU, the rule's properties over a scan of shapes: a power of
    two within a block's threads, named barriers and shared memory; never
    more waves than ``lanes_per_rung``'s lanes; those lanes at one wave or
    more and at ladders the probe did not measure; ``window_form`` and
    ``lanes_per_rung`` as they were before the rule (SHA-256 digests of the
    scan's answers); the lanes picked at the measured ladders; and the
    launch fields and the counter that follow from them.
(b) On a card, toric d=5 at iters=10 at 4, 8 and 16 lanes a rung gives
    every output equal bit for bit to 4 lanes' and to the plain version.
    Skipped without a card; on a host with one:
    ``python -m pytest --noconftest -m chip tests/test_torch_window_lanes.py``
    (this file imports no jax).
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mcmc_qec_tpu_torch.models import get_spec  # noqa: E402
from mcmc_qec_tpu_torch.ops import kernel_tables as kt  # noqa: E402
from mcmc_qec_tpu_torch.ops import ladder_window as lw  # noqa: E402
from mcmc_qec_tpu_torch.utils import profiling  # noqa: E402

N_SM = 132  # the H100's SMs


# the scan of ``window_form`` and ``lanes_per_rung`` the lanes rule must
# leave as they were: every code of up to 4 words a plane (odd sizes),
# Nc 5/8/13/d/2d, both betas forms, iters 1/2/10 and batches of 1 to 8200
SCAN_CODES = ([("toric", d) for d in range(3, 12, 2)]
              + [("planar", d) for d in range(3, 12, 2)]
              + [(f, d) for f in ("rotated", "xzzx") for d in range(3, 16, 2)])
SCAN_BATCHES = (1, 16, 64, 132, 264, 300, 512, 660, 821, 1024, 1056, 1500,
                1848, 2048, 2112, 2603, 4096, 8200)
# SHA-256 of the scan's picks (12,960, "registers" or "large", joined by
# commas) and of its lanes_per_rung (120) as they were before the lanes
# rule (commit f42f0dc)
FORM_PICKS_SHA = ("5e965aefa2ab4e6d44c8fd6d77b574b943213f2163fe54182bb026ca95"
                  "cb80af")
LANES_PER_RUNG_SHA = ("16e94713046cf2f0d0575d192b4c4d57dc83a697f86c618121a61b"
                      "af5c2d476d")


def _scan():
    """(window_form's picks, lanes_per_rung's lanes, the launches of every
    register-form pick: (spec, Nc, eq, iters, B))."""
    picks, lanes, launches = [], [], []
    for family, d in SCAN_CODES:
        spec = get_spec(family, d)
        assert kt.kernel_words(spec.nq) <= 4
        offs = kt.kernel_tables(spec)[2]
        for Nc in (5, 8, 13, d, 2 * d):
            lanes.append(kt.lanes_per_rung(offs, Nc))
            for eq in (True, False):
                for iters in (1, 2, 10):
                    for B in SCAN_BATCHES:
                        form = lw.window_form(spec, Nc, eq, iters, B, N_SM)
                        picks.append(str(form))
                        if form == "registers":
                            launches.append((spec, Nc, eq, iters, B))
    return picks, lanes, launches


def _sha(items) -> str:
    return hashlib.sha256(",".join(map(str, items)).encode()).hexdigest()


def test_window_form_and_lanes_per_rung_are_unchanged():
    picks, lanes, launches = _scan()
    assert len(picks) == 12_960 and len(lanes) == 120
    assert _sha(picks) == FORM_PICKS_SHA
    assert _sha(lanes) == LANES_PER_RUNG_SHA
    assert len(launches) == picks.count("registers") == 8846


def _shapes(spec, Nc, eq, iters, B):
    """(the default launch, the rule's launch, their rows held at once)."""
    offs = kt.kernel_tables(spec)[2]
    args = (offs, Nc, spec.n_classes, B, N_SM, eq, iters,
            len(spec.logical_draws))
    base = lw.block_shape(*args)
    shape = lw.block_shape(*args, lanes=lw.window_lanes(spec, Nc, eq, iters,
                                                        B, N_SM))

    def held(s):
        return lw.resident_rows(s, lw.blocks_per_sm(s, lw.MAX_THREADS), N_SM)

    return base, shape, held(base), held(shape)


def test_the_rule_keeps_every_launch_within_the_block_and_its_waves():
    """At every register-form launch of the scan: a power of two of lanes,
    at least the default's, within MAX_THREADS threads, 15 multi-warp
    groups and SMEM_LIMIT; no more waves than the default lanes; the
    default lanes at one wave or more and at ladders WIDER_LANES does not
    name."""
    wider = 0
    for spec, Nc, eq, iters, B in _scan()[2]:
        base, shape, held0, held = _shapes(spec, Nc, eq, iters, B)
        L = shape.lanes
        assert L & (L - 1) == 0 and base.lanes <= L <= 32
        assert L in (base.lanes, 2 * base.lanes, 4 * base.lanes)
        assert shape.threads <= lw.MAX_THREADS
        assert shape.warps_per_group == -(-Nc * L // 32)
        if shape.warps_per_group > 1:
            assert shape.groups_per_block <= lw.MAX_NAMED_BARRIERS
        assert shape.smem <= kt.SMEM_LIMIT
        assert -(-B // held) <= -(-B // held0)
        offs = kt.kernel_tables(spec)[2]
        key = (offs["nw"], offs["span"], Nc, eq, iters)
        if B >= held0 or key not in lw.WIDER_LANES:
            assert L == base.lanes, (spec.family, spec.size, Nc, eq, iters, B)
        wider += L > base.lanes
    assert wider > 0


def test_wider_lanes_name_measured_register_ladders():
    """Each entry of WIDER_LANES is a ladder of a register build at a
    lane count above the default, widest first, up to 32."""
    built = {(kt.kernel_words(get_spec(f, d).nq),
              kt.spanned_words(get_spec(f, d))): d for f, d in SCAN_CODES}
    assert lw.WIDER_LANES
    for (nw, span, Nc, eq, iters), entries in lw.WIDER_LANES.items():
        assert (nw, span) in lw.WINDOW_SHAPES and (nw, span) in built
        lanes = [L for L, _ in entries]
        assert lanes == sorted(lanes, reverse=True) and lanes[0] <= 32
        assert all(B >= 1 for _, B in entries)


# (family, d, Nc, equal betas, iters, B, the lanes the rule gives): the
# d=5 cells' compaction buckets (2603 rows, then 2048, 1024, 512, 256 and
# 128), the edges of each entry, and the other measured ladders
PICKS = [
    ("toric", 5, 5, True, 10, 2603, 4), ("toric", 5, 5, True, 10, 2048, 4),
    ("toric", 5, 5, True, 10, 1057, 4), ("toric", 5, 5, True, 10, 1056, 8),
    ("toric", 5, 5, True, 10, 1024, 8), ("toric", 5, 5, True, 10, 529, 8),
    ("toric", 5, 5, True, 10, 528, 16), ("toric", 5, 5, True, 10, 512, 16),
    ("toric", 5, 5, True, 10, 256, 16), ("toric", 5, 5, True, 10, 128, 16),
    ("toric", 5, 5, True, 10, 1, 16), ("toric", 5, 5, True, 2, 512, 16),
    ("toric", 5, 5, True, 2, 1024, 8), ("toric", 5, 5, True, 1, 128, 4),
    ("toric", 5, 5, False, 10, 128, 4), ("toric", 5, 8, True, 10, 128, 4),
    ("toric", 7, 7, True, 10, 132, 32), ("toric", 7, 7, True, 2, 133, 8),
    ("xzzx", 13, 13, False, 10, 132, 16), ("xzzx", 13, 13, False, 2, 133, 8),
    ("xzzx", 13, 13, True, 10, 132, 8), ("rotated", 9, 9, True, 10, 16, 8),
]


@pytest.mark.parametrize("family,d,Nc,eq,iters,B,want", PICKS,
                         ids=[f"{f}{d}-Nc{n}-{'eq' if e else 'gen'}-it{i}-B{b}"
                              for f, d, n, e, i, b, _ in PICKS])
def test_the_rule_picks_the_measured_lanes(family, d, Nc, eq, iters, B, want):
    spec = get_spec(family, d)
    assert lw.window_form(spec, Nc, eq, iters, B, N_SM) == "registers"
    assert lw.window_lanes(spec, Nc, eq, iters, B, N_SM) == want


def test_block_shape_keeps_its_default():
    spec = get_spec("toric", 5)
    offs = kt.kernel_tables(spec)[2]
    args = (offs, 5, spec.n_classes, 512, N_SM, True, 10,
            len(spec.logical_draws))
    assert lw.block_shape(*args) == lw.block_shape(*args, lanes=4)
    assert lw.block_shape(*args).lanes == kt.lanes_per_rung(offs, 5) == 4
    assert lw.block_shape(*args, lanes=16) == lw.BlockShape(
        16, 3, 4, 384, True, lw.smem_bytes(offs, 5, spec.n_classes, 4, True,
                                           10, len(spec.logical_draws), True))


@pytest.mark.parametrize("B,lanes,warps,groups", [
    (128, 16, 3, 1), (512, 16, 3, 4), (1024, 8, 2, 8), (2603, 4, 1, 16)])
def test_launch_fields_follow_the_rule(monkeypatch, B, lanes, warps, groups):
    """The kernel's launch fields at the d=5 cell's buckets: lanes and
    their shift, warps a group, groups a block and the block's shared
    memory, as the kernel's Layout and launch checks read them."""
    monkeypatch.setattr(lw, "_sm_count", lambda device: N_SM)
    spec = get_spec("toric", 5)
    shape, f = lw._layout_fields(spec, B, 5, 10, True, torch.device("cpu"))
    assert (shape.lanes, shape.warps_per_group, shape.groups_per_block) == (
        lanes, warps, groups)
    assert (f["lanes"], f["lane_shift"]) == (lanes, lanes.bit_length() - 1)
    assert (f["warps_per_group"], f["groups_per_block"]) == (warps, groups)
    assert f["wide"] == 0 and f["smem"] == shape.smem
    assert f["smem"] == lw.smem_bytes(kt.kernel_tables(spec)[2], 5,
                                      spec.n_classes, groups, True, 10,
                                      len(spec.logical_draws), True)
    assert 5 * lanes <= 32 * warps and 32 * warps * groups <= lw.MAX_THREADS


def test_lanes_counter_under_the_profiler(monkeypatch):
    """``k2.lanes.<L>``, one a register-form launch at its lanes, beside
    ``k2.form.registers``; none for the large variant."""
    monkeypatch.setattr(lw, "_resident_blocks", lambda key, device: 1)
    monkeypatch.setattr(lw, "_sm_count", lambda device: N_SM)
    profiling.reset()
    cpu = torch.device("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for L in (16, 16, 8, 4):
            shape = lw.BlockShape(L, 1, 1, 32, True, 1000)
            lw._record_launch(shape, dict(B=128, wide=0), cpu, 128, True)
        lw._record_launch(lw.BlockShape(8, 7, 4, 896, True, 1000),
                          dict(B=512, wide=1), cpu, 512, True)
    c = profiling.snapshot()["counters"]
    profiling.reset()
    lanes = {k: v for k, v in c.items() if k.startswith("k2.lanes.")}
    assert lanes == {"k2.lanes.16": 2, "k2.lanes.8": 1, "k2.lanes.4": 1}
    assert c["k2.form.registers"] == 4 and c["k2.form.large"] == 1


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel runs only there")


@pytest.mark.chip
@pytest.mark.parametrize("B", [16, 263, 821])
def test_every_lane_count_gives_equal_outputs_on_the_card(card, monkeypatch,
                                                          B):
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models.noise import sample_depolarizing

    d, p, W, iters = 5, 0.15, 48, 10
    spec = get_spec("toric", d)
    gen = torch.Generator(device="cuda").manual_seed(3001 + B)
    ls = init_ladder(spec, sample_depolarizing(gen, spec, p, (B,),
                                               device="cuda"), d)
    args = (ls.state, ls.flag, ls.tops0,
            torch.zeros((B, spec.n_classes), dtype=torch.int32, device="cuda"),
            torch.zeros((B,), dtype=torch.int32, device="cuda"), 2**40 + 77,
            torch.as_tensor(beta_ladder_depolarizing(p, d), dtype=torch.float32,
                            device="cuda"), np.ones(3, np.float32))
    kw = dict(top_exact=True, equal_betas=True)
    monkeypatch.setattr(lw, "window_form", lambda *a: "registers")
    outs = {}
    for L in (4, 8, 16):
        monkeypatch.setattr(lw, "window_lanes", lambda *a, L=L: L)
        shape, _ = lw.launch_plan(spec, B, d, iters, True)
        assert shape.lanes == L
        fn = lw.make_ladder_window(spec, d, W, iters, 0.5, 2, 12, **kw)
        outs[L] = [t.cpu() for t in fn(*args)]
    plain = lw.ladder_window_reference(
        spec, *args, window=W, iters=iters, p_logical=0.5, tops_burn=2,
        energy_chunk=12, **kw)
    assert len(outs[4]) == len(plain) == 9
    for L in (4, 8, 16):
        for i, (a, b) in enumerate(zip(outs[L], plain)):
            assert torch.equal(a, b.cpu()), (L, i)
    assert not torch.equal(outs[4][0], ls.state.cpu()), "nothing moved"
