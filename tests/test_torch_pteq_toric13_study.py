"""The benchmark's PTEQ threshold-study deployment on the CPU (config
``port_bench/configs/pteq_toric13_study.json``: toric d=13, Nc=13, iters=10,
B=512): its plain reference (``port_bench/reference/``) against the port on
codes of several words a plane, the K2 launch that shape takes, and the
counters K2's launches record for ``k2.waves_per_launch``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import mcmc_qec_tpu_torch.decoders.pteq as pm  # noqa: E402
from mcmc_qec_tpu_torch.mcmc.ladder import (  # noqa: E402
    beta_ladder_depolarizing,
    init_ladder,
)
from mcmc_qec_tpu_torch.models.toric import toric_spec  # noqa: E402
from mcmc_qec_tpu_torch.ops import ladder_window as lw  # noqa: E402
from mcmc_qec_tpu_torch.utils import profiling  # noqa: E402
from port_bench import inputs  # noqa: E402
from port_bench.reference import codes, pteq_host  # noqa: E402
from port_bench.reference import window as rwin  # noqa: E402

# the cell's shape: toric d=13, Nc=13, a batch of 512 on the H100's 132 SMs
D, B, N_SM = 13, 512, 132


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [7, 13])
def test_reference_code_tables_match_the_port(d):
    code, spec = codes.toric(d), toric_spec(d)
    assert np.array_equal(code.stab_masks, spec.stab_masks)
    colors = [c[c < spec.n_stabs] for c in spec.color_stabs]
    assert [list(c) for c in code.colors] == [list(c) for c in colors]
    assert np.array_equal(code.delta_masks, spec.class_delta_masks)


@pytest.mark.parametrize("general", [False, True])
def test_reference_window_equals_the_ports_at_toric_7(general):
    """Every output of the reference window on sampled rows equals the
    port's plain window at toric d=7 (two words a plane), Nc=7, iters=10."""
    from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_reference

    code, spec = codes.toric(7), toric_spec(7)
    assert lw.kernel_words(spec.nq) == 2
    n, Nc = 8, 7
    _, start = inputs.draw_pool(code, 0.19, 1, n, 7, "cpu")
    ls = init_ladder(spec, start[0], Nc)
    bl = beta_ladder_depolarizing(0.19, Nc)
    if general:  # per-Pauli betas and a top rung that is not free
        bl = bl * np.array([1.0, 1.3, 0.7]) + 0.05
    betas = torch.as_tensor(bl, dtype=torch.float32)
    eq = torch.zeros((n, spec.n_classes), dtype=torch.int32)
    sb = torch.zeros(n, dtype=torch.int32)
    w = np.ones(3, np.float32)
    kw = dict(iters=10, p_logical=0.5, tops_burn=2, energy_chunk=12,
              top_exact=not general, equal_betas=not general)
    want = ladder_window_reference(spec, ls.state, ls.flag, ls.tops0, eq, sb,
                                   4321, betas, w, window=24, **kw)
    rows = torch.tensor([0, 3, 6])
    got = rwin.window(code, ls.state[rows], ls.flag[rows], ls.tops0[rows],
                      eq[rows], sb[rows], torch.full((3,), 4321), rows, betas,
                      w, W=24, **kw)
    for j, (a, b) in enumerate(zip(want, got)):
        a = a[:, rows] if j == 5 else a[rows]
        assert torch.equal(a, b.to(a.dtype)), j


def test_host_replay_equals_the_ports_host_loop_at_toric_7():
    """The reference's host replay, from the windows' summaries, gives what
    the port's PTEQ host loop gives at toric d=7, Nc=7, iters=10, with
    compaction twice (16 -> 8 -> 4 rows) and rows that run to the cap."""
    code, spec = codes.toric(7), toric_spec(7)
    _, start = inputs.draw_pool(code, 0.2, 1, 16, 3, "cpu")
    fetched = []
    orig = pm._fetch

    def fetch(out):
        f = orig(out)
        fetched.append(f)
        return f

    cfg = pm.PTEQConfig(Nc=7, SEQ=1, TOPS=1, tops_burn=1, eps=1.0,
                        max_steps=300, iters=10, window=20, energy_chunk=4,
                        min_compact=4)
    pm._fetch = fetch
    try:
        res = pm.PTEQ(spec, start[0], 0.2, cfg, seed=5, device="cpu")
    finally:
        pm._fetch = orig
    d, conv, steps, tops, _, buckets = pteq_host.replay(
        fetched, 16, spec.n_classes, n_windows=300 // 20, energy_chunk=4,
        TOPS=1, SEQ=1, eps=1.0, min_compact=4)
    assert res.buckets == (8, 4) and tuple(buckets) == res.buckets
    assert 0 < res.converged.sum() < 16
    np.testing.assert_array_equal(d, res.distribution)
    np.testing.assert_array_equal(conv, res.converged)
    np.testing.assert_array_equal(steps, res.steps)
    np.testing.assert_array_equal(tops, res.tops0)


def _study_shape(iters):
    spec = toric_spec(D)
    offs = lw.kernel_tables(spec)[2]
    return spec, offs, lw.block_shape(offs, D, spec.n_classes, B, N_SM, True,
                                      iters, len(spec.logical_draws))


@pytest.mark.parametrize("iters, groups", [(10, 1), (2, 4)])
def test_study_window_is_the_register_form(iters, groups):
    """Toric d=13 at Nc=13: the register form <6, 4, true>, 8 lanes a rung
    and four warps a group; the sweep draws a group stages grow with iters,
    so that at iters=10 one group fills a block's shared memory."""
    spec, offs, shape = _study_shape(iters)
    assert lw.window_form(spec, D, True, iters) == "registers"
    assert lw.kernel_shape(spec) == (6, 4)
    assert (shape.lanes, shape.warps_per_group) == (8, 4)
    assert shape.groups_per_block == groups
    assert shape.threads == 128 * groups
    assert shape.smem <= lw.SMEM_LIMIT < shape.smem + lw.group_bytes(
        offs, D, spec.n_classes, True, iters, len(spec.logical_draws))


def test_resident_rows_of_the_study_window():
    _, _, shape = _study_shape(10)
    assert shape.smem == 227_216
    # one block of 227,216 B an SM: 132 rows at once, 512 in 3.88 waves
    assert lw.resident_rows(shape, 1, N_SM) == 132
    assert lw.resident_rows(shape._replace(groups_per_block=4), 2, N_SM) == 1056


def _record(monkeypatch, wide, rows):
    """``_record_launch`` for launches of ``rows`` rows each, the
    occupancy calculator and the card stood in for: 2 blocks an SM of 3
    groups, 10 SMs (60 rows at once)."""
    asked = []

    def blocks(key, device):
        asked.append(key)
        return 2

    monkeypatch.setattr(lw, "_resident_blocks", blocks)
    monkeypatch.setattr(lw, "_sm_count", lambda device: 10)
    shape = lw.BlockShape(8, 4, 3, 384, True, 1000)
    for b in rows:
        lw._record_launch(shape, dict(B=b, wide=int(wide), nw=6),
                          torch.device("cpu"), b)
    return asked


@pytest.mark.parametrize("wide", [False, True])
def test_launch_counters_under_the_profiler(monkeypatch, wide):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        asked = _record(monkeypatch, wide, [60, 30, 90])
    c = profiling.snapshot()["counters"]
    # the occupancy query's key leaves out the batch: one shape, one query
    # (``_resident_blocks`` is cached on it)
    assert len(asked) == 3 and len(set(asked)) == 1
    profiling.reset()
    form = "large" if wide else "registers"
    assert c[f"k2.form.{form}"] == 3
    assert f"k2.form.{'registers' if wide else 'large'}" not in c
    assert c["k2.resident_rows"] == 180
    assert c["k2.waves_micro"] == 3_000_000  # 1 + 0.5 + 1.5 waves


def test_launch_counters_off_without_a_profiler(monkeypatch):
    """Off, a launch reads the recorder's flag and records nothing: no
    occupancy query, no counter."""
    profiling.reset()
    assert not profiling.recording()
    assert _record(monkeypatch, False, [60, 30]) == []
    assert profiling.snapshot()["counters"] == {}
