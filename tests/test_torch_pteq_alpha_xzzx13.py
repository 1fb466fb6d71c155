"""The benchmark's biased-noise deployment on the CPU (config
``port_bench/configs/pteq_alpha_xzzx13.json``: ``PTEQ_alpha`` on XZZX d=13
at eta=10, Nc=13, iters=10, B=512): its plain reference (the XZZX code of
``port_bench/reference/xzzx.py`` and the window of
``reference/mixed_window.py``) against the port, the benchmark's checks on a
decode, the reference's own biased noise and alpha ladder
(``reference/alpha_noise.py``) against the port's and the check that holds
the program's ladder to it, the forms and lanes K2's launches take as
compaction shrinks the batch, and the counters those launches record."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mcmc_qec_tpu_torch.mcmc.ladder import (  # noqa: E402
    beta_ladder_alpha,
    beta_ladder_biased,
    init_ladder,
)
from mcmc_qec_tpu_torch.models import get_spec  # noqa: E402
from mcmc_qec_tpu_torch.models.base import np_eq_class  # noqa: E402
from mcmc_qec_tpu_torch.models.noise import (  # noqa: E402
    biased_alpha_equivalent,
    xyz_probs_from_biased,
)
from mcmc_qec_tpu_torch.ops import kernel_tables as kt  # noqa: E402
from mcmc_qec_tpu_torch.ops import ladder_window as lw  # noqa: E402
from mcmc_qec_tpu_torch.utils import profiling  # noqa: E402
from port_bench import harness, inputs_biased  # noqa: E402
from port_bench.drivers import Context  # noqa: E402
from port_bench.reference import (  # noqa: E402
    alpha_noise,
    codes,
    mixed_window,
    xzzx,
)
from port_bench.reference import window as rwin  # noqa: E402

CELL = "pteq_alpha_xzzx13.eta10_p0275_b512"
# the cell's ladder: XZZX d=13, Nc=13, iters=10, per-Pauli betas, on the
# H100's 132 SMs
D, N_SM, P, ETA = 13, 132, 0.275, 10.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [3, 5, 13])
def test_reference_code_matches_the_port(d):
    """Supports, Paulis, colour order, logical draws and class-change
    masks as the port's spec has them, and the class the reference reads
    (the upstream's numbering folded into the class rows) equal to the
    port's ``np_eq_class`` on 10,000 random states."""
    code, spec = xzzx.xzzx(d), get_spec("xzzx", d)
    assert (code.nq, code.n_classes, code.n_stabs) == (
        spec.nq, spec.n_classes, spec.n_stabs)
    assert np.array_equal(code.stab_ops, spec.stab_ops)
    acts = code.stab_ops != 0
    assert np.array_equal(np.where(acts, code.stab_qubits, 0),
                          spec.stab_qubits)
    assert np.array_equal(code.stab_masks, spec.stab_masks)
    colors = [c[c < spec.n_stabs] for c in spec.color_stabs]
    assert [list(c) for c in code.colors] == [list(c) for c in colors]
    (draw,), (want,) = code.draws, spec.logical_draws
    for a, b in zip(draw, (want.x_masks, want.z_masks, want.op_lut)):
        assert np.array_equal(a, b)
    for bits in range(4):
        assert np.array_equal(code.delta_masks[spec.bits_to_eq[bits]],
                              spec.class_delta_masks[bits])
    states = np.random.default_rng(d).integers(0, 4, (10_000, code.nq),
                                               dtype=np.uint8)
    got = rwin.class_of(code, torch.as_tensor(states, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np_eq_class(spec, states))
    np.testing.assert_array_equal(
        codes.class_bits_np(code.class_a, code.class_b, states),
        np_eq_class(spec, states))


@pytest.mark.parametrize("ladder", ["alpha", "biased"])
def test_mixed_window_equals_the_ports_plain_window(ladder):
    """Every output of the reference window on sampled rows equals the
    port's plain window at XZZX d=5, Nc=5, iters=10, general betas: the
    cell's alpha ladder (a free top rung, weights (alpha, alpha, 1)) and a
    biased one whose top rung takes the Metropolis mix."""
    from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_reference

    code, spec = xzzx.xzzx(5), get_spec("xzzx", 5)
    n, Nc = 10, 5
    _, start = inputs_biased.draw_pool(code, xyz_probs_from_biased(P, ETA),
                                       1, n, 7, "cpu")
    ls = init_ladder(spec, start[0], Nc)
    pz_tilde, alpha = biased_alpha_equivalent(P, ETA)
    if ladder == "alpha":
        bl, w = beta_ladder_alpha(pz_tilde, alpha, Nc), [alpha, alpha, 1.0]
    else:
        bl, w = beta_ladder_biased(P, 4.0, Nc), [1.0, 1.0, 1.0]
    betas = torch.as_tensor(bl, dtype=torch.float32)
    w = np.asarray(w, np.float32)
    eq = torch.zeros((n, 4), dtype=torch.int32)
    sb = torch.zeros(n, dtype=torch.int32)
    kw = dict(iters=10, p_logical=0.5, tops_burn=2, energy_chunk=12,
              top_exact=ladder == "alpha", equal_betas=False)
    want = ladder_window_reference(spec, ls.state, ls.flag, ls.tops0, eq, sb,
                                   2468, betas, w, window=36, **kw)
    rows = torch.tensor([1, 4, 9])
    got = mixed_window.window(code, ls.state[rows], ls.flag[rows],
                              ls.tops0[rows], eq[rows], sb[rows],
                              torch.full((3,), 2468), rows, betas, w, W=36,
                              **kw)
    assert (got[8] > 0).any() and (got[8] < 36).any()  # swaps both ways
    for j, (a, b) in enumerate(zip(want, got)):
        a = a[:, rows] if j == 5 else a[rows]
        assert torch.equal(a, b.to(a.dtype)), j


@pytest.mark.parametrize("general", [False, True])
def test_mixed_window_equals_the_toric_window(general):
    """On the toric code, whose checks take one Pauli, the window for
    mixed checks gives ``reference/window.py``'s outputs."""
    code = codes.toric(3)
    spec = get_spec("toric", 3)
    _, start = inputs_biased.draw_pool(code, (0.05, 0.05, 0.05), 1, 6, 3,
                                       "cpu")
    ls = init_ladder(spec, start[0], 3)
    bl = beta_ladder_biased(0.15, 1.0, 3)
    if general:
        bl = bl * np.array([1.0, 1.3, 0.7]) + 0.05
    args = (ls.state, ls.flag, ls.tops0, torch.zeros((6, 16), dtype=torch.int32),
            torch.zeros(6, dtype=torch.int32), torch.full((6,), 77),
            torch.arange(6), torch.as_tensor(bl, dtype=torch.float32),
            np.ones(3, np.float32))
    kw = dict(W=24, iters=2, p_logical=0.5, tops_burn=2, energy_chunk=12,
              top_exact=not general, equal_betas=not general)
    for a, b in zip(rwin.window(code, *args, **kw),
                    mixed_window.window(code, *args, **kw)):
        assert torch.equal(a, b)


def test_biased_pool():
    """The pool's errors follow the threshold order of biased noise, and
    each start is its error times a logical: the same syndrome."""
    code, spec = xzzx.xzzx(5), get_spec("xzzx", 5)
    err, start = inputs_biased.draw_pool(code, xyz_probs_from_biased(P, ETA),
                                         2, 400, 11, "cpu")
    e = err.numpy()
    share = [(e == v).mean() for v in (1, 2, 3)]
    assert share == pytest.approx([0.0125, 0.0125, 0.25], abs=0.005)
    from mcmc_qec_tpu_torch.models.base import np_syndrome

    s = start.numpy()
    np.testing.assert_array_equal(np_syndrome(spec, s), np_syndrome(spec, e))
    assert (np_eq_class(spec, s) != np_eq_class(spec, e)).mean() > 0.5
    again = inputs_biased.draw_pool(code, xyz_probs_from_biased(P, ETA), 2,
                                    400, 11, "cpu")
    assert torch.equal(again[1], start)


def _small_driver(d, batch, max_steps):
    """The cell's driver at XZZX ``d``, Nc=d, windows of 60 steps, every
    request checked and replayed."""
    from port_bench.drivers.pteq_alpha import Driver

    cell = harness.cell(CELL)
    cfg = copy.deepcopy(cell["config_data"])
    cfg["code"]["size"] = d
    cfg["decoder"].update(Nc=d, max_steps=max_steps, window=60,
                          energy_chunk=12, eps=0.1)
    cfg["check"].update(every=1, replay_every=1, replay_rows=4)
    cell["config_data"] = cfg
    cell["traffic_data"] = dict(p=P, eta=ETA, batch=batch, pool_batches=2)
    return Driver(Context(cell, 2**31 + 5, "cpu"))


def test_driver_host_replay_equals_a_decode():
    """The driver decodes through ``PTEQ_alpha`` on the CPU; its host
    replay of the windows' summaries gives the decode's percentages,
    convergence, steps and tops0, and its three checks read 0."""
    drv = _small_driver(3, 8, 1200)
    assert not drv.equal_betas and drv.top_exact
    np.testing.assert_allclose(drv.weights, [drv.alpha, drv.alpha, 1.0])
    drv.decode(0)
    dist, conv, steps, tops, _ = drv.results[0]
    assert 0 < conv.sum() < 8  # rows converge and rows run to the cap
    d, cv, st, tp = drv._replay_host(0)[:4]
    np.testing.assert_array_equal(d, dist)
    np.testing.assert_array_equal(cv, conv)
    np.testing.assert_array_equal(st, steps)
    np.testing.assert_array_equal(tp, tops)
    checks = drv.check()
    assert {k: v[0] for k, v in checks.items()} == {
        "window_rows_differing": 0, "chain_breaks": 0,
        "readout_syndromes_differing": 0, "ladder_entries_differing": 0}
    assert drv.rows_replayed == 4 * len(drv.windows[0])
    assert len(drv.handed) == len(drv.windows[0])


@pytest.mark.parametrize("p, eta, Nc", [
    (P, ETA, D), (P, ETA, 3), (0.1, 3.0, 9), (0.3, 100.0, 17),
    (0.05, 0.5, 7)])
def test_reference_alpha_noise_matches_the_port(p, eta, Nc):
    """The reference's biased probabilities, alpha equivalent, ladder and
    weights, worked out on their own, equal the port's: the ladder and the
    weights in float32 bit for bit, as K2 takes them."""
    np.testing.assert_allclose(alpha_noise.xyz_probs(p, eta),
                               xyz_probs_from_biased(p, eta), rtol=1e-15)
    pzt, alpha = alpha_noise.alpha_equivalent(p, eta)
    np.testing.assert_allclose((pzt, alpha), biased_alpha_equivalent(p, eta),
                               rtol=1e-12)
    ladder = alpha_noise.ladder(pzt, alpha, Nc)
    assert ladder.dtype == np.float32 and ladder.shape == (Nc, 3)
    np.testing.assert_array_equal(
        ladder, np.asarray(beta_ladder_alpha(*biased_alpha_equivalent(
            p, eta), Nc), np.float32))
    np.testing.assert_array_equal(alpha_noise.weights(alpha),
                                  np.float32([alpha, alpha, 1.0]))
    assert ladder[-1].tolist() == [0.0, 0.0, 0.0]
    assert (np.diff(ladder[:, 2]) < 0).all()


def test_reference_alpha_equivalent_at_the_cell():
    """(pz~, alpha) = (0.344828, 3.813658) and (px, py, pz) = (0.0125,
    0.0125, 0.25) at p=0.275, eta=10."""
    np.testing.assert_allclose(alpha_noise.alpha_equivalent(P, ETA),
                               (0.344828, 3.813658), atol=1e-6)
    np.testing.assert_allclose(alpha_noise.xyz_probs(P, ETA),
                               (0.0125, 0.0125, 0.25), rtol=1e-12)


def _wrong_ladder(pz_tilde, alpha, Nc):
    """The alpha ladder evenly spaced in beta and not in pz~."""
    bz = np.linspace(-np.log(pz_tilde), 0.0, Nc)
    return np.stack([alpha * bz, alpha * bz, bz], -1)


@pytest.mark.parametrize("fault", ["ladder", "alpha"])
def test_driver_counts_a_wrong_ladder(monkeypatch, fault):
    """A program whose ladder or alpha equivalent is wrong decodes another
    problem, which the window replay on the reference's ladder would not
    see alone: ``ladder_entries_differing`` counts the entries of the betas
    and weights the windows were handed that are not the reference's."""
    from mcmc_qec_tpu_torch.decoders import pteq as pm
    from mcmc_qec_tpu_torch.models import noise

    if fault == "ladder":
        monkeypatch.setattr(pm, "beta_ladder_alpha", _wrong_ladder)
    else:
        monkeypatch.setattr(noise, "biased_alpha_equivalent",
                            lambda p, eta: (0.3448275862068966, 3.5))
    drv = _small_driver(3, 8, 120)
    drv.decode(0)
    bad = drv.check()["ladder_entries_differing"]
    # a window: the middle rung's three betas; the X and Y betas of the two
    # rungs below the free top and the weights' X and Y entries
    assert len(drv.handed) == 2
    assert bad == ((3 if fault == "ladder" else 2 * 2 + 2) * 2, 0)


def test_driver_refuses_another_family():
    from port_bench.drivers.pteq_alpha import Driver

    cell = harness.cell(CELL)
    cell["config_data"] = copy.deepcopy(cell["config_data"])
    cell["config_data"]["code"]["family"] = "toric"
    with pytest.raises(ValueError, match="XZZX"):
        Driver(Context(cell, 1, "cpu"))


def test_cell_config_matches_the_code():
    """The configuration's statement of the code: 169 qubits, 3 words a
    plane spanning 2, 4 classes, 1 logical draw."""
    c = harness.cell(CELL)["config_data"]["code"]
    spec = get_spec(c["family"], c["size"])
    offs = kt.kernel_tables(spec)[2]
    assert (spec.nq, offs["nw"], offs["span"], spec.n_classes,
            len(spec.logical_draws)) == (c["nq"], c["plane_words"], c["span"],
                                         c["classes"], c["logical_draws"])


@pytest.mark.parametrize("B, form, lanes", [
    (512, "large", None), (256, "registers", 8), (132, "registers", 16),
    (128, "registers", 16)])
def test_forms_as_compaction_shrinks_the_batch(B, form, lanes):
    """At the cell's ladder the batch of 512 runs the large variant, and
    the buckets compaction leaves (256, then 128 rows) the register form
    ``<3, 2, false>``, at its default 8 lanes a rung and then at 16, where
    a launch puts at most one row on each SM (``WIDER_LANES``)."""
    spec = get_spec("xzzx", D)
    offs = kt.kernel_tables(spec)[2]
    assert (offs["nw"], offs["span"]) == (3, 2) and lw.has_window_shape(spec)
    assert lw.window_forms(spec, D, False, 10) == ("registers", "large")
    assert lw.window_form(spec, D, False, 10, B, N_SM) == form
    if lanes is not None:
        assert lw.lanes_per_rung(offs, D) == 8
        assert lw.window_lanes(spec, D, False, 10, B, N_SM) == lanes


def _launches(monkeypatch, launches):
    """``_record_launch`` for (rows, wide, equal betas) launches, the
    occupancy calculator and the card stood in for."""
    monkeypatch.setattr(lw, "_resident_blocks", lambda key, device: 1)
    monkeypatch.setattr(lw, "_sm_count", lambda device: N_SM)
    cpu = torch.device("cpu")
    for rows, wide, equal in launches:
        shape = lw.BlockShape(8 if wide else 16, 4, 1, 256, True, 1000)
        lw._record_launch(shape, dict(B=rows, wide=int(wide)), cpu, rows,
                          equal)


LAUNCHES = [(512, True, False), (512, True, False), (256, False, False),
            (128, False, False), (2603, False, True)]


def test_betas_and_rows_counters_under_the_profiler(monkeypatch):
    """``k2.betas.general``, one a launch with per-Pauli betas, and
    ``k2.rows.large`` / ``k2.rows.registers``, the rows of each form's
    launches summed."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _launches(monkeypatch, LAUNCHES)
    c = profiling.snapshot()["counters"]
    profiling.reset()
    assert c["k2.betas.general"] == 4
    assert c["k2.rows.large"] == 1024
    assert c["k2.rows.registers"] == 256 + 128 + 2603
    assert (c["k2.form.large"], c["k2.form.registers"]) == (2, 3)


def test_betas_and_rows_counters_off_without_a_profiler(monkeypatch):
    profiling.reset()
    assert not profiling.recording()
    _launches(monkeypatch, LAUNCHES)
    assert profiling.snapshot()["counters"] == {}
