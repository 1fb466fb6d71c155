"""The plain reference against the port's CPU path at toric d=3: the test
may import the port; the reference does not."""

import numpy as np
import pytest
import torch

from port_bench import inputs
from port_bench.reference import codes, pteq_host
from port_bench.reference import stdc as rstdc
from port_bench.reference import window as rwin


def test_code_tables_match_the_port():
    from mcmc_qec_tpu_torch.models.toric import toric_spec

    for d in (3, 5):
        code, spec = codes.toric(d), toric_spec(d)
        assert np.array_equal(code.stab_masks, spec.stab_masks)
        colors = [c[c < spec.n_stabs] for c in spec.color_stabs]
        assert [list(c) for c in code.colors] == [list(c) for c in colors]
        assert np.array_equal(code.delta_masks, spec.class_delta_masks)


@pytest.mark.parametrize("general", [False, True])
def test_window_equals_the_ports_plain_window(general):
    from mcmc_qec_tpu_torch.mcmc.ladder import (beta_ladder_depolarizing,
                                                 init_ladder)
    from mcmc_qec_tpu_torch.models.toric import toric_spec
    from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_reference

    code, spec = codes.toric(3), toric_spec(3)
    B, Nc = 12, 3
    _, start = inputs.draw_pool(code, 0.15, 1, B, 5, "cpu")
    ls = init_ladder(spec, start[0], Nc)
    bl = beta_ladder_depolarizing(0.15, Nc)
    if general:  # per-Pauli betas and a top rung that is not free
        bl = bl * np.array([1.0, 1.3, 0.7]) + 0.05
    betas = torch.as_tensor(bl, dtype=torch.float32)
    eq = torch.zeros((B, 16), dtype=torch.int32)
    sb = torch.zeros(B, dtype=torch.int32)
    w = np.ones(3, np.float32)
    kw = dict(iters=2, p_logical=0.5, tops_burn=2, energy_chunk=12,
              top_exact=not general, equal_betas=not general)
    want = ladder_window_reference(spec, ls.state, ls.flag, ls.tops0, eq, sb,
                                   9876, betas, w, window=48, **kw)
    rows = torch.tensor([2, 5, 11])
    got = rwin.window(code, ls.state[rows], ls.flag[rows], ls.tops0[rows],
                      eq[rows], sb[rows], torch.full((3,), 9876), rows, betas,
                      w, W=48, **kw)
    for j, (a, b) in enumerate(zip(want, got)):
        a = a[:, rows] if j == 5 else a[rows]
        assert torch.equal(a, b.to(a.dtype)), j


def test_stdc_equals_the_ports_cpu_decode():
    import warnings

    from mcmc_qec_tpu_torch.decoders.stdc import STDC
    from mcmc_qec_tpu_torch.models.toric import toric_spec

    code, spec = codes.toric(3), toric_spec(3)
    _, start = inputs.draw_pool(code, 0.1, 2, 6, 11, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = [STDC(spec, start[i], 0.1, 0.25, droplets=2, steps=200,
                    seed=40 + i, stream=True, stream_window=64,
                    stream_capacity=32, device="cpu") for i in range(2)]
    picks = [torch.tensor([0, 4]), torch.tensor([1, 2, 5])]
    ref = rstdc.decode(code, [(start[i], picks[i], 40 + i) for i in range(2)],
                       0.1, 0.25, 2, 200, 32)
    for i in range(2):
        np.testing.assert_array_equal(got[i][picks[i].numpy()],
                                      ref[i][0].numpy())


def test_host_replay_equals_the_ports_host_loop():
    """The port's PTEQ host loop, from the windows' summaries it fetched,
    gives what the reference's host replay gives, compaction included."""
    import mcmc_qec_tpu_torch.decoders.pteq as pm
    from mcmc_qec_tpu_torch.models.toric import toric_spec

    code, spec = codes.toric(3), toric_spec(3)
    _, start = inputs.draw_pool(code, 0.15, 1, 200, 3, "cpu")
    fetched = []
    orig = pm._fetch

    def fetch(out):
        f = orig(out)
        fetched.append(f)
        return f

    cfg = pm.PTEQConfig(Nc=3, SEQ=2, TOPS=10, tops_burn=2, eps=0.1,
                        max_steps=3000, iters=1, window=40, energy_chunk=8,
                        min_compact=16)
    pm._fetch = fetch
    try:
        res = pm.PTEQ(spec, start[0], 0.15, cfg, seed=5, device="cpu")
    finally:
        pm._fetch = orig
    d, conv, steps, tops, _, buckets = pteq_host.replay(
        fetched, 200, 16, n_windows=3000 // 40, energy_chunk=8, TOPS=10,
        SEQ=2, eps=0.1, min_compact=16)
    assert res.buckets and tuple(buckets) == res.buckets
    np.testing.assert_array_equal(d, res.distribution)
    np.testing.assert_array_equal(conv, res.converged)
    np.testing.assert_array_equal(steps, res.steps)
    np.testing.assert_array_equal(tops, res.tops0)
