"""The frozen work counts against hand counts and against the port's own
``utils/roofline.py`` of today."""

import pytest

from port_bench.reference import codes
from port_bench.roofline import counts, k1, k2, peaks


@pytest.mark.parametrize("d,blocks", [(3, 7), (5, 16)])
def test_hand_counts(d, blocks):
    code = codes.toric(d)
    n = 2 * d * d  # checks, four qubits each: one 32-bit word a support
    assert counts.popc_per_sweep(code, True) == 2 * n
    assert counts.popc_per_sweep(code, False) == 4 * n
    assert sum(len(c) for c in code.colors) == n
    assert counts.philox_blocks_per_sweep(code) == blocks
    assert counts.plane_words(code.nq) == 1


def test_k2_window_hand_count():
    code = codes.toric(5)
    B, Nc, W, it, C = 2048, 5, 600, 2, 12
    n_bytes, popc, blocks = k2.work(code, B, Nc, W, it, C, True, True)
    assert popc == B * Nc * W * it * 100
    # three non-sweep uses a step, ceil(max(2, 12, 4, 1) / 4) = 3 blocks each
    assert blocks == B * Nc * W * it * 16 + B * W * 3 * 3
    state = B * Nc * 50 + 4 * (B * Nc + B + B * 16 + B)
    assert n_bytes == 2 * state + 4 * (W // C) * B + B + 4 * B + 4 * B * 4 + 60


@pytest.mark.parametrize("d", [3, 5])
def test_against_the_port(d):
    from mcmc_qec_tpu_torch.models.toric import toric_spec
    from mcmc_qec_tpu_torch.utils import roofline

    code, spec = codes.toric(d), toric_spec(d)
    for eq in (True, False):
        assert counts.popc_per_sweep(code, eq) == roofline.popc_per_sweep(
            spec, eq)
        assert k1.work(code, 999, 37, 2, eq)[1:] == roofline.sampler_work(
            spec, 999, 37, 2, eq)
    assert counts.philox_blocks_per_sweep(code) == \
        roofline.philox_blocks_per_sweep(spec)
    rates = dict(n_sm=132, clock_hz=1.98e9)
    for args in ((1e9, 1e9, 1e8, 1e7), (1e12, 1.0, 1.0, 0.0)):
        assert peaks.bound_ms(*args, **rates) == roofline.bound_ms(*args,
                                                                   **rates)
