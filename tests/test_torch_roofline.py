"""The card's bound as a module of the port (mcmc_qec_tpu_torch/utils/
roofline.py, counterpart of mcmc_qec_tpu/utils/roofline.py): its work
counts at toric d=5 against counts by hand, its arithmetic against the
rates, the popcounts at two or four a stabilizer wherever its support
spans more than one word, and the recording sampler's pass over
the qubits counted once a launch."""

import pytest

from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.utils import roofline


def test_counts_at_toric_d5_by_hand():
    spec = get_spec("toric", 5)
    # 50 stabilizers, each on one 64-bit word (nq = 50); colors of 9, 10,
    # 9, 8, 6, 6 and 2 stabilizers take 3 + 3 + 3 + 2 + 2 + 2 + 1 Philox
    # blocks of four draws
    assert sorted(int((c < spec.n_stabs).sum()) for c in spec.color_stabs) == [
        2, 6, 6, 8, 9, 9, 10]
    # two 32-bit popcounts a stabilizer with equal betas, four with general
    assert roofline.popc_per_sweep(spec, True) == 100
    assert roofline.popc_per_sweep(spec, False) == 200
    assert roofline.philox_blocks_per_sweep(spec) == 16
    # 1000 chains, 7 steps of 2 sweeps: per chain and step 2 * 100 sweep
    # popcounts and 2 * 16 blocks; once per chain 3 64-bit (6 32-bit)
    # popcounts for the counts and 2 * 50 multiplies for the hash (the
    # records after that follow the accepted flips)
    assert roofline.sampler_work(spec, 1000, 7, 2, True) == (
        1000 * (7 * 200 + 6), 1000 * 7 * 32, 1000 * 100)


def test_bound_ms_is_the_larger_of_bytes_and_operations():
    n_sm, clock = 132, 1.98e9
    ms, by = roofline.bound_ms(3.35e9, 0, 0, n_sm=n_sm, clock_hz=clock)
    assert by == "bytes" and ms == pytest.approx(1.0)
    popc = 16 * n_sm * clock  # one second of popcounts
    ms, by = roofline.bound_ms(1.0, popc, 0, n_sm=n_sm, clock_hz=clock)
    assert by == "operations" and ms == pytest.approx(1e3)
    blocks = 64 * n_sm * clock / 40  # one second of Philox blocks
    ms, by = roofline.bound_ms(1.0, 0, blocks, 64 * n_sm * clock, n_sm=n_sm,
                               clock_hz=clock)
    assert by == "operations" and ms == pytest.approx(2e3)
    spec = get_spec("toric", 5)
    popc, blk, imad = roofline.sampler_work(spec, 10, 3, 1, False)
    assert roofline.sampler_bound(spec, 10, 3, 1, False, 5e6, n_sm=n_sm,
                                  clock_hz=clock) == roofline.bound_ms(
        5e6, popc, blk, imad, n_sm=n_sm, clock_hz=clock)


@pytest.mark.parametrize("family,d", [("toric", 23), ("rotated", 33)])
def test_large_variant_counts_the_words_the_supports_span(family, d):
    spec = get_spec(family, d)
    words = sum(len({int(q) // 64 for q, o in zip(spec.stab_qubits[s],
                                                    spec.stab_ops[s]) if o})
                for s in range(spec.n_stabs))
    assert words > spec.n_stabs
    # the popcounts count a stabilizer's qubits, not the words it spans
    assert roofline.popc_per_sweep(spec, False) == 4 * spec.n_stabs
    sizes = [int((c < spec.n_stabs).sum()) for c in spec.color_stabs]
    assert roofline.philox_blocks_per_sweep(spec) == sum(-(-n // 4) for n in sizes)
    nw = -(-spec.nq // 64)
    assert roofline.sampler_work(spec, 1, 1, 1, True)[0] == (
        2 * spec.n_stabs + 6 * nw)
    # the pass over the qubits is once a launch, not once a step
    assert roofline.sampler_work(spec, 1, 10, 1, True)[0] == (
        10 * 2 * spec.n_stabs + 6 * nw)
    assert roofline.sampler_work(spec, 3, 10, 1, True)[2] == 3 * 2 * spec.nq
