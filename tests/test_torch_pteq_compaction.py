"""Batch compaction in the port's PTEQ host loop (its own file: two full
decodes on the plain CPU window take half a minute)."""

import numpy as np

from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.decoders import PTEQ, PTEQConfig
from mcmc_qec_tpu_torch.models import np_eq_class


def _depolarizing(spec, p, B, seed):
    rng = np.random.RandomState(seed)
    s = np.where(rng.uniform(size=(B, spec.nq)) < p,
                 rng.randint(1, 4, size=(B, spec.nq)), 0)
    return (s * spec.valid_mask).astype(np.uint8)


def test_pteq_batch_compaction_preserves_results():
    """tests/test_decoders.py:332-354 bars: compaction repacks unconverged
    stragglers into smaller buckets without hurting quality."""
    spec = spec_from_jax(jax_get_spec("toric", 3))
    B = 64
    states = _depolarizing(spec, 0.05, B, seed=9)
    true = np_eq_class(spec, states)
    base = dict(max_steps=8000, window=100, iters=2, TOPS=3, SEQ=1, eps=0.5)
    res_c = PTEQ(spec, states, 0.05,
                 PTEQConfig(**base, compact=True, min_compact=8), seed=5,
                 device="cpu")
    res_n = PTEQ(spec, states, 0.05, PTEQConfig(**base, compact=False),
                 seed=5, device="cpu")
    assert len(res_c.buckets) >= 1, "compaction never triggered"
    assert res_n.buckets == ()
    for res in (res_c, res_n):
        assert res.distribution.shape == (B, spec.n_classes)
        assert (res.distribution[res.converged].sum(axis=1) > 80).all()
        assert np.mean(res.distribution.argmax(axis=1) == true) > 0.9
        assert res.converged.mean() > 0.7
