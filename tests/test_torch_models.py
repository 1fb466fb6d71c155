"""The port's code tables against the JAX package.

Every ``CodeSpec`` table of ``mcmc_qec_tpu_torch.models`` and the colored
sweep tables must equal ``mcmc_qec_tpu``'s bit for bit: the ladder-window
kernel and its plain version are built from them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcmc_qec_tpu.models import get_spec as jax_get_spec
from mcmc_qec_tpu.models import noise as jax_noise
from mcmc_qec_tpu.ops.dense_sweep import _color_tables as jax_color_tables
from mcmc_qec_tpu_torch.convert import spec_from_jax
from mcmc_qec_tpu_torch.models import CodeSpec, get_spec, noise
from mcmc_qec_tpu_torch.models.noise import sample_depolarizing, sample_xyz
from mcmc_qec_tpu_torch.ops.dense_sweep import _color_tables

CASES = [(f, d) for f in ("toric", "planar", "rotated", "xzzx") for d in (3, 5)]


def assert_same_value(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, tuple) and a and dataclasses.is_dataclass(a[0]):
        assert len(a) == len(b), what
        for i, (da, db) in enumerate(zip(a, b)):
            for f in dataclasses.fields(da):
                assert_same_value(getattr(da, f.name), getattr(db, f.name),
                                  f"{what}[{i}].{f.name}")
    else:
        assert a == b, (what, a, b)


def assert_same_spec(ours, theirs):
    for f in dataclasses.fields(CodeSpec):
        assert_same_value(getattr(theirs, f.name), getattr(ours, f.name), f.name)


@pytest.mark.parametrize("family,d", CASES)
def test_spec_tables_equal_jax(family, d):
    assert_same_spec(get_spec(family, d), jax_get_spec(family, d))


@pytest.mark.parametrize("family,d", CASES)
def test_color_tables_equal_jax(family, d):
    ours = _color_tables(get_spec(family, d))
    theirs = jax_color_tables(jax_get_spec(family, d))
    assert len(ours) == len(theirs)
    for (s0, x0, z0), (s1, x1, z1) in zip(ours, theirs):
        for a, b in ((s0, s1), (x0, x1), (z0, z1)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_spec_from_jax_is_a_faithful_copy(family):
    jspec = jax_get_spec(family, 5)
    copy = spec_from_jax(jspec)
    assert isinstance(copy, CodeSpec)
    assert_same_spec(copy, jspec)
    assert copy.stab_masks is not jspec.stab_masks


@pytest.mark.parametrize("family", ["toric", "planar"])
def test_sample_depolarizing_marginals(family):
    """Per-qubit error rate p and uniform X/Y/Z over the valid cells;
    invalid (planar) cells stay 0."""
    spec = get_spec(family, 5)
    g = torch.Generator().manual_seed(7)
    s = sample_depolarizing(g, spec, 0.3, (4000,)).numpy()
    assert s.dtype == np.uint8 and s.shape == (4000, spec.nq)
    valid = spec.valid_mask.astype(bool)
    assert (s[:, ~valid] == 0).all()
    v = s[:, valid]
    n = v.size
    # binomial standard errors at n >= 100k samples are < 0.0015
    assert abs((v != 0).mean() - 0.3) < 0.01
    for pauli in (1, 2, 3):
        assert abs((v == pauli).sum() / n - 0.1) < 0.01


def test_sample_xyz_is_seeded():
    spec = get_spec("toric", 3)
    a = sample_xyz(torch.Generator().manual_seed(1), spec, 0.1, 0.05, 0.2, (8,))
    b = sample_xyz(torch.Generator().manual_seed(1), spec, 0.1, 0.05, 0.2, (8,))
    assert torch.equal(a, b)


@pytest.mark.parametrize("fn,args", [
    ("xyz_probs_from_biased", (0.1, 3.0)),
    ("alpha_tilde_from_p", (0.12, 1.7)),
    ("xyz_probs_from_alpha", (0.05, 1.7)),
    ("biased_alpha_equivalent", (0.1, 3.0)),
])
def test_noise_converters_equal_jax(fn, args):
    ours = np.asarray(getattr(noise, fn)(*args), float)
    theirs = np.asarray(getattr(jax_noise, fn)(*args), float)
    np.testing.assert_array_equal(ours, theirs)


def test_samplers_follow_a_cpu_generator():
    """``device=None`` means the generator's device: a CPU generator gives
    CPU tensors, the same as with ``device="cpu"`` given."""
    spec = get_spec("planar", 5)
    a = sample_depolarizing(torch.Generator().manual_seed(3), spec, 0.2, (6,))
    b = sample_depolarizing(torch.Generator().manual_seed(3), spec, 0.2, (6,),
                            device="cpu")
    c = sample_xyz(torch.Generator().manual_seed(3), spec, 0.2 / 3, 0.2 / 3,
                   0.2 / 3, (6,))
    assert a.device.type == "cpu"
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device (a CUDA generator)")
def test_samplers_follow_a_cuda_generator():
    """A CUDA generator and no ``device`` give CUDA tensors (the samplers
    once defaulted to the CPU and raised here)."""
    spec = get_spec("toric", 5)
    g = torch.Generator(device="cuda").manual_seed(3)
    s = sample_depolarizing(g, spec, 0.2, (6,))
    assert s.device.type == "cuda"
    g = torch.Generator(device="cuda").manual_seed(3)
    assert torch.equal(s, sample_depolarizing(g, spec, 0.2, (6,),
                                              device="cuda"))
    assert noise.sample_n_random_errors(g, spec, 4).device.type == "cuda"


def test_sample_n_random_errors_and_known_error_equal_jax():
    """Exactly n errors on valid cells (toric_model.py:26-32), and the
    reference's fixed injections, which equal the JAX package's."""
    for family in ("toric", "planar"):
        spec = get_spec(family, 5)
        g = torch.Generator().manual_seed(5)
        for n in (0, 3, 7):
            s = noise.sample_n_random_errors(g, spec, n).numpy()
            assert s.dtype == np.uint8 and (s != 0).sum() == n
            assert (s[spec.valid_mask == 0] == 0).all()
    for family in ("rotated", "xzzx"):
        np.testing.assert_array_equal(
            noise.known_error(get_spec(family, 5)),
            jax_noise.known_error(jax_get_spec(family, 5)))
    with pytest.raises(ValueError):
        noise.known_error(get_spec("toric", 5))
