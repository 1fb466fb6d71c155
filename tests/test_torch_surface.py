"""The port's capability surface: tests/test_parity_surface.py's
``SURFACE`` map, with ``mcmc_qec_tpu`` renamed, holds for
``mcmc_qec_tpu_torch``.  One entry differs:
``ops.pallas_sweep.make_pallas_sweep`` is ``ops.sweep.make_sweep`` (the
sweep kernel K1's wrapper).  ``parallel`` holds the JAX package's nine
names and ``map_shards``.  The pipeline, CLI, matching, native, utils and
parallel modules and ``graft_entry`` import neither jax nor anything of
the JAX package."""

import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

from test_parity_surface import SURFACE as JAX_SURFACE

# JAX module -> (port module, its names) where the port differs
RENAMED = {"mcmc_qec_tpu.ops.pallas_sweep": ("mcmc_qec_tpu_torch.ops.sweep",
                                             ["make_sweep"])}
# JAX module -> why the port does not have it yet
NOT_YET = {}


def _port_surface():
    out = {}
    for module, names in JAX_SURFACE.items():
        if module in NOT_YET:
            continue
        if module in RENAMED:
            out.update([RENAMED[module]])
            continue
        out[module.replace("mcmc_qec_tpu", "mcmc_qec_tpu_torch", 1)] = names
    return out


SURFACE = _port_surface()


def test_every_jax_module_is_mapped():
    assert not NOT_YET
    assert set(RENAMED) <= set(JAX_SURFACE)
    assert len(SURFACE) == len(JAX_SURFACE)
    assert set(SURFACE["mcmc_qec_tpu_torch.parallel"]) == set(
        JAX_SURFACE["mcmc_qec_tpu.parallel"])


@pytest.mark.parametrize("module,names", SURFACE.items(),
                         ids=list(SURFACE.keys()))
def test_surface_exists(module, names):
    mod = importlib.import_module(module)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} lost surface: {missing}"


def test_all_decoder_methods_dispatchable():
    """Every method name of the JAX dispatcher resolves in the port's."""
    import mcmc_qec_tpu.pipeline.generate  # noqa: F401
    import mcmc_qec_tpu_torch.pipeline.generate  # noqa: F401

    theirs = inspect.getsource(
        sys.modules["mcmc_qec_tpu.pipeline.generate"].decode_batch)
    ours = inspect.getsource(
        sys.modules["mcmc_qec_tpu_torch.pipeline.generate"].decode_batch)
    methods = ["PTEQ", "PTEQ_with_shortest", "all", "shortest_comparison",
               "uncorrelated_comparison", "PTDC", "PTRC", "STDC", "STDC_N_n",
               "ST", "STRC", "eMWPM", "MWPM"]
    for m in methods:
        assert f'"{m}"' in theirs, m
        assert f'"{m}"' in ours, f"method {m} not dispatched"


def test_new_modules_import_no_jax():
    """A fresh interpreter (this one has jax loaded by tests/conftest.py)."""
    code = (
        "import sys, mcmc_qec_tpu_torch.pipeline, mcmc_qec_tpu_torch.cli, "
        "mcmc_qec_tpu_torch.matching, mcmc_qec_tpu_torch.native, "
        "mcmc_qec_tpu_torch.utils, mcmc_qec_tpu_torch.pipeline.plot, "
        "mcmc_qec_tpu_torch.parallel, mcmc_qec_tpu_torch.graft_entry;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mcmc_qec_tpu', 'triton', 'matplotlib'));"
        "print(','.join(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "", out.stdout
