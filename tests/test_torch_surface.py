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


# example script (driving the JAX package) -> the port's study module
STUDIES = {
    "threshold_fit.py": "threshold_fit",
    "threshold_fit_biased.py": "threshold_fit_biased",
    "xzzx_eta_sweep.py": "xzzx_eta_sweep",
    "uncorrelated_study.py": "uncorrelated_study",
    "failure_rates.py": "failure_rates",
    "stepcap_study.py": "stepcap_study",
    "compare_decoders.py": "compare_decoders",
    "head_to_head.py": "head_to_head",  # --phase ours only
    "scaling_bench.py": "scaling_bench",
    "golden_replay.py": "golden_replay",  # --corpus required
    "golden_ceiling.py": "golden_ceiling",  # --corpus required
}
# what waits, and the file it needs that the repository does not hold
WAITING = {
    "head_to_head.py --phase ref|all": "the executing reference "
                                       "implementation (decoders.py)",
    "head_to_head_biased.py": "the executing reference implementation "
                              "(decoders_biasednoise.py)",
}
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_every_example_script_is_mapped():
    drives_jax = {p.name for p in EXAMPLES.glob("*.py")
                  if "mcmc_qec_tpu" in p.read_text()}
    waiting = {w.split()[0] for w in WAITING}
    assert drives_jax == set(STUDIES) | (waiting - set(STUDIES))
    assert len(WAITING) == 2


@pytest.mark.parametrize("script", STUDIES)
def test_study_module_runs_as_main(script):
    name = f"mcmc_qec_tpu_torch.studies.{STUDIES[script]}"
    mod = importlib.import_module(name)
    assert callable(mod.main)
    src = inspect.getsource(mod)
    assert 'if __name__ == "__main__":' in src
    assert '"--device"' in src
    assert "examples." not in src and "import jax" not in src


def test_studies_import_no_jax():
    """The study modules, in a fresh interpreter, import neither jax nor
    anything of the JAX package (nor matplotlib or triton)."""
    mods = ", ".join(f"mcmc_qec_tpu_torch.studies.{m}"
                     for m in ["fss", "sampling", *STUDIES.values()])
    code = (
        f"import sys, {mods};"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mcmc_qec_tpu', 'triton', 'matplotlib'));"
        "print(','.join(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "", out.stdout
