"""The comparison that decides ``correct`` must fail: the control (the
plain reference in bfloat16 in the kernel's place) and faults planted in
the timed path underneath an otherwise whole run, on the CPU at toric d=3.
A sound run of the same small cell comes out correct."""

import warnings

import numpy as np
import pytest
import torch

from .conftest import run_small, small_cell

PTEQ = "pteq_toric5.p015_b2603"
STDC = "stdc_toric5.p010_b1024"


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _checks(result):
    return {k: v[0] for k, v in result["checks"].items()}


@pytest.mark.parametrize("name", [PTEQ, STDC])
def test_sound_run_is_correct(name):
    result, quality = run_small(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and quality["plain_calls"] > 0


@pytest.mark.parametrize("name", [PTEQ, STDC])
def test_control_is_not_correct(name):
    result, _ = run_small(name, control="bf16")
    assert not result["correct"], result["checks"]


def _window_fault(monkeypatch, kind):
    """K2's place on the CPU (the plain window) with ``kind`` planted."""
    import mcmc_qec_tpu_torch.ops.ladder_window as lw

    orig = lw.ladder_window_reference

    def window(spec, state, flag, tops0, eq, sb, seed, betas, w, **kw):
        out = list(orig(spec, state, flag, tops0, eq, sb, seed, betas, w,
                        **kw))
        if kind == "stale_state":
            out[0] = state.clone()
        elif kind == "half_batch":
            h = (state.shape[0] + 1) // 2
            for j, t in enumerate(out):
                if j == 5:
                    t[:, h:] = t[:, :1]
                else:
                    t[h:] = t[:1]
        elif kind == "altered_count":
            out[3] = out[3].clone()
            out[3][:, 0] += 1
        return tuple(out)

    monkeypatch.setattr(lw, "ladder_window_reference", window)


@pytest.mark.parametrize("kind", ["stale_state", "half_batch",
                                  "altered_count"])
def test_pteq_window_faults(monkeypatch, kind):
    _window_fault(monkeypatch, kind)
    result, _ = run_small(PTEQ)
    assert not result["correct"]
    assert _checks(result)["window_rows_differing"] > 0


def test_pteq_altered_answer(monkeypatch):
    import mcmc_qec_tpu_torch.decoders.pteq as pm

    orig = pm.pteq_run

    def run(*a, **k):
        res = orig(*a, **k)
        res.distribution = np.roll(res.distribution, 1, axis=1)
        return res

    monkeypatch.setattr(pm, "pteq_run", run)
    result, _ = run_small(PTEQ)
    assert not result["correct"]
    assert _checks(result)["readout_syndromes_differing"] > 0


def _sampler_fault(monkeypatch, kind):
    import mcmc_qec_tpu_torch.ops.sweep as sw

    orig = sw.sample_reference

    def sample(spec, states, seeds, betas, iters=1, equal_betas=False):
        st, keys, counts = orig(spec, states, seeds, betas, iters, equal_betas)
        if kind == "stale_state":
            st = states.clone()
        elif kind == "half_batch":
            h = (states.shape[0] + 1) // 2
            for t in (st, keys, counts):
                t[h:] = t[:1]
        return st, keys, counts

    monkeypatch.setattr(sw, "sample_reference", sample)


@pytest.mark.parametrize("kind", ["stale_state", "half_batch"])
def test_stdc_sampler_faults(monkeypatch, kind):
    _sampler_fault(monkeypatch, kind)
    result, _ = run_small(STDC)
    assert not result["correct"]
    assert _checks(result)["stream_samples_differing"] > 0


def test_stdc_altered_answer(monkeypatch):
    import mcmc_qec_tpu_torch.decoders.stdc as sm

    orig = sm.stdc_run

    def run(*a, **k):
        distr, logz = orig(*a, **k)
        return np.roll(distr, 1, axis=1), logz

    monkeypatch.setattr(sm, "stdc_run", run)
    result, _ = run_small(STDC)
    assert not result["correct"]
    assert _checks(result)["pct_gap_max"] > 0.01


def test_small_cell_keeps_the_cells_shape():
    cell = small_cell(PTEQ)
    assert cell["config_data"]["driver"] == "pteq"
    assert torch.get_num_threads() == 1
