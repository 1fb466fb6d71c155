"""The port's studies (``mcmc_qec_tpu_torch.studies``) on the CPU at
d=3: each ``main`` runs with ``--device cpu`` and writes the records of its
``examples/`` script (the keys and value types of that script's committed
JSON, or the keys its source writes); the threshold studies resume; the
batch seeds keep a grid's points independent; ``--device`` left at
``cuda`` raises without a card."""

import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch

from mcmc_qec_tpu_torch.models import get_spec
from mcmc_qec_tpu_torch.models.noise import sample_depolarizing
from mcmc_qec_tpu_torch.ops.ladder_window import ladder_window_counts
from mcmc_qec_tpu_torch.studies import (
    compare_decoders,
    failure_rates,
    head_to_head,
    scaling_bench,
    stepcap_study,
    threshold_fit,
    threshold_fit_biased,
    uncorrelated_study,
    xzzx_eta_sweep,
)
from mcmc_qec_tpu_torch.studies.sampling import batch_generator, batch_seed

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    """``main(argv)``'s return value and its stdout lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue().splitlines()


def _types(rec):
    return {k: type(v).__name__ for k, v in rec.items()}


def _committed(name):
    return json.loads((EXAMPLES / name).read_text())


def _script_writes(script, keys):
    """Every key is a quoted string in the JAX script's source."""
    src = (EXAMPLES / script).read_text()
    missing = [k for k in keys if f'"{k}"' not in src]
    assert not missing, missing


TINY_DEPOL = ["--sizes", "3", "-n", "8", "--batch", "8", "--cap", "600",
              "--device", "cpu"]


def test_threshold_fit_records_and_resume(tmp_path):
    """A grid cut after its first point finishes the rest; a second run on
    the finished file decodes nothing; the records are the committed
    grid's."""
    data = str(tmp_path / "thr.json")
    _, lines = _run(threshold_fit.main,
                    ["collect", "--ps", "0.1", "--data", data, *TINY_DEPOL])
    first = json.loads(Path(data).read_text())
    assert len(first) == 1 and json.loads(lines[-1]) == first[0]
    ladder_window_counts.reset()
    _run(threshold_fit.main,
         ["collect", "--ps", "0.1,0.15", "--data", data, *TINY_DEPOL])
    both = json.loads(Path(data).read_text())
    assert both[0] == first[0] and [r["p"] for r in both] == [0.1, 0.15]
    assert ladder_window_counts.plain_calls == 1  # one window of the new point
    ladder_window_counts.reset()
    _, lines = _run(threshold_fit.main,
                    ["collect", "--ps", "0.1,0.15", "--data", data, *TINY_DEPOL])
    assert ladder_window_counts.plain_calls == 0 and lines == []
    assert json.loads(Path(data).read_text()) == both
    ref = _committed("threshold_grid_r4.json")[0]
    for rec in both:
        assert _types(rec) == _types(ref)
        assert rec["n"] == 8 and rec["cap"] == 600 and rec["d"] == 3
        assert rec["fails"] == round(rec["failure_rate"] * 8)


def test_threshold_fit_fit_and_plot_subcommands(tmp_path):
    _, lines = _run(threshold_fit.main,
                    ["fit", "--data", str(EXAMPLES / "threshold_grid_r4.json"),
                     "--boot", "5"])
    out = json.loads("\n".join(lines))
    assert out["n_points"] == 30 and 0.18 < out["p_th"] < 0.21
    pytest.importorskip("matplotlib")
    png = tmp_path / "thr.png"
    _run(threshold_fit.main, ["plot", "--data",
                              str(EXAMPLES / "threshold_grid_r4.json"),
                              "--out", str(png)])
    assert png.stat().st_size > 0


def test_threshold_fit_biased_records(tmp_path):
    data = str(tmp_path / "eta.json")
    _run(threshold_fit_biased.main,
         ["collect", "--eta", "10", "--sizes", "3", "--ps", "0.2", "-n", "8",
          "--batch", "8", "--cap", "600", "--data", data, "--device", "cpu"])
    recs = json.loads(Path(data).read_text())
    ref = _committed("threshold_eta10_r5.json")[0]
    assert len(recs) == 1 and _types(recs[0]) == _types(ref)
    same_p = next(r for r in _committed("threshold_eta10_r5.json")
                  if r["p"] == 0.2)
    assert (recs[0]["pz_tilde"], recs[0]["alpha"]) == (same_p["pz_tilde"],
                                                       same_p["alpha"])


def test_uncorrelated_study_rows(tmp_path):
    data = str(tmp_path / "unc.json")
    argv = ["--sizes", "3", "--pk", "16", "-n", "16", "--batch", "16",
            "--outdir", str(tmp_path / "npz"), "--data", data, "--fig", "",
            "--device", "cpu"]
    rows, lines = _run(uncorrelated_study.main, argv)
    ref = _committed("uncorrelated_r5.json")[0]
    assert len(rows) == 1 and _types(rows[0]) == _types(ref)
    assert rows[0]["p"] == 0.139 and rows[0]["steps"] == 81
    assert json.loads(lines[-1]) == rows[0]
    rows2, lines2 = _run(uncorrelated_study.main, argv)  # resumes: nothing new
    assert rows2 == rows and lines2 == []


def test_xzzx_eta_sweep_lines():
    _, lines = _run(xzzx_eta_sweep.main,
                    ["--size", "3", "--ps", "0.1", "-n", "8", "--max-steps",
                     "400", "--device", "cpu"])
    rec = json.loads(lines[-1])
    assert list(rec) == ["eta", "p", "n", "failure_rate", "converged",
                         "seconds"]
    _script_writes("xzzx_eta_sweep.py", rec)
    assert isinstance(rec["converged"], int) and rec["n"] == 8


def test_failure_rates_records(tmp_path):
    out = tmp_path / "fr.json"
    _, lines = _run(failure_rates.main,
                    ["--sizes", "3", "--ps", "0.1", "-n", "8", "--steps", "40",
                     "--droplets", "1", "--out", str(out), "--device", "cpu"])
    recs = json.loads(out.read_text())
    assert recs == [json.loads(lines[-1])]
    assert list(recs[0]) == ["family", "d", "p", "n", "steps", "failure_rate",
                             "mc_err", "seconds"]
    _script_writes("failure_rates.py", recs[0])


def test_stepcap_study_records():
    _, lines = _run(stepcap_study.main,
                    ["--sizes", "3", "--ps", "0.1", "-n", "8", "--cap", "600",
                     "--mult", "2", "--device", "cpu"])
    rec = json.loads(lines[-1])
    assert list(rec) == ["family", "d", "p", "n", "cap", "mult", "mc_err",
                         "at_cap", "at_cap_x_mult", "decision_flips"]
    point = ["failure_rate", "converged_frac", "mean_steps", "seconds"]
    assert list(rec["at_cap"]) == point and list(rec["at_cap_x_mult"]) == point
    _script_writes("stepcap_study.py", list(rec) + point)
    assert rec["at_cap"]["mean_steps"] <= 600
    assert rec["at_cap_x_mult"]["mean_steps"] <= 1200


def test_compare_decoders_lines():
    _, lines = _run(compare_decoders.main,
                    ["--size", "3", "--batch", "4", "--steps", "60",
                     "--device", "cpu"])
    assert lines[0].startswith("planar d=3, p=0.1, 4 syndromes, true classes")
    names = [ln.split()[0] for ln in lines[1:]]
    assert names == ["STDC", "STRC", "PTDC", "PTEQ"]
    for ln in lines[1:]:
        assert re.search(r"\d+\.\ds  calls \[.*\]  correct \d/4$", ln), ln


def test_head_to_head_ours_phase(tmp_path):
    out = tmp_path / "h2h.json"
    _run(head_to_head.main,
         ["--phase", "ours", "-n", "4", "--stdc-steps", "50", "--strc-steps",
          "50", "--out", str(out), "--device", "cpu"])
    written = json.loads(out.read_text())
    ref = _committed("head_to_head_r5.json")
    assert list(written) == list(ref)
    assert [c["pair"] for c in written["comparisons"]] == [
        c["pair"] for c in ref["comparisons"]]
    for a, b in zip(written["comparisons"], ref["comparisons"]):
        assert _types(a) == _types(b)
    # the reference's own columns come from the cache unchanged
    assert written["comparisons"][0]["argmax_agree"].endswith("/4")
    with pytest.raises(SystemExit, match="not in the repository"):
        head_to_head.main(["--phase", "ref", "--device", "cpu"])


def test_scaling_bench_lines(monkeypatch):
    monkeypatch.setattr(scaling_bench, "CPU_MESH", 2)
    monkeypatch.setattr(scaling_bench, "PER_DEVICE", 2)
    monkeypatch.setattr(scaling_bench, "STEPS", 20)
    res, lines = _run(scaling_bench.main, ["--cpu"])
    assert sorted(res) == [1, 2]
    for ln, nd in zip(lines, (1, 2)):
        assert re.fullmatch(
            rf"devices={nd}: +\d+\.\d syndromes/s  \(weak-scaling "
            rf"efficiency \d+%\)", ln), ln


def test_batch_seeds_independent_along_p_and_d():
    """Batches at the same rep and d but another p draw other states, and
    no two cells of the committed grids share a seed."""
    spec = get_spec("toric", 5)
    a, b = (sample_depolarizing(batch_generator(torch.device("cpu"), 1000 * 0
                                                + 5, p), spec, 0.5, (64,))
            for p in (0.19, 0.1975))
    assert not torch.equal(a, b)
    for name, key in (("threshold_grid_r4.json", lambda rep, d: 1000 * rep + d),
                      ("threshold_eta10_r5.json",
                       lambda rep, d: 7000 * rep + 31 * d)):
        cells = {(r["d"], r["p"]) for r in _committed(name)}
        seeds = {batch_seed(key(rep, d), p) for d, p in cells
                 for rep in range(4)}
        assert len(seeds) == 4 * len(cells)
    with pytest.raises(ValueError):
        batch_seed(1, 11.0)


STUDY_MAINS = {
    "threshold_fit": (threshold_fit.main, ["collect", "--sizes", "3", "--ps",
                                           "0.1", "--data", "unused.json"]),
    "threshold_fit_biased": (threshold_fit_biased.main,
                             ["collect", "--sizes", "3", "--ps", "0.2",
                              "--data", "unused.json"]),
    "xzzx_eta_sweep": (xzzx_eta_sweep.main, ["--size", "3"]),
    "uncorrelated_study": (uncorrelated_study.main, ["--sizes", "3"]),
    "failure_rates": (failure_rates.main, ["--sizes", "3"]),
    "stepcap_study": (stepcap_study.main, ["--sizes", "3"]),
    "compare_decoders": (compare_decoders.main, ["--size", "3"]),
    "head_to_head": (head_to_head.main, ["--phase", "ours"]),
    "scaling_bench": (scaling_bench.main, []),
}


@pytest.mark.parametrize("name", STUDY_MAINS)
def test_default_device_raises_without_a_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    monkeypatch.chdir(tmp_path)
    main, argv = STUDY_MAINS[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _run(main, argv)
    assert not (tmp_path / "unused.json").exists()
