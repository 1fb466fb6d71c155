"""The threshold-study cell ``pteq_toric13_study.p019_b512``: its entries
and files found by name, the reader of ``k2.waves_per_launch``, and a run
of its configuration cut to toric d=3 through the harness on the CPU."""

import json
from pathlib import Path

import pytest

from port_bench import harness

from .conftest import run_small

ROOT = Path(__file__).resolve().parents[2]
CELL = "pteq_toric13_study.p019_b512"
D5 = "pteq_toric5.p015_b2603"


def test_config_and_cell_in_the_manifest():
    man = harness.manifest()
    cfg = {c["name"]: c for c in man["configs"]}["pteq_toric13_study"]
    assert cfg["reduced"] == ["max_steps"]
    assert (ROOT / cfg["file"]).is_file()
    cell = harness.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pteq_toric13_study", "p019_b512", 1)
    c = cell["config_data"]
    assert c["code"] == {"family": "toric", "size": 13}
    dec = c["decoder"]
    assert (dec["Nc"], dec["iters"], dec["window"]) == (13, 10, 600)
    assert set(c["reduced"]) == {"max_steps"}
    assert dec["max_steps"] == c["reduced"]["max_steps"]["here"]
    assert {"source", "deployment", "assumed", "check"} <= set(c)
    t = cell["traffic_data"]
    assert (t["p"], t["batch"], t["pool_batches"]) == (0.19, 512, 24)
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s", "syn_per_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "device.idle_pct", "k2_roofline", "k2.rows_per_launch",
        "k2.waves_per_launch", "pteq.windows_per_batch",
        "pteq.dispatch_ms_per_window", "pteq.automaton_ms_per_window",
        "pteq.compact_ms_per_window"}
    for m in cell["per_layer"]:
        assert callable(harness.reader(m["name"]))
    waves = {m["name"]: m for m in man["per_layer"]}["k2.waves_per_launch"]
    assert waves["workloads"] == [CELL, D5]
    assert (waves["unit"], waves["better"], waves["source"], waves["moves"]) \
        == ("waves", "lower", "program_counter", "syn_per_s")


TRACED = {"kernels": {}}  # the record of a traced run holds the reduction


def _plant(monkeypatch, counters):
    from mcmc_qec_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": counters})


@pytest.mark.parametrize("counters, want", [
    ({"k2.form.registers": 4, "k2.waves_micro": 15_520_000}, 3.88),
    ({"k2.form.registers": 3, "k2.form.large": 1,
      "k2.waves_micro": 2_000_000}, 0.5),
])
def test_waves_reader_from_a_planted_snapshot(monkeypatch, counters, want):
    _plant(monkeypatch, counters)
    assert harness.reader("k2.waves_per_launch")(TRACED) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{}, {"k2.waves_micro": 5},
                                      {"k2.form.registers": 2}])
def test_waves_reader_with_nothing_to_read(monkeypatch, counters):
    _plant(monkeypatch, counters)
    assert harness.reader("k2.waves_per_launch")(TRACED) is None


def test_waves_reader_without_a_trace(monkeypatch):
    _plant(monkeypatch, {"k2.form.registers": 4, "k2.waves_micro": 4})
    assert harness.reader("k2.waves_per_launch")({}) is None


def test_waves_reader_of_a_program_without_the_recorder(monkeypatch):
    from mcmc_qec_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert harness.reader("k2.waves_per_launch")(TRACED) is None


def test_the_cell_cut_to_toric_3_runs_and_compares():
    res, quality = run_small(CELL)
    assert res["correct"]
    assert {k: v[0] for k, v in res["checks"].items()} == {
        "window_rows_differing": 0, "chain_breaks": 0,
        "readout_syndromes_differing": 0}
    assert quality["plain_calls"] > 0 and quality["syndromes"] >= 16
    assert set(res["metrics"]) == {"setup_s", "syn_per_s"}
    json.dumps(res)
