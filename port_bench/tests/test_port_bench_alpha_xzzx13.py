"""The biased-noise cell ``pteq_alpha_xzzx13.eta10_p0275_b512``: its entries
and files found by name, the reader of K2's time a row in its large
variant, and a run of its configuration cut to XZZX d=3 through the harness
on the CPU, with the bf16 control."""

import ast
import copy
import json
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "pteq_alpha_xzzx13.eta10_p0275_b512"
LISTED = ("syn_per_s", "device.idle_pct", "k2_roofline", "k2.rows_per_launch",
          "pteq.windows_per_batch", "pteq.dispatch_ms_per_window",
          "pteq.automaton_ms_per_window", "pteq.compact_ms_per_window",
          "k2.large_us_per_row")


def test_config_and_cell_in_the_manifest():
    man = harness.manifest()
    cfg = {c["name"]: c for c in man["configs"]}["pteq_alpha_xzzx13"]
    assert cfg["reduced"] == ["max_steps"]
    assert (ROOT / cfg["file"]).is_file()
    cell = harness.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pteq_alpha_xzzx13", "eta10_p0275_b512", 1)
    c = cell["config_data"]
    assert c["source"] == cfg["source"] and len(c["source"]) <= 200
    assert (c["driver"], c["rate_metric"]) == ("pteq_alpha", "syn_per_s")
    assert (c["code"]["family"], c["code"]["size"]) == ("xzzx", 13)
    dec = c["decoder"]
    assert (dec["Nc"], dec["iters"], dec["SEQ"], dec["TOPS"], dec["tops_burn"],
            dec["eps"], dec["window"], dec["energy_chunk"]) == (
        13, 10, 2, 10, 2, 0.01, 600, 12)
    red = c["reduced"]["max_steps"]
    assert red["source"] == 5 * 13 ** 5
    assert dec["max_steps"] == red["here"] in (32955, 12000, 6000)
    assert {"batch", "eps", "window", "energy_chunk", "engine"} <= set(
        c["assumed"])
    assert set(c["check"]) == {"every", "replay_every", "replay_rows",
                               "reserve_mb"}
    t = cell["traffic_data"]
    assert (t["p"], t["eta"], t["batch"], t["pool_batches"]) == (
        0.275, 10.0, 512, 24)
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s", "syn_per_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(LISTED[1:])
    for m in cell["per_layer"]:
        assert callable(harness.reader(m["name"]))
    large = {m["name"]: m for m in man["per_layer"]}["k2.large_us_per_row"]
    assert large == {"name": "k2.large_us_per_row", "unit": "us",
                     "better": "lower", "source": "device_trace",
                     "layer": "K2: ops/ladder_window.py + csrc/ladder_window.cu",
                     "moves": "syn_per_s", "workloads": [CELL]}
    # the cell is appended last where it is listed
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in LISTED:
            assert m["workloads"][-1] == CELL


def _imports_of_the_port(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    return {m.split(".")[0] for m in names} & {
        "mcmc_qec_tpu_torch", *harness.FOREIGN}


def test_biased_inputs_import_nothing_of_the_port():
    """The pool, like the reference, is drawn without the port's code."""
    assert not _imports_of_the_port(ROOT / "port_bench" / "inputs_biased.py")


def test_reference_alpha_noise_imports_nothing_of_the_port():
    """The reference's biased noise and alpha ladder, which the program's
    ladder is held to, are worked out without the port's code."""
    assert not _imports_of_the_port(
        ROOT / "port_bench" / "reference" / "alpha_noise.py")


# (counters, kernels {name: [seconds, launches]}) of a traced run: the
# register form's launches and rows stay out of the large variant's
WIDE = "void mqt::ladder_window_kernel_wide<false>(mqt::WindowParams)"
REG = "void mqt::ladder_window_kernel<3, 2, false>(mqt::WindowParams)"
COUNTERS = {"k2.rows.large": 10_240, "k2.rows.registers": 4096}
KERNELS = {WIDE: [2.4, 20], REG: [0.5, 12], "other": [9.0, 3]}
LARGE = "k2.large_us_per_row"


def _plant(monkeypatch, counters):
    from mcmc_qec_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": counters})


def test_reader_from_a_planted_snapshot(monkeypatch):
    _plant(monkeypatch, COUNTERS)
    assert harness.reader(LARGE)({"kernels": KERNELS}) == pytest.approx(
        1e6 * 2.4 / 10_240)


@pytest.mark.parametrize("counters, kernels", [
    ({}, KERNELS),  # a program without the counter (the parent's)
    ({"k2.rows.registers": 4096}, {REG: [0.5, 12]}),  # no large launch
    (COUNTERS, {REG: [0.5, 12], "other": [9.0, 3]}),
    (COUNTERS, {}),
])
def test_reader_with_nothing_to_read(monkeypatch, counters, kernels):
    _plant(monkeypatch, counters)
    assert harness.reader(LARGE)({"kernels": kernels}) is None


def test_reader_without_a_trace(monkeypatch):
    _plant(monkeypatch, COUNTERS)
    assert harness.reader(LARGE)({}) is None


def small_cell() -> dict:
    """The cell at XZZX d=3, Nc=3, 10 windows of 60 steps, 16 syndromes a
    request, every request checked and replayed."""
    cell = harness.cell(CELL)
    cfg = copy.deepcopy(cell["config_data"])
    cfg["code"]["size"] = 3
    cfg["decoder"].update(Nc=3, max_steps=600, window=60, energy_chunk=12)
    cfg["check"].update(every=1, replay_every=1, replay_rows=8)
    cell["config_data"] = cfg
    cell["traffic_data"] = dict(p=0.275, eta=10.0, batch=16, pool_batches=4)
    return cell


def _run(control=None):
    from port_bench.run import run_cell

    return run_cell(small_cell(), 2**31 + 77, 0.5, False, device="cpu",
                    control=control)


def test_the_cell_cut_to_xzzx_3_runs_and_compares():
    res, quality = _run()
    assert res["correct"]
    assert {k: v[0] for k, v in res["checks"].items()} == {
        "window_rows_differing": 0, "chain_breaks": 0,
        "readout_syndromes_differing": 0, "ladder_entries_differing": 0}
    assert quality["plain_calls"] > 0 and quality["syndromes"] >= 16
    assert quality["rows_replayed"] > 0
    assert "general_launches" in quality and 0 <= quality["converged"] <= 1
    assert set(res["metrics"]) == {"setup_s", "syn_per_s"}
    json.dumps(res)


def test_the_bf16_control_is_not_correct():
    res, _ = _run("bf16")
    assert not res["correct"]
    assert res["checks"]["window_rows_differing"][0] > 0
