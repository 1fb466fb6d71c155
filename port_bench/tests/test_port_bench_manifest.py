"""BENCHMARK.json in its required form, and every file it names
found by name."""

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["port_bench"]
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_distinct_across_kinds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if m in MAN["end_to_end"] else {"layer", "moves"}
    assert keys <= set(m) <= keys | {"workloads"}
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        e2e = {e["name"]: e for e in MAN["end_to_end"]}
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= moved
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cell = harness.cell(w["name"])
    assert harness.driver_class(cell["config_data"]["driver"])
    if w["chips"] > 1:
        assert cell["traffic_data"]["ranks"] == w["chips"]
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_one_four_chip_cell_at_most_a_quarter():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"] == f"port_bench/configs/{c['name']}.json"
    data = json.loads((ROOT / c["file"]).read_text())
    assert sorted(c["reduced"]) == sorted(data["reduced"])
    assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_check_budget_fits():
    """2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to compile,
    1200 s spare, within 43200 s at 24 cells."""
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_its_configurations_rate(w):
    cell = harness.cell(w["name"])
    rate = cell["config_data"]["rate_metric"]
    assert rate in {m["name"] for m in cell["end_to_end"]}
    assert {m["name"]: m["unit"] for m in MAN["end_to_end"]}[rate] == "syn/s"
