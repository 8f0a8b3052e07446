"""BENCHMARK.json against the contract's rules, and the data-driven
layout: every name resolves to its own file under tdbench/."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TD = ROOT / "tdbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["tdbench"]
    assert BENCH["command"] == ["python3", "tdbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text_fields():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_every_name_resolves_to_its_file():
    cfgs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.parent == TD / "configs"
        spec = json.loads(f.read_text())
        assert spec["name"] == c["name"] and spec["source"] == c["source"]
        assert spec["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs
        assert (TD / "traffic" / f"{w['traffic']}.json").is_file()
        assert (TD / "limits" / f"{w['name']}.json").is_file()
    assert cfgs == {w["config"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (TD / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_moves_names_a_metric_each_cell_reports():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        assert any(cell in e for n, e in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_are_set(cell):
    spec = json.loads((TD / "limits" / f"{cell}.json").read_text())
    for k in ("gap_max", "sel_rel"):
        assert 0 < spec[k]["limit"] < 1e6
