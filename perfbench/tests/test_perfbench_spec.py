"""Every configuration and cell file parses and meets the benchmark's
contract: names, units, bounds, the metrics each cell reports, the
readers, the time budget of a full check."""

import json
import re

import pytest

from perfbench.harness import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()


def test_benchmark_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells_max = 24
    total = (2 + 14 * cells_max) * (BENCH["run_seconds"] + 60) \
        + cells_max * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = cells.load_json(cells.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and NAME.match(entry["name"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"]
    assert entry["reduced"] == cfg["reduced"] == []
    assert 1 <= len(entry["why"]) <= 200
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file(entry):
    spec = cells.load(entry["name"])
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    assert set(spec["cell"]) >= {"name", "config", "traffic", "chips",
                                 "driver", "params", "limits", "why"}
    assert (cells.PERFBENCH / "traffic" /
            f"{spec['cell']['driver']}.py").exists()
    e2e = [m["name"] for m in spec["metrics"]["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["metrics"]["per_layer"]
    for m in spec["metrics"]["per_layer"]:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in names and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
