"""A cell, a configuration and a per-layer metric added as files (and
entries in BENCHMARK.json) are found without a change to the harness."""

import json
import shutil

from perfbench.harness import cell as cells


def test_new_cell_config_and_metric_are_found(tmp_path):
    pb = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(cells.PERFBENCH / sub, pb / sub)
    bench = cells.benchmark()
    cfg = cells.load_json(pb / "configs/prompttts_final_serve.json")
    cfg["name"] = "prompttts_final_serve_b"
    (pb / "configs/prompttts_final_serve_b.json").write_text(json.dumps(cfg))
    cell = cells.load_json(pb / "workloads/serve_online_b1.json")
    cell.update(name="serve_bursty_b1", config="prompttts_final_serve_b",
                traffic="bursty_b1")
    (pb / "workloads/serve_bursty_b1.json").write_text(json.dumps(cell))
    (pb / "metrics/burst_gap_ms.py").write_text(
        "def read(run, name):\n    return 7.0\n")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="prompttts_final_serve_b"))
    bench["workloads"].append(dict(name="serve_bursty_b1",
                                   config="prompttts_final_serve_b",
                                   traffic="bursty_b1", chips=1, why="x"))
    for m in bench["end_to_end"]:
        if m["name"] == "request_p95_ms":
            m["workloads"].append("serve_bursty_b1")
    bench["per_layer"].append(dict(
        name="burst_gap_ms.online", unit="ms", better="lower",
        source="host_clock", layer="Synthesizer", moves="request_p95_ms",
        workloads=["serve_bursty_b1"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = cells.load("serve_bursty_b1", root=tmp_path, perfbench=pb)
    assert spec["config"]["name"] == "prompttts_final_serve_b"
    assert spec["cell"]["driver"] == "open_loop"
    e2e = {m["name"] for m in spec["metrics"]["end_to_end"]}
    assert e2e == {"request_p95_ms", "setup_s"}
    per = {m["name"] for m in spec["metrics"]["per_layer"]}
    assert per == {"burst_gap_ms.online"}
    # found by its stem, as device_idle_pct.py serves its three metrics
    assert cells.reader("burst_gap_ms.online", perfbench=pb)(None, "") == 7.0
    assert cells.driver(spec["cell"]["driver"]).window


def test_existing_cells_keep_their_metrics():
    spec = cells.load("serve_online_b1")
    per = {m["name"] for m in spec["metrics"]["per_layer"]}
    assert per == {"device_idle_pct.online", "queue_wait_p50_ms.online",
                   "launches_per_request.online"}


def test_metric_without_workloads_goes_with_what_it_moves():
    # BENCHMARK.json may give a per-layer metric no ``workloads``: it is
    # then reported in every cell that reports the metric it moves, those
    # that later entries add too
    bench = cells.benchmark()
    bench["per_layer"].append(dict(
        name="decode_replay_ms", unit="ms", better="lower",
        source="device_trace", layer="decode graph", moves="audio_s_per_s"))
    per = {m["name"] for m in
           cells.metrics_of(bench, "serve_offline_b16")["per_layer"]}
    assert "decode_replay_ms" in per
    for cell in ("serve_online_b1", "train_b10k"):
        per = {m["name"] for m in cells.metrics_of(bench, cell)["per_layer"]}
        assert "decode_replay_ms" not in per
