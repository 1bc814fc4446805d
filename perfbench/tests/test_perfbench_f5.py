"""The F5-TTS cell end to end on the CPU at a tiny size: the server, the
closed loop, the check against the frozen plain reference, the readers of
its metrics, and the reference frozen from the port's."""

import copy
import json
import filecmp
import time

from perfbench.harness import cell as cells
from perfbench.harness import f5_serving
from perfbench.harness import main as M
from perfbench.harness.run import Run
from perfbench.costs import f5tts as costs
from perfbench.traffic import f5_batches

TINY_ARCH = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2,
                 text_dim=16, conv_layers=1, text_num_embeds=2546)


def tiny_spec(**params):
    s = cells.load("f5tts_offline_b16")
    cfg = s["config"] = copy.deepcopy(s["config"])
    cfg["model"]["arch"] = dict(TINY_ARCH)
    cfg["model"]["sampler"]["nfe_step"] = 2
    cfg["vocoder"].update(dim=16, intermediate_dim=24, num_layers=1)
    cfg["precision"]["dit"] = "float32"  # the CPU's own
    s["cell"] = copy.deepcopy(s["cell"])
    s["cell"]["params"].update(dict(batch=2, pool_batches=2, in_flight=2,
                                    phones=[8, 14], prompt_tokens=[6, 10],
                                    check_batches=1, trace_seconds=1.0),
                               **params)
    return s


def test_the_cell_runs_and_checks_on_the_cpu():
    spec = tiny_spec()
    run = Run(spec, 2**40 + 7, 1.5, True, time.perf_counter(), "cpu")
    M.execute(run, cells.driver("f5_batches"))
    assert run.checks["frames"]["value"] == 0.0
    assert run.checks["mel"]["value"] < 1e-4, run.checks
    assert run.checks["wav"]["value"] < 1e-4, run.checks
    assert run.correct and run.failed == 0
    out = M.result(run, "cpu", 1)
    per = out["metrics"]
    assert 0 < per["f5_mfu_pct"]["value"]
    assert 0 < per["decode_frame_use_pct.f5"]["value"] <= 100
    # no device operations on the CPU
    assert not {"attn_roofline.f5", "device_idle_pct.f5"} & set(per)


def test_requests_are_the_issued_sizes():
    spec = cells.load("f5tts_offline_b16")
    cfg, p = spec["config"], spec["cell"]["params"]
    assert f5_serving.reference_frames(cfg, 42) == 282
    assert f5_serving.reference_frames(cfg, 140) == 938
    lo = dict(prompt=[1] * 42, phones=[1] * 42)
    hi = dict(prompt=[1] * 140, phones=[1] * 154)
    assert f5_serving.total_frames(cfg, lo) == 564
    assert f5_serving.total_frames(cfg, hi) == 938 + int(938 / 140 * 154)
    wav = f5_serving.reference_wav(cfg, 42, 2**40 + 3)
    assert len(wav) == 281 * 256 and abs(float((wav ** 2).mean()) ** 0.5
                                         - 0.1) < 1e-3
    assert p["batch"] == 16 and p["strata"] == 8


def test_every_seed_sends_the_same_sizes_in_the_same_order():
    p = cells.load("f5tts_offline_b16")["cell"]["params"]
    a, b = (f5_batches.schedule(p, s) for s in (2**40 + 3, 7))
    assert len(a) == p["pool_batches"] and len(a[0]) == p["batch"]

    def sizes(batches):
        return [[(len(r["phones"]), len(r["prompt"])) for r in reqs]
                for reqs in batches]

    assert sizes(a) == sizes(b)
    assert a[0][0]["phones"] != b[0][0]["phones"]


def test_costs_hold_their_formulas():
    cfg = cells.load("f5tts_offline_b16")["config"]
    model = cfg["model"]
    # about 0.39 GFLOP a frame of projections and 4 T 1024 22 of attention
    per_frame = costs.dit_pass(model, 2048) / 2048
    assert 0.55e9 < per_frame < 0.6e9
    assert costs.attention(model, 16, 2048) == \
        4 * 32 * 16 * 2048 ** 2 * 64 * 22 * 32


def test_the_frozen_reference_is_the_ports():
    assert filecmp.cmp(
        cells.ROOT / "promptttspp_tpu_torch/reference/f5tts_plain.py",
        cells.PERFBENCH / "reference/f5tts/f5tts_plain.py", shallow=False)


def test_the_control_tool_reads_program_and_control(monkeypatch, capsys):
    from perfbench import f5_control

    spec = tiny_spec()
    monkeypatch.setattr(cells, "load", lambda name: spec)
    f5_control.main(["--seeds", "3,4", "--control-seeds", "4",
                     "--seconds", "0.5", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    kinds = [json.loads(line).get("kind") for line in out[:-1]]
    assert kinds == ["program", "program", "control"]
    s = json.loads(out[-1])["summary"]
    # the control's bfloat16 DiT reads far above the program's float32
    assert s["mel"]["control_min"] > 10 * s["mel"]["lower"]
