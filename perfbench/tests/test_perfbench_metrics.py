"""The per-layer readers on a synthetic trace and on synthetic run state,
and the trace extraction on a real (CPU) profiler window."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.costs.kernels import (vocoder_k2_bf16_bound_s,
                                     vocoder_k2_launches)
from perfbench.harness import cell as cells
from perfbench.harness.trace import Trace, Tracer

MS = 1_000_000


def synthetic_trace():
    # window 0..100 ms; kernels 10-30, 20-40 (overlap), 50-60 ms; host spans
    names = ["aa_conv_wgmma_kernel<G>", "gemm", "aa_conv_wgmma_kernel<G>"]
    return Trace(window_s=0.1, t0=10.0, t1=10.1,
                 starts=np.array([10, 20, 50]) * MS,
                 ends=np.array([30, 40, 60]) * MS, names=names,
                 launches={"kernel": 30, "graph": 2},
                 spans=[("dispatch", 0, 10 * MS),
                        ("result", 40 * MS, 95 * MS)],
                 window_ns=(0, 100 * MS))


def fake_run(**values):
    spec = cells.load("serve_offline_b16")
    return SimpleNamespace(trace=synthetic_trace(), values=values,
                           spans={}, config=spec["config"])


def test_busy_and_idle():
    tr = synthetic_trace()
    assert tr.busy_s() == pytest.approx(0.040)
    read = cells.reader("device_idle_pct.offline")
    assert read(fake_run(), "device_idle_pct.offline") == pytest.approx(60.0)


def test_breakdown():
    tr = synthetic_trace()
    ops = dict((n, s) for n, s in tr.device_ops())
    assert ops["aa_conv_wgmma_kernel<G>"] == pytest.approx(0.030)
    assert ops["gemm"] == pytest.approx(0.020)
    gaps = dict(tr.idle_gaps())
    # 0-10 in dispatch; 40-50 and 60-100 in result
    assert gaps["dispatch (1 gaps)"] == pytest.approx(0.010)
    assert gaps["result (2 gaps)"] == pytest.approx(0.050)


def k2_trace(tail: int, whole: int, per: int):
    """``tail`` K2 launches of a batch in flight when the trace opens, then
    ``whole`` batches of ``per``; each launch 1 ms."""
    n = tail + whole * per
    starts = np.arange(n) * 2 * MS + MS
    return Trace(window_s=1.0, t0=10.0, t1=11.0, starts=starts,
                 ends=starts + MS, names=["aa_conv_wgmma_kernel<G>"] * n,
                 launches={}, spans=[], window_ns=(0, 1000 * MS))


@pytest.mark.parametrize("tail", [0, 10])
def test_k2_roofline(tail):
    # a batch in flight when the trace opens counts neither its launches
    # in the trace nor its bound; one dispatched after it closed, neither
    reqs = [dict(phones=[1] * 60, prompt=[101, 5, 102])] * 2
    run = fake_run(batches=[dict(reqs=reqs, t_disp=9.5),
                            dict(reqs=reqs, t_disp=10.2),
                            dict(reqs=reqs, t_disp=10.6),
                            dict(reqs=reqs, t_disp=11.5)])
    per = vocoder_k2_launches(run.config["vocoder"])
    assert per == 72
    run.trace = k2_trace(tail, 2, per)
    got = cells.reader("k2_bf16_roofline")(run, "k2_bf16_roofline")
    bound = vocoder_k2_bf16_bound_s(run.config["vocoder"], 2, 640)
    assert got == pytest.approx(100 * 2 * bound / (2 * per * 1e-3))


def test_k2_roofline_silent_without_a_whole_batch():
    reqs = [dict(phones=[1] * 60, prompt=[101, 5, 102])] * 2
    run = fake_run(batches=[dict(reqs=reqs, t_disp=10.05)])
    assert cells.reader("k2_bf16_roofline")(run, "k2_bf16_roofline") is None


def test_launches_per_request():
    recs = [dict(disp=10.01), dict(disp=10.05), dict(disp=12.0),
            dict(disp=None)]
    run = fake_run(requests=recs)
    read = cells.reader("launches_per_request.online")
    assert read(run, "launches_per_request.online") == pytest.approx(16.0)


def _run(spec=None, trace=None, **values):
    from perfbench.harness.run import Run

    spec = spec or cells.load("serve_offline_b16")
    run = Run(spec, 1, 10.0, False, 0.0, device="cpu")
    run.tracer.trace = trace
    run.values.update(values)
    return run


def test_span_and_value_readers():
    # the traced window starts at 10.0: what began after it is not read
    run = _run(trace=synthetic_trace(), window_peak_bytes=3 * 2**30,
               queue_wait_ms=[(1.0, 1.0), (2.0, 5.0), (3.0, 3.0),
                              (11.0, 99.0)])
    run.spans["dispatch"] = [(1.0, 0.01), (2.0, 0.03), (10.5, 9.0)]
    run.spans["next_batch"] = [(1.0, 0.002)]
    assert cells.reader("host_dispatch_ms.offline")(run, "") == \
        pytest.approx(20.0)
    assert cells.reader("input_wait_ms.train")(run, "") == pytest.approx(2.0)
    assert cells.reader("queue_wait_p50_ms.online")(run, "") == 3.0
    assert cells.reader("peak_mem_gib.train")(run, "") == 3.0


def test_readers_find_nothing_to_read():
    empty = _run()
    for m in cells.benchmark()["per_layer"]:
        assert cells.reader(m["name"])(empty, m["name"]) is None


def test_mfu_readers_count_unpadded_work_before_the_trace():
    spec = cells.load("train_b10k")
    run = _run(spec, trace=synthetic_trace(), t0=9.0, window_s=5.0,
               updates=[(9.5, np.array([10]), np.array([80]),
                         np.array([12])),
                        (10.5, np.array([99]), np.array([999]),
                         np.array([40]))])
    from perfbench.costs import flops, peaks

    want = 100 * flops.train_step(spec["config"]["model"], 10, 80, 12) \
        / peaks.FP32_FLOP_PER_S
    assert cells.reader("train_mfu_pct")(run, "") == pytest.approx(want)


def test_tracer_on_a_cpu_profile():
    import torch

    tr = Tracer(True, 0.01, device_type="cpu")
    tr.prepare()
    tr.arm(time.perf_counter(), 0.01)
    tr.poll()
    assert tr.active
    with tr.span("work"):
        a = torch.randn(64, 64)
        (a @ a).sum()
    time.sleep(0.02)
    tr.poll()
    assert not tr.active
    t = tr.trace
    assert t.window_s > 0.005
    assert any(name == "work" for name, _, _ in t.spans)
    assert len(t.starts) == 0 and t.busy_s() == 0.0
