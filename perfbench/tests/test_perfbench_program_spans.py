"""The readers of the program's own spans and counters
(``metrics/program_spans.py``, ``request_idle_ms``, ``train_idle_ms``,
``decode_frame_use_pct``) on a synthetic trace with synthetic spans and
counters: the idle time under a span's union, nesting, the window's
edges, and a program without the recorder."""

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.harness import cell as cells
from perfbench.harness.trace import Trace
from perfbench.metrics import program_spans

MS = 1_000_000


def span(name, a, b):
    return SimpleNamespace(name=name, start_ns=int(a * MS),
                           end_ns=int(b * MS))


def count(name, t, n):
    return SimpleNamespace(name=name, t_ns=int(t * MS), n=n)


def device_trace(spans=()):
    # window 0..100 ms; busy 10-40 (two kernels) and 50-60 ms; idle 0-10,
    # 40-50 and 60-100 ms
    return Trace(window_s=0.1, t0=10.0, t1=10.1,
                 starts=np.array([10, 20, 50]) * MS,
                 ends=np.array([30, 40, 60]) * MS, names=["a", "b", "c"],
                 launches={}, spans=list(spans), window_ns=(0, 100 * MS))


def fake_run(trace, **values):
    spec = cells.load("serve_offline_b16")
    return SimpleNamespace(trace=trace, values=values,
                           config=spec["config"])


@pytest.fixture
def program(monkeypatch):
    """Set what the program recorded: program(spans, counts)."""
    def put(spans=(), counts=()):
        monkeypatch.setattr(program_spans, "recorded",
                            lambda: (list(spans), list(counts)))
    return put


def test_idle_under_a_union_of_spans():
    tr = device_trace()
    assert program_spans.idle_ns(tr, []) == 0
    assert program_spans.idle_ns(tr, [(0, 100 * MS)]) == 60 * MS
    # overlapping and nested intervals count once
    assert program_spans.idle_ns(tr, [(0, 5 * MS), (2 * MS, 8 * MS),
                                      (3 * MS, 4 * MS)]) == 8 * MS
    # partly busy: 35-55 holds 40-50
    assert program_spans.idle_ns(tr, [(35 * MS, 55 * MS)]) == 10 * MS
    # wholly busy
    assert program_spans.idle_ns(tr, [(12 * MS, 38 * MS)]) == 0
    # clipped to the window at both edges
    assert program_spans.idle_ns(tr, [(-50 * MS, 5 * MS),
                                      (90 * MS, 150 * MS)]) == 15 * MS


def test_idle_without_device_work():
    tr = Trace(window_s=0.1, t0=0.0, t1=0.1, starts=np.zeros(0, np.int64),
               ends=np.zeros(0, np.int64), names=[], launches={}, spans=[],
               window_ns=(0, 100 * MS))
    assert program_spans.idle_ns(tr, [(10 * MS, 30 * MS)]) == 20 * MS


REQUESTS = [
    # a request begun before the window: its spans count, it does not
    span("synth.request", -20, -2), span("synth.readback", -1, 3),
    # two requests that start in the window
    span("synth.request", 0, 45), span("synth.inputs", 0, 5),
    span("synth.acoustic", 5, 45),
    span("synth.request", 55, 70), span("synth.decode", 55, 58),
    span("synth.vocoder", 58, 62), span("synth.vocoder", 62, 70),
    span("synth.readback", 70, 95),
    # one that starts as the window closes
    span("synth.request", 100, 120), span("synth.inputs", 100, 110),
]


@pytest.mark.parametrize("part,ms", [
    ("inputs", 5 / 2), ("acoustic", 10 / 2), ("decode", 0.0),
    ("vocoder", 10 / 2), ("readback", (3 + 25) / 2)])
def test_request_idle_ms(program, part, ms):
    program(REQUESTS)
    name = f"request_idle_ms.{part}"
    got = cells.reader(name)(fake_run(device_trace()), name)
    assert got == pytest.approx(ms)


def test_request_idle_totals_are_printed(program, capsys):
    dispatch = [("dispatch", 0, 45 * MS), ("result", 55 * MS, 96 * MS)]
    program(REQUESTS)
    run = fake_run(device_trace(dispatch))
    cells.reader("request_idle_ms")(run, "request_idle_ms.inputs")
    err = capsys.readouterr().err
    # the parts hold 3 + 5 + 10 + 0 + 10 + 25 ms; the breakdown puts the
    # gaps beginning at 0 and 40 ms under dispatch, at 60 ms under result
    assert "hold 0.0530 s" in err and "over 2 synth.request" in err
    # by overlap: 0-10 and 40-45 in dispatch, 60-96 in result
    assert "breakdown puts 0.0600 s (0.883 of it)" in err
    assert "themselves hold 0.0510 s (1.039)" in err


def test_train_idle_ms(program, capsys):
    program([span("train.step", 0, 60), span("train.forward", 0, 12),
             span("train.backward", 12, 45), span("train.optimizer", 45, 60),
             span("train.step", 60, 100), span("train.forward", 60, 100)])
    run = fake_run(device_trace([("train_step", 0, 100 * MS)]))
    read = cells.reader("train_idle_ms")
    assert read(run, "train_idle_ms.forward") == pytest.approx(
        (10 + 40) / 2)
    assert read(run, "train_idle_ms.backward") == pytest.approx(5 / 2)
    assert read(run, "train_idle_ms.optimizer") == pytest.approx(5 / 2)
    err = capsys.readouterr().err
    assert "(1.000 of it)" in err and "(1.000)" in err


def test_decode_frame_use_pct(program, capsys):
    program(counts=[count("synth.frames_decoded", -1, 999),
                    count("synth.frames_useful", -1, 1),
                    count("synth.frames_decoded", 20, 1024),
                    count("synth.frames_useful", 20, 650),
                    count("synth.frames_decoded", 80, 256),
                    count("synth.frames_useful", 80, 250),
                    count("synth.frames_decoded", 100, 7)])
    reqs = [dict(phones=[1] * 100, prompt=[1] * 9)]  # 1,000 -> 1,024
    run = fake_run(device_trace(), batches=[
        dict(reqs=reqs, frames=[650], t_done=10.02),
        dict(reqs=reqs, frames=[1000], t_done=10.5)])
    read = cells.reader("decode_frame_use_pct")
    assert read(run, "decode_frame_use_pct.offline") == pytest.approx(
        100 * 900 / 1280)
    err = capsys.readouterr().err
    assert "(900 of 1280 frames)" in err and "(650 of 1024)" in err


def test_nothing_to_read(program):
    run = fake_run(device_trace())
    names = ["request_idle_ms.decode", "train_idle_ms.backward",
             "decode_frame_use_pct.online"]
    program()  # a recorder that recorded nothing
    for name in names:
        assert cells.reader(name)(run, name) is None
    program([span("synth.decode", 10, 20)])  # no request in the window
    assert cells.reader(names[0])(run, names[0]) is None
    for name in names:  # no trace
        assert cells.reader(name)(fake_run(None), name) is None


def test_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    run = fake_run(device_trace())
    for name in ("request_idle_ms.inputs", "train_idle_ms.forward",
                 "decode_frame_use_pct.offline"):
        assert cells.reader(name)(run, name) is None


def test_recorded_reads_the_port():
    from promptttspp_tpu_torch.utils import trace

    trace.clear()
    try:
        with trace.recording():
            with trace.span("synth.request", 0):
                trace.count("synth.frames_useful", 3)
        spans, counts = program_spans.recorded()
    finally:
        trace.clear()
    assert [s.name for s in spans] == ["synth.request"]
    assert [(c.name, c.n) for c in counts] == [("synth.frames_useful", 3)]
