"""The port's span and counter recorder (``utils/trace.py``) and the spans
of the Synthesizer and the training step, on the CPU: off by default and
free there, on under ``torch.profiler`` and ``recording()``, parents,
threads and ids, the clock shared with the profiler, and the serving and
training spans of a tiny model."""

import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.train.state import TrainState
from promptttspp_tpu_torch.utils import trace
from tests.test_torch_cuda import (OPT, PROMPTS, SEQS, ZERO_BERT, _tiny_synth,
                                   torch_batch, train_batch,
                                   zero_dropout_config)

SERVING = ("synth.request", "synth.inputs", "synth.acoustic",
           "synth.decode", "synth.vocoder", "synth.readback")


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.clear()
    yield
    trace.clear()


def _traced_bytes(work):
    """(retained, peak) bytes that ``work()`` allocates, its second run."""
    work()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        work()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - before, peak - before


def test_off_records_nothing_and_allocates_nothing():
    assert not trace.active()
    assert trace.span("a", 1) is trace.span("b")  # one shared no-op
    ids = list(range(10000))  # made before the count starts

    def loop():
        for i in ids:
            pass

    def calls():
        for i in ids:
            trace.span("synth.decode", i)
            trace.count("synth.frames_decoded", i)

    def blocks():
        for i in ids:
            with trace.span("synth.decode", i):
                trace.count("synth.frames_decoded", i)

    # ``span`` and ``count`` allocate nothing beyond the bare loop; a
    # ``with`` block holds the interpreter's bound ``__exit__`` while it
    # runs and keeps nothing after
    assert _traced_bytes(calls) == _traced_bytes(loop)
    assert _traced_bytes(blocks)[0] == 0
    assert trace.spans() == [] and trace.counts() == []


def test_off_costs_under_200_ns_a_span():
    n = 200_000
    span = trace.span
    t0 = time.perf_counter()
    for i in range(n):
        with span("synth.decode", i):
            pass
    per = (time.perf_counter() - t0) / n
    # loose for a loaded machine; about 60 ns alone
    assert per < 1e-6, per


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_on_inside_a_profiler_or_recording_and_off_after(how):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if how == "profiler"
           else trace.recording())
    with ctx:
        assert trace.active()
        with trace.span("outer", 7):
            trace.count("c", 3)
    assert not trace.active()
    with trace.span("late"):
        trace.count("c", 5)
    (s,), (c,) = trace.spans(), trace.counts()
    assert (s.name, s.id, s.parent) == ("outer", 7, None)
    assert s.start_ns <= c.t_ns <= s.end_ns
    assert (c.name, c.n) == ("c", 3)


def test_recording_nests():
    with trace.recording():
        with trace.recording():
            pass
        assert trace.active()
    assert not trace.active()


def test_parents_threads_and_ids():
    got = {}

    def worker():
        with trace.span("w.outer", "b"):
            with trace.span("w.inner", "b"):
                pass
        got["thread"] = threading.get_ident()

    with trace.recording():
        with trace.span("m.outer", "a"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with trace.span("m.inner", "a"):
                pass
    by = {s.name: s for s in trace.spans()}
    me = threading.get_ident()
    assert by["m.inner"].parent == by["m.outer"].serial
    assert by["m.outer"].parent is None
    # a span's parent is the open span of its own thread only
    assert by["w.outer"].parent is None
    assert by["w.inner"].parent == by["w.outer"].serial
    assert {by["m.outer"].thread, by["m.inner"].thread} == {me}
    assert {by["w.outer"].thread, by["w.inner"].thread} == {got["thread"]}
    assert (by["m.inner"].id, by["w.inner"].id) == ("a", "b")
    assert len({s.serial for s in by.values()}) == 4
    for s in by.values():
        assert s.start_ns <= s.end_ns
    # the newest are kept, up to the cap
    assert trace._spans.maxlen == trace._counts.maxlen == trace.CAPACITY


def test_profiled_op_lies_inside_its_span():
    """The spans and the profiler's timestamps are on one clock."""
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mul"):
            a.mul(a)
    (s,) = trace.spans()
    muls = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::mul"]
    assert muls
    for e in muls:
        assert s.start_ns <= e.start_ns() <= s.end_ns


@pytest.fixture(scope="module")
def tiny():
    return _tiny_synth("cpu", speculative=True, spec_frames_per_phone=4.0)


def _by_id(spans):
    ids = {s.id for s in spans}
    assert len(ids) == 1, ids
    return sorted(spans, key=lambda s: s.start_ns)


@pytest.mark.parametrize("call", ["async", "synthesize", "two_phase",
                                  "streaming"])
def test_serving_spans_of_one_request(tiny, call):
    """Every span of a call carries its id, the request's layers nest in
    ``synth.request`` in their order, the readback follows, and the frame
    counters are the bucket's and the true lengths."""
    tiny.speculative = call != "two_phase"
    try:
        with trace.recording():
            if call == "async":
                handle = tiny.synthesize_async(SEQS, PROMPTS, seed=3)
                assert {s.name for s in trace.spans()} >= set(SERVING[:-1])
                assert "synth.readback" not in {s.name for s in
                                                trace.spans()}
                frames = len(handle.result()[0][0]) // 240
            elif call == "streaming":
                gen = tiny.synthesize_streaming(SEQS, PROMPTS, seed=3)
                while True:
                    try:
                        next(gen)
                    except StopIteration as stop:
                        frames = int(stop.value[0])
                        break
            else:
                frames = len(tiny.synthesize(SEQS, PROMPTS,
                                             seed=3)[0][0]) // 240
    finally:
        tiny.speculative = True
    spans = _by_id(trace.spans())
    names = [s.name for s in spans]
    request = spans[0]
    assert request.name == "synth.request" and request.parent is None
    inside = [s for s in spans if s.parent == request.serial]
    order = [s.name for s in inside]
    acoustic = (["synth.acoustic"] * 2 if call == "two_phase"
                else ["synth.acoustic"])
    tail = ["synth.vocoder"] if call == "streaming" else ["synth.vocoder"] * 2
    assert order == ["synth.inputs", *acoustic, "synth.decode", *tail]
    after = [s for s in spans if s.start_ns >= request.end_ns]
    assert after and all(s.parent is None for s in after)
    assert after[0].name == "synth.readback" and set(names) == set(SERVING)
    for s in inside:
        assert request.start_ns <= s.start_ns <= s.end_ns <= request.end_ns
    counts = {c.name: c.n for c in trace.counts()}
    assert counts == {"synth.frames_decoded": 128,
                      "synth.frames_useful": frames}


def test_each_call_gets_its_own_id(tiny):
    with trace.recording():
        handles = [tiny.synthesize_async(SEQS, PROMPTS, seed=s)
                   for s in (1, 2)]
        for h in handles:
            h.result()
    ids = {}
    for s in trace.spans():
        ids.setdefault(s.id, set()).add(s.name)
    assert len(ids) == 2
    for names in ids.values():
        assert names == set(SERVING)


def test_mispredict_counts_both_passes():
    """A too-small bucket decodes twice: 16 frames, then the true 32."""
    synth = _tiny_synth("cpu", speculative=True, frame_quantum=16,
                        spec_frames_per_phone=0.01)
    with trace.recording():
        wavs, _ = synth.synthesize(SEQS, PROMPTS, seed=3)
    assert synth.spec_mispredicts == 1
    frames = len(wavs[0]) // 240
    assert 16 < frames <= 32
    counts = {c.name: c.n for c in trace.counts()}
    assert counts == {"synth.frames_decoded": 16 + 32,
                      "synth.frames_useful": frames}
    spans = _by_id(trace.spans())
    assert [s.name for s in spans].count("synth.decode") == 2
    assert [s.name for s in spans].count("synth.readback") == 3
    # the second pass runs at resolve, outside the request's span
    request = spans[0]
    second = [s for s in spans if s.name == "synth.decode"][1]
    assert second.parent is None and second.start_ns >= request.end_ns


@pytest.mark.parametrize("bf16", [False, True])
def test_train_step_spans(bf16):
    model = flagship.build_model(zero_dropout_config(), "cpu", 0, ZERO_BERT)
    state = TrainState(model, seed=0, bf16=bf16, **OPT)
    batch = torch_batch(train_batch())
    state.train_step(batch)
    assert trace.spans() == []
    with trace.recording():
        state.train_step(batch)
    spans = sorted(trace.spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == ["train.step", "train.forward",
                                       "train.backward", "train.optimizer"]
    step = spans[0]
    assert {s.id for s in spans} == {1} and step.parent is None
    for s in spans[1:]:
        assert s.parent == step.serial
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
