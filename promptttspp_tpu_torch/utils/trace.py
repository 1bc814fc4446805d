"""Spans and counters at the program's layer boundaries, on the clock of
``torch.profiler``'s timestamps.

A span is one timed block of host code (``with span("synth.decode",
request_id):``): its name, start and end in ``time.time_ns()`` (the clock
the profiler's host and device timestamps are on, so a span can be laid
over a trace of the device), the span open around it on the same thread
when it started (``parent``), the thread, and one shared identifier: a
serving request's id or a training step. A counter (``count(name, n)``)
records its name, its time in ``time.time_ns()`` and ``n``, so a reader
can sum it over any window, as it does spans.

Recording is off by default. It is on while a ``torch.profiler`` session
records in the process (``torch.autograd.profiler._is_profiler_enabled``,
which the profiler sets and clears) and inside ``recording()``. Off,
``span`` and ``count`` read two module flags and return: no clock read and
no allocation. On, spans and counters stay in memory, the newest
``CAPACITY`` of each. A span never touches the device: no event, no
synchronisation, nothing inside a graph capture.

Names in use: ``synth.request``, ``synth.inputs``, ``synth.acoustic``,
``synth.decode`` (``decode_graph.capture`` inside it where a graph is
captured), ``synth.vocoder``, ``synth.readback`` and the counters
``synth.frames_decoded`` and ``synth.frames_useful`` (``infer.py``,
``models/decode_graph.py``); the counters ``decode.blocks_run`` and
``decode.blocks_fused``, each decode graph replay's DiffNet residual blocks
and those of them on the fused block path (``models/decode_graph.py``);
``train.step`` around ``train.forward``, ``train.backward`` and
``train.optimizer`` (``train/state.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1_000_000  # spans and counters kept, each; the oldest go first


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    serial: int  # this span's number, unique in the process
    parent: Optional[int]  # the serial of the span around it, or None
    thread: int
    id: object  # the request id or training step it belongs to


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


_forced = 0  # open ``recording()`` blocks
_lock = threading.Lock()
_spans: deque = deque(maxlen=CAPACITY)
_counts: deque = deque(maxlen=CAPACITY)
_serials = itertools.count()
_local = threading.local()


class _Off:
    """The shared context of a span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "start", "serial", "parent", "stack")

    def __init__(self, name, id):
        self.name = name
        self.id = id

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.serial = next(_serials)
        stack.append(self.serial)
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        with _lock:
            _spans.append(Span(self.name, self.start, end, self.serial,
                               self.parent, threading.get_ident(), self.id))
        return False


def active() -> bool:
    """Whether spans and counters are being recorded now."""
    return bool(_forced or _profiler._is_profiler_enabled)


def span(name: str, id=None):
    """A context manager that records the block as the span ``name`` of
    ``id`` (a request id or a training step) while recording is on."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _On(name, id)


def count(name: str, n: int):
    """Record ``n`` under the counter ``name`` while recording is on."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counts.append(Count(name, time.time_ns(), int(n)))


def spans() -> List[Span]:
    """The spans recorded and kept, in the order they ended."""
    with _lock:
        return list(_spans)


def counts() -> List[Count]:
    """The counter increments recorded and kept, in time order."""
    with _lock:
        return list(_counts)


def clear():
    """Drop every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counts.clear()


@contextlib.contextmanager
def recording():
    """Record inside the block whether or not a profiler runs."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
