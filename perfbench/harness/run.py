"""The state of one run, shared by the traffic driver, the readers and
the output: the cell, the seed and the window's length; the set-up time;
the end-to-end values the driver measured; the benchmark's spans and
values that the per-layer readers read; the trace; the requests attempted
and failed; the numbers compared with the reference, each with its limit.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

from perfbench.harness.trace import Tracer


class Run:
    def __init__(self, spec: Dict, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda"):
        self.spec = spec
        self.name = spec["name"]
        self.cell = spec["cell"]
        self.params = spec["cell"]["params"]
        self.config = spec["config"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.t_start = t_start
        self.device = device
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.values: Dict = {}
        self.attempted = 0
        self.failed = 0
        self.checks: Dict[str, Dict[str, float]] = {}
        self.memory_peak_bytes = 0
        self.tracer = Tracer(self.trace_on,
                             float(self.params.get("trace_seconds", 5.0)),
                             device_type="cuda" if device == "cuda"
                             else "cpu")

    def setup_done(self):
        """Mark the end of set-up: the first timed operation follows."""
        self.tracer.prepare()
        self.setup_s = time.perf_counter() - self.t_start

    def window(self) -> float:
        """Start the measured window: -> its start (perf_counter)."""
        t0 = time.perf_counter()
        self.values["t0"] = t0
        self.tracer.arm(t0, self.seconds)
        return t0

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block into ``spans[name]`` as (start, seconds), and
        mark it in the trace while one is open."""
        t0 = time.perf_counter()
        with self.tracer.span(name):
            yield
        self.spans[name].append((t0, time.perf_counter() - t0))

    def cutoff(self) -> float:
        """Where the untraced part of the window ends: the traced window's
        start, or never."""
        tr = self.tracer.trace
        return tr.t0 if tr is not None else float("inf")

    def untraced(self, name: str) -> List[float]:
        """The durations of ``name``'s spans that began before the traced
        window."""
        end = self.cutoff()
        return [d for t, d in self.spans.get(name, []) if t < end]

    def compare(self, name: str, value: float, limit: float):
        """A number compared with the reference and its limit."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())

    @property
    def trace(self):
        return self.tracer.trace
