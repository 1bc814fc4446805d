"""The profiler window of a ``--trace 1`` run and what is read from it.

The traced window is the last ``seconds`` of the measured window
(``arm``, then ``poll`` at each of the traffic driver's loop boundaries),
so the part before it runs as an untraced run does and the readers that
need no trace read that part (``Run.cutoff``). The profiler is started
once during set-up (``prepare``), so that starting it again costs little.
On the card it records the device's activity and the runtime's calls only
(CUPTI), not the host's operators: recording every operator costs
microseconds each and slows a host-bound step several fold. The
benchmark's own spans (``span``) are kept on the host with
``time.time_ns()``, the clock the profiler's timestamps are on. ``stop``
waits for the device, closes the window and keeps only what the readers
need (``Trace``): the device intervals by name, the host's launch calls
and the spans.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# host runtime calls that launch device work, by kind
LAUNCH_CALLS = {
    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"),
    "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
}


@dataclass
class Trace:
    """What a traced window leaves: ``window_s``, the device intervals
    (``starts``, ``ends`` in ns, ``names``), host launch counts by kind,
    the benchmark's spans [(name, start_ns, end_ns)], and the perf_counter
    time the window opened and closed (``t0``, ``t1``)."""

    window_s: float
    t0: float
    t1: float
    starts: np.ndarray
    ends: np.ndarray
    names: List[str]
    launches: Dict[str, int]
    spans: List[Tuple[str, int, int]]
    window_ns: Tuple[int, int] = (0, 0)

    def merged(self) -> np.ndarray:
        """The union of the device intervals inside the window, as sorted
        disjoint [start, end] rows (ns)."""
        lo, hi = self.window_ns
        s = np.clip(self.starts, lo, hi)
        e = np.clip(self.ends, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if len(s) == 0:
            return np.zeros((0, 2), np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        new = np.empty(len(s), bool)
        new[0] = True
        new[1:] = s[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        return np.stack([s[idx], np.append(run_end[idx[1:] - 1],
                                           run_end[-1])], axis=1)

    def inside(self) -> float:
        """The share of the device time recorded that lies inside the
        window (about 1: the profiler's clock and the host's agree)."""
        total = float((self.ends - self.starts).sum())
        if total <= 0:
            return 1.0
        lo, hi = self.window_ns
        clipped = np.clip(self.ends, lo, hi) - np.clip(self.starts, lo, hi)
        return float(clipped.sum()) / total

    def busy_s(self) -> float:
        m = self.merged()
        return float((m[:, 1] - m[:, 0]).sum()) * 1e-9

    def device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations with the most time, [name, s]."""
        total = defaultdict(int)
        lo, hi = self.window_ns
        for name, s, e in zip(self.names, self.starts, self.ends):
            total[name] += int(min(e, hi) - max(s, lo)) if e > lo and \
                s < hi else 0
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t * 1e-9] for name, t in top if t > 0]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time summed by what the host was doing when each
        gap began (the innermost benchmark span), the ``n`` largest, as
        ["<span> (<gaps> gaps)", s]."""
        m = self.merged()
        lo, hi = self.window_ns
        edges = np.concatenate([[lo], m.ravel(), [hi]]).reshape(-1, 2)
        gaps = [(int(a), int(b)) for a, b in edges if b > a]
        spans = sorted((s, e, name) for name, s, e in self.spans)
        starts = np.asarray([s for s, _, _ in spans], np.int64)
        total, count = defaultdict(int), Counter()
        for a, b in gaps:
            label = "outside any span"
            k = int(np.searchsorted(starts, a, side="right"))
            for s, e, name in reversed(spans[max(0, k - 64):k]):
                if s <= a < e:
                    label = name
                    break
            total[label] += b - a
            count[label] += 1
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{label} ({count[label]} gaps)", t * 1e-9]
                for label, t in top]


class Tracer:
    """``enabled``: a ``--trace 1`` run; ``seconds``: how long the traced
    window lasts."""

    def __init__(self, enabled: bool, seconds: float, device_type="cuda"):
        self.enabled = enabled
        self.seconds = seconds
        self.device_type = device_type
        self.active = False
        self.prof = None
        self.trace: Optional[Trace] = None
        self.start_at = float("inf")

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA
                                   if self.device_type == "cuda"
                                   else ProfilerActivity.CPU])

    def prepare(self):
        """Start and stop the profiler once, outside the window."""
        if self.enabled:
            with self._profile():
                pass

    def arm(self, t0: float, window_s: float):
        """Trace the last ``seconds`` of a window from ``t0`` of
        ``window_s``."""
        self.start_at = t0 + max(0.0, window_s - self.seconds)

    def poll(self):
        """Start or stop the traced window when it is due."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if self.active and now - self.t0 >= self.seconds:
            self.stop()
        elif not self.active and self.trace is None and now >= self.start_at:
            self.start()

    def start(self):
        if not self.enabled or self.trace is not None:
            return
        self.prof = self._profile()
        self.prof.__enter__()
        self.spans = []
        self.t0 = time.perf_counter()
        self.ns0 = time.time_ns()
        self.active = True

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def stop(self):
        """Wait for the device, close the window, keep its ``Trace``."""
        if not self.active:
            return
        import torch

        if self.device_type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ns1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.active = False
        self.trace = extract(self.prof, self.t0, t1, (self.ns0, ns1),
                             self.spans)
        self.prof = None


def extract(prof, t0: float, t1: float, window_ns, spans) -> Trace:
    """The readers' part of a closed profiler window: ``window_ns`` its
    bounds and ``spans`` the benchmark's spans, on ``time.time_ns()``."""
    from torch.autograd import DeviceType

    starts, ends, names = [], [], []
    launches = Counter()
    call_kind = {c: k for k, calls in LAUNCH_CALLS.items() for c in calls}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in call_kind:
            launches[call_kind[name]] += 1
        elif e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
            names.append(name)
    window_s = (window_ns[1] - window_ns[0]) * 1e-9
    return Trace(window_s=window_s, t0=t0, t1=t1,
                 starts=np.asarray(starts, np.int64),
                 ends=np.asarray(ends, np.int64), names=names,
                 launches=dict(launches), spans=list(spans),
                 window_ns=(int(window_ns[0]), int(window_ns[1])))
