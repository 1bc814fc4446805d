"""What the readers of the program's own spans and counters share.

The port records spans and counters at its layer boundaries
(``promptttspp_tpu_torch/utils/trace.py``) while a profiler runs, so the
traced window of a ``--trace 1`` run records them with no help from the
benchmark. Both are on ``time.time_ns()``, the clock of the trace's
timestamps, so the device's idle time can be laid over the program's
spans: ``idle_ns`` is the idle time (the complement of ``Trace.merged()``
inside ``window_ns``) that lies in the union of a set of intervals.

A program without the recorder gives nothing to read (``recorded`` is
None), and neither does a window in which it recorded nothing.
"""

import sys

import numpy as np


def recorded():
    """-> (spans, counts) the program recorded, or None where it has no
    recorder. A span has ``name``, ``start_ns``, ``end_ns``; a count
    ``name``, ``t_ns``, ``n``."""
    try:
        from promptttspp_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans(), trace.counts()


def _union(intervals, lo: int, hi: int) -> np.ndarray:
    """The union of [start, end] ``intervals`` clipped to [lo, hi], as
    sorted disjoint rows."""
    a = np.clip(np.asarray([s for s, _ in intervals], np.int64), lo, hi)
    b = np.clip(np.asarray([e for _, e in intervals], np.int64), lo, hi)
    keep = b > a
    a, b = a[keep], b[keep]
    if len(a) == 0:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    run_end = np.maximum.accumulate(b)
    new = np.empty(len(a), bool)
    new[0] = True
    new[1:] = a[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return np.stack([a[idx], np.append(run_end[idx[1:] - 1], run_end[-1])],
                    axis=1)


def _busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The device's busy time before each time in ``t``, from the sorted
    disjoint busy rows."""
    if len(busy) == 0:
        return np.zeros(len(t), np.int64)
    s, e = busy[:, 0], busy[:, 1]
    before = np.concatenate([[0], np.cumsum(e - s)])
    k = np.searchsorted(s, t, side="right")  # rows starting at or before t
    last = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.minimum(e[last], t) - s[last], 0)
    return before[last] * (k > 0) + part


def idle_ns(tr, intervals) -> int:
    """Device idle time inside ``tr``'s window that lies in the union of
    ``intervals`` [(start_ns, end_ns)]."""
    lo, hi = tr.window_ns
    u = _union(intervals, lo, hi)
    if len(u) == 0:
        return 0
    busy = tr.merged()
    inside = _busy_before(busy, u[:, 1]) - _busy_before(busy, u[:, 0])
    return int(((u[:, 1] - u[:, 0]) - inside).sum())


def starting_in(spans, name: str, tr) -> int:
    """The spans called ``name`` that start inside ``tr``'s window."""
    lo, hi = tr.window_ns
    return sum(1 for s in spans if s.name == name and lo <= s.start_ns < hi)


def idle_ms_per(run, part: str, per: str):
    """The device idle time in the window under the program's ``part``
    spans, over the ``per`` spans that start in it, in ms; None where the
    run has no trace, the program no recorder or no ``per`` span."""
    tr = run.trace
    rec = recorded() if tr is not None else None
    if rec is None:
        return None
    spans = rec[0]
    n = starting_in(spans, per, tr)
    if n == 0:
        return None
    idle = idle_ns(tr, [(s.start_ns, s.end_ns) for s in spans
                        if s.name == part])
    return idle * 1e-6 / n


def outside_idle_s(tr, labels) -> float:
    """The breakdown's idle time under the benchmark's spans ``labels``
    (``Trace.idle_gaps``: each gap put down to the span the host was in
    when it began), in s."""
    total = 0.0
    for label, s in tr.idle_gaps(n=1 << 30):
        if label.rsplit(" (", 1)[0] in labels:
            total += s
    return total


def report(run, name: str, parts, per: str, outside):
    """Print, on stderr, the device idle time the program's ``parts``
    spans account for (the sum of their readings times the ``per`` spans
    in the window) beside the idle the benchmark puts under its
    ``outside`` spans: the breakdown's (each gap whole, under the span it
    began in) and the idle inside those spans, as the program's is
    counted."""
    tr = run.trace
    rec = recorded() if tr is not None else None
    if rec is None:
        return
    n = starting_in(rec[0], per, tr)
    values = [idle_ms_per(run, p, per) for p in parts]
    if n == 0 or None in values:
        return
    inside = sum(values) * n * 1e-3
    by_start = outside_idle_s(tr, outside)
    overlap = idle_ns(tr, [(a, b) for label, a, b in tr.spans
                           if label in outside]) * 1e-9
    shares = [inside / x if x > 0 else float("nan")
              for x in (by_start, overlap)]
    print(f"{name}: the program's spans hold {inside:.4f} s of device "
          f"idle time over {n} {per} spans; under {'+'.join(outside)} the "
          f"breakdown puts {by_start:.4f} s ({shares[0]:.3f} of it) and "
          f"the spans themselves hold {overlap:.4f} s ({shares[1]:.3f})",
          file=sys.stderr)
