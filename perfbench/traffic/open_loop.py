"""Interactive synthesis: an open loop of single requests.

``params``: ``rate_per_s`` x ``--seconds`` batch-1 requests arriving as a
Poisson process at that rate (``traffic/requests.py``: ``poisson_gaps``;
``phones``, ``prompt_tokens``, ``strata``, ``schedule_seed``), the first
at the window's start, each dispatched (``Synthesizer.synthesize_async``)
as soon as it is due and the host is free, in FIFO order; a request is resolved once the
device has finished it (a CUDA event queried between arrivals), so the
host keeps dispatching while earlier requests run. ``check_requests``
requests compared with the reference after the window, the longest among
them; ``trace_seconds`` traced in a ``--trace 1`` run.

Requests due within ``--seconds`` are sent; the window ends when the last
of them is on the host. A request's latency runs from the moment it was
due to the moment its wav is on the host; its queue wait from the moment
it was due to its dispatch. ``request_p95_ms``: the 95th percentile of
the latencies of every request due in the window, a failed request
counting as ``FAILED_MS``.
"""

from __future__ import annotations

import sys
import time
from collections import deque

import numpy as np

from perfbench.harness import serving
from perfbench.traffic import requests

FAILED_MS = 1e9
POLL_S = 0.0005


def _done_event(device: str):
    if device != "cuda":
        return None
    import torch

    ev = torch.cuda.Event()
    ev.record()
    return ev


def serve(run, server, reqs, gaps, seconds: float):
    """Drive ``reqs`` at the arrival ``gaps`` for ``seconds``; -> a list of
    per-request records (due, dispatched, done, outputs) of the requests
    due in the window."""
    tracer = run.tracer
    t0 = run.window()
    due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    n = int(np.searchsorted(due, t0 + seconds))
    recs = [dict(req=reqs[i], due=float(due[i]), disp=None, done=None,
                 wavs=None, mels=None) for i in range(n)]
    pending = deque()
    i = 0
    while i < n or pending:
        tracer.poll()
        now = time.perf_counter()
        while i < n and due[i] <= now:
            rec = recs[i]
            i += 1
            run.attempted += 1
            rec["disp"] = time.perf_counter()
            try:
                with run.span("dispatch"):
                    handle = server.dispatch([rec["req"]])
                    event = _done_event(run.device)
            except Exception as e:
                print(f"dispatch failed: {e!r}", file=sys.stderr)
                run.failed += 1
                continue
            pending.append((rec, handle, event))
            now = time.perf_counter()
        if pending and (pending[0][2] is None or pending[0][2].query()):
            rec, handle, _ = pending.popleft()
            try:
                with run.span("result"):
                    rec["wavs"], rec["mels"] = handle.result()
                rec["done"] = time.perf_counter()
            except Exception as e:
                print(f"request failed: {e!r}", file=sys.stderr)
                run.failed += 1
            continue
        wait = (due[i] - time.perf_counter()) if i < n else POLL_S
        if pending:
            wait = min(wait, POLL_S)
        if wait > 0:
            with run.span("idle"):
                time.sleep(wait)
    wall = time.perf_counter() - t0
    tracer.stop()
    return recs, wall


def latencies_ms(recs):
    return np.asarray([(r["done"] - r["due"]) * 1e3 if r["done"] is not None
                       else FAILED_MS for r in recs])


def run(run):
    server = serving.Server(run)
    window(run, server)
    server.close()


def window(run, server):
    """Warm ``server`` for the seed's requests, then drive the window."""
    p = run.params
    rate = float(p["rate_per_s"])
    n = max(1, int(round(rate * run.seconds)))
    reqs = requests.serving_requests(p, run.seed, n)
    gaps = requests.poisson_gaps(p, rate, n, run.seed, run.seconds)
    server.warm([[r] for r in reqs])
    run.setup_done()
    recs, wall = serve(run, server, reqs, gaps, run.seconds)
    run.memory_peak_bytes = serving.memory_peak(run.device)
    lat = latencies_ms(recs)
    run.e2e["request_p95_ms"] = float(np.percentile(lat, 95)) if len(lat) \
        else FAILED_MS
    run.values.update(window_s=wall, requests=recs,
                      queue_wait_ms=[(r["due"], (r["disp"] - r["due"]) * 1e3)
                                     for r in recs if r["disp"] is not None])
    c = server.counters()
    print(f"{run.name}: {len(recs)} requests due at {rate}/s in "
          f"{run.seconds} s, window {wall:.3f} s; latency p50 "
          f"{np.percentile(lat, 50) if len(lat) else FAILED_MS:.1f} ms, "
          f"p95 {run.e2e['request_p95_ms']:.1f} ms; speculative mispredicts "
          f"{c['spec_mispredicts']} of {c['spec_requests']}",
          file=sys.stderr)


def checked(run):
    """The requests the check compares (each a batch of one), and the
    program's outputs of them."""
    recs = [r for r in run.values["requests"] if r["done"] is not None]
    idx = serving.pick(recs, int(run.params["check_requests"]), run.seed,
                       lambda r: len(r["req"]["phones"]))
    return ([[recs[i]["req"]] for i in idx],
            [dict(mels=recs[i]["mels"], wavs=recs[i]["wavs"]) for i in idx])


def check(run):
    batches, program = checked(run)
    for r in run.values["requests"]:  # only what the readers need stays
        del r["wavs"], r["mels"]
    serving.check(run, batches, program)
