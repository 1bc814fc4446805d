"""Offline synthesis: a closed loop of batches.

``params``: ``batch`` requests per batch, taken in order from a pool of
``pool_batches`` batches (``traffic/requests.py``: ``phones``,
``prompt_tokens``, ``strata``, ``schedule_seed``), cycled; at most
``in_flight`` batches dispatched (``Synthesizer.synthesize_async``) and
not yet resolved; ``check_batches`` batches compared with the reference
after the window, the one holding the longest request among them;
``trace_seconds`` traced in a ``--trace 1`` run.

The window dispatches while ``--seconds`` have not passed and ends when the
last dispatched batch is on the host. ``audio_s_per_s``: the seconds of
audio of the requests completed (their frames x upsample / sample rate)
over the window.
"""

from __future__ import annotations

import sys
import time
from collections import deque

from perfbench.harness import serving
from perfbench.traffic import requests


def run(run):
    server = serving.Server(run)
    window(run, server)
    server.close()


def window(run, server):
    """Warm ``server`` for the seed's batches, then drive the window."""
    p = run.params
    B = int(p["batch"])
    pool = requests.serving_requests(p, run.seed, B * int(p["pool_batches"]))
    batches = [pool[i:i + B] for i in range(0, len(pool), B)]
    server.warm(batches)
    run.setup_done()

    pending, done = deque(), []
    k = 0
    tracer = run.tracer
    t0 = run.window()
    while True:
        tracer.poll()
        if time.perf_counter() - t0 < run.seconds and \
                len(pending) < int(p["in_flight"]):
            reqs = batches[k % len(batches)]
            k += 1
            run.attempted += len(reqs)
            t_disp = time.perf_counter()
            try:
                with run.span("dispatch"):
                    handle = server.dispatch(reqs)
            except Exception as e:  # counted; the run goes on
                print(f"dispatch failed: {e!r}", file=sys.stderr)
                run.failed += len(reqs)
                continue
            pending.append((reqs, handle, t_disp))
            continue
        if not pending:
            break
        reqs, handle, t_disp = pending.popleft()
        try:
            with run.span("result"):
                wavs, mels = handle.result()
        except Exception as e:
            print(f"request failed: {e!r}", file=sys.stderr)
            run.failed += len(reqs)
            continue
        done.append(dict(reqs=reqs, wavs=wavs, mels=mels, t_disp=t_disp,
                         t_done=time.perf_counter(),
                         frames=[len(m) for m in mels]))
    wall = time.perf_counter() - t0
    tracer.stop()
    run.memory_peak_bytes = serving.memory_peak(run.device)
    samples = sum(len(w) for b in done for w in b["wavs"])
    run.e2e["audio_s_per_s"] = samples / server.sample_rate / wall
    run.values.update(window_s=wall, batches=done)
    c = server.counters()
    print(f"{run.name}: {len(done)} batches of {B} in {wall:.3f} s; "
          f"audio {samples / server.sample_rate:.1f} s; speculative "
          f"mispredicts {c['spec_mispredicts']} of {c['spec_requests']}",
          file=sys.stderr)


def checked(run):
    """The batches the check compares, and the program's outputs of
    them."""
    done = run.values["batches"]
    idx = serving.pick(done, int(run.params["check_batches"]), run.seed,
                       lambda b: max(len(r["phones"]) for r in b["reqs"]))
    return ([done[i]["reqs"] for i in idx],
            [dict(mels=done[i]["mels"], wavs=done[i]["wavs"]) for i in idx])


def check(run):
    batches, program = checked(run)
    for b in run.values["batches"]:  # only what the readers need stays
        del b["wavs"], b["mels"]
    serving.check(run, batches, program)
