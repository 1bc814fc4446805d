"""Offline voice cloning with F5-TTS: ``closed_batches``'s closed loop of
batches (the same ``params``, window and ``audio_s_per_s``) around the
F5-TTS server (``harness/f5_serving.py``), except that every seed sends
the schedule's sizes in the schedule's own order: the seed draws the
contents (ids, request seeds, weights, reference waveforms), not which
batches come first. A window reaches only ~14 of the pool's 64 batches,
and F5-TTS's time goes with a batch's total frames (squared, in
attention) while its audio goes with the generated ones alone, so with
the schedule rotated by the seed the window's audio per second of work
moved by ~1% from seed to seed. A request's audio is its generated
frames x hop / sample rate.

The check compares ``check_batches`` batches, the one holding the request
of most frames among them, each request with the plain reference run
alone and unpadded (``reference/f5_serve.py``).
"""

from __future__ import annotations

import sys
import time
from collections import deque

from perfbench.harness import f5_serving, serving
from perfbench.traffic import requests


def run(run):
    server = f5_serving.Server(run)
    window(run, server)
    server.close()
    report(run)


def report(run):
    """Each completed batch on stderr: the time since the one before it
    completed (about the device's time for the batch after it: each graph's
    launch holds the host until the graph's last kernels, so a batch's
    result is read once the next batch is dispatched), its seconds of
    audio, its frames and its groups' buckets."""
    cfg, prev = run.config, run.values["t0"]
    rows = []
    for b in run.values["batches"]:
        frames = sum(f5_serving.total_frames(cfg, r) for r in b["reqs"])
        audio = sum(b["frames"]) * cfg["synthesizer"]["upsample"] \
            / cfg["sample_rate"]
        buckets = [t for _, t in f5_serving.shapes(cfg, b["reqs"])]
        rows.append(f"{b['t_done'] - prev:.3f}s {audio:.1f}s-audio "
                    f"{frames}f {buckets}")
        prev = b["t_done"]
    print("batches (time since the last, audio, frames, buckets): "
          + "; ".join(rows), file=sys.stderr)


def schedule(p, seed: int):
    """The pool's batches of ``seed``, in the schedule's order."""
    B = int(p["batch"])
    n = B * int(p["pool_batches"])
    pool = requests.serving_requests(p, seed, n)
    off = requests._offset(seed, n)  # undo the seed's rotation
    pool = pool[off:] + pool[:off]
    return [pool[i:i + B] for i in range(0, n, B)]


def window(run, server):
    """``closed_batches.window`` over ``schedule``'s batches."""
    p = run.params
    B = int(p["batch"])
    batches = schedule(p, run.seed)
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
    print(f"{run.name}: {len(done)} batches of {B} in {wall:.3f} s; "
          f"audio {samples / server.sample_rate:.1f} s", file=sys.stderr)


def checked(run):
    """The batches the check compares, and the program's outputs of
    them."""
    done = run.values["batches"]
    cfg = run.config
    idx = serving.pick(done, int(run.params["check_batches"]), run.seed,
                       lambda b: max(f5_serving.total_frames(cfg, r)
                                     for r in b["reqs"]))
    return ([done[i]["reqs"] for i in idx],
            [dict(mels=done[i]["mels"], wavs=done[i]["wavs"]) for i in idx])


def check(run, dit_dtype: str = "float32"):
    """Compare with the reference (its DiT in ``dit_dtype``)."""
    from perfbench.reference import f5_serve, judge

    batches, program = checked(run)
    for b in run.values["batches"]:  # only what the readers need stays
        del b["wavs"], b["mels"]
    ref = f5_serve.outputs(run.config, run.seed, batches, run.device,
                           dit_dtype)
    run.values["checked"] = (batches, ref)  # kept for the control tool
    gaps = judge.serve_gaps(program, ref)
    for name in ("frames", "mel", "wav"):
        run.compare(name, gaps[name], run.cell["limits"][name])
    run.values["checked_requests"] = sum(len(b) for b in batches)
