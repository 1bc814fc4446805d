"""The share of the frames the decode ran that were useful: 100 x the
sum of the program's ``synth.frames_useful`` counters (each resolved
request's frame lengths) over the sum of its ``synth.frames_decoded``
counters (the batch times the frame bucket of every pass the request
ran, a mispredict's two), over the counter events in the traced window
(``promptttspp_tpu_torch/utils/trace.py``).

Where the run kept its batches (the offline cell), the same share
computed from outside, the unpadded frames over the batch times the frame
bucket ``harness/serving.py::shape_key`` predicts, over the batches that
completed in the traced window, is printed on stderr beside it.
"""

import sys

from perfbench.harness.serving import shape_key
from perfbench.metrics import program_spans


def _outside(run):
    tr = run.trace
    useful = decoded = 0
    for b in run.values.get("batches") or []:
        if tr.t0 <= b["t_done"] <= tr.t1:
            useful += sum(b["frames"])
            decoded += len(b["reqs"]) * shape_key(run.config, b["reqs"])[2]
    return (useful, decoded) if decoded else None


def read(run, name):
    tr = run.trace
    rec = program_spans.recorded() if tr is not None else None
    if rec is None:
        return None
    lo, hi = tr.window_ns
    total = {"synth.frames_useful": 0, "synth.frames_decoded": 0}
    for c in rec[1]:
        if c.name in total and lo <= c.t_ns < hi:
            total[c.name] += c.n
    useful, decoded = total["synth.frames_useful"], \
        total["synth.frames_decoded"]
    if decoded == 0:
        return None
    value = 100.0 * useful / decoded
    outside = _outside(run)
    if outside is not None:
        print(f"{name}: {value:.3f}% from the program's counters ({useful} "
              f"of {decoded} frames); {100.0 * outside[0] / outside[1]:.3f}"
              f"% from outside ({outside[0]} of {outside[1]})",
              file=sys.stderr)
    return value
