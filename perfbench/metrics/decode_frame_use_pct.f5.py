"""The share of the frames F5-TTS's decode ran that were useful: 100 x
the sum of the program's ``synth.frames_useful`` counters (each request's
frames, the reference's and the generated ones) over the sum of its
``synth.frames_decoded`` counters (the batch times the frame bucket), over
the counter events in the traced window. ``decode_frame_use_pct.py``
also prints the flagship's share from outside, by its phone-count
prediction, which does not apply here."""

from perfbench.metrics import program_spans


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
    if total["synth.frames_decoded"] == 0:
        return None
    return 100.0 * total["synth.frames_useful"] \
        / total["synth.frames_decoded"]
