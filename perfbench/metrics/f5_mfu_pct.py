"""The F5-TTS serving step's share of the chip's peak: the analytic FLOPs
of the requests completed before the traced window, at their unpadded
lengths (``costs/f5tts.py``: the DiT's passes at the dense fp16 peak of the
tensor cores, Vocos at the float32 peak), as seconds at those peaks, over
that part of the window."""

from perfbench.costs import f5tts, peaks
from perfbench.harness.f5_serving import total_frames


def read(run, name):
    batches = run.values.get("batches")
    cfg = run.config
    if not batches or "arch" not in cfg.get("model", {}):
        return None
    t0 = run.values["t0"]
    end = min(run.cutoff(), t0 + run.values["window_s"])
    tc = fp32 = 0
    for b in batches:
        if b["t_done"] > end:
            continue
        for r, g in zip(b["reqs"], b["frames"]):
            tc += f5tts.dit(cfg["model"], total_frames(cfg, r))
            fp32 += f5tts.vocos(cfg["vocoder"], g)
    if end <= t0 or tc == 0:
        return None
    at_peak = tc / peaks.BF16_TC_FLOP_PER_S + fp32 / peaks.FP32_FLOP_PER_S
    return 100.0 * at_peak / (end - t0)
