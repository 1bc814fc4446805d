"""The whole serving step's share of the chip's peak: the analytic FLOPs
of the requests completed before the traced window, at their unpadded
lengths (``costs/flops.py``: the acoustic model and the decode at the
float32 peak, the vocoder's channel mix at the bf16 peak, AA and the rest
at the float32 peak), as seconds at those peaks, over that part of the
window."""

from perfbench.costs import flops, peaks


def read(run, name):
    batches = run.values.get("batches")
    if not batches:
        return None
    t0 = run.values["t0"]
    end = min(run.cutoff(), t0 + run.values["window_s"])
    cfg = run.config
    model, voc = cfg["model"], cfg["vocoder"]
    fp32 = bf16 = 0
    for b in batches:
        if b["t_done"] > end:
            continue
        for r, n in zip(b["reqs"], b["frames"]):
            fp32 += flops.acoustic_infer(model, len(r["phones"]), n,
                                         len(r["prompt"]))
            fp32 += flops.decode(model, n)
            v = flops.vocoder(voc, n)
            fp32 += v["aa"] + v["other"]
            bf16 += v["mix"]
    if end <= t0 or fp32 == 0:
        return None
    at_peak = fp32 / peaks.FP32_FLOP_PER_S + bf16 / peaks.BF16_TC_FLOP_PER_S
    return 100.0 * at_peak / (end - t0)
