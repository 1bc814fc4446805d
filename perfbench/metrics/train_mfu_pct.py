"""The training step's share of the float32 peak: the analytic FLOPs of
forward and backward of every update dispatched before the traced window,
at its rows' unpadded lengths (``costs/flops.py::train_step``), over that
part of the window."""

from perfbench.costs import flops, peaks


def read(run, name):
    updates = run.values.get("updates")
    if not updates:
        return None
    t0 = run.values["t0"]
    end = min(run.cutoff(), t0 + run.values["window_s"])
    model = run.config["model"]
    total = sum(flops.train_step(model, int(tp), int(tf), int(L))
                for t, plens, flens, Ls in updates if t < end
                for tp, tf, L in zip(plens, flens, Ls))
    if end <= t0 or total == 0:
        return None
    return 100.0 * total / peaks.FP32_FLOP_PER_S / (end - t0)
