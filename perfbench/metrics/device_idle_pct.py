"""Device idle share of the traced window: 100 x (1 - the union of the
intervals in which a device operation ran / the window), from the
``torch.profiler`` trace (``harness/trace.py``)."""


def read(run, name):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or len(tr.starts) == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
