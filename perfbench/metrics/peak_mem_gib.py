"""The device memory the window's updates held at their peak:
``max_memory_allocated`` after ``reset_peak_memory_stats`` at the
window's start, in GiB."""


def read(run, name):
    peak = run.values.get("window_peak_bytes")
    return peak / 2**30 if peak else None
