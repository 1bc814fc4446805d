"""The training step's wait for its batch: the mean of the benchmark's
span around each ``next()`` on the prefetching loader before the traced
window, in ms per update."""

import numpy as np


def read(run, name):
    spans = run.untraced("next_batch")
    return float(np.mean(spans)) * 1e3 if spans else None
