"""The host's time per dispatch of a batch: the mean of the benchmark's
span around each ``Synthesizer.synthesize_async`` call before the traced
window, in ms."""

import numpy as np


def read(run, name):
    spans = run.untraced("dispatch")
    return float(np.mean(spans)) * 1e3 if spans else None
