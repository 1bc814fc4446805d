"""The median wait of a request between the moment it was due and its
dispatch, in ms, over the requests due before the traced window."""

import numpy as np


def read(run, name):
    end = run.cutoff()
    waits = [w for due, w in run.values.get("queue_wait_ms", [])
             if due < end]
    return float(np.median(waits)) if waits else None
