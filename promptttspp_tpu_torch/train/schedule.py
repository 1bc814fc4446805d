"""Noam learning-rate schedule, counted as the JAX trainer counts it.

Counterpart of ``promptttspp_tpu/train/schedule.py::noam_schedule`` under
``optax.scale_by_learning_rate``: optax calls the schedule with the number
of updates made so far, so update n (1-based) runs at ``schedule(n - 1)``
with the step clamped to >= 1, and the first two updates share one rate.
The rate is computed in float32, as JAX computes it.
"""

from __future__ import annotations

import numpy as np


def noam_schedule(base_lr: float, warmup_steps: int):
    """step -> base_lr * sqrt(w) * min(s^-0.5, s * w^-1.5), s = max(step,
    1), in float32."""
    w = float(warmup_steps)
    c0, c1 = np.float32(w ** 0.5), np.float32(w ** -1.5)
    lr0 = np.float32(base_lr)

    def schedule(step: int) -> float:
        s = np.float32(max(int(step), 1))
        return float(lr0 * (c0 * np.minimum(np.float32(1.0) / np.sqrt(s),
                                            s * c1)))

    return schedule

