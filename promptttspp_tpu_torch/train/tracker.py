"""Running-mean loss tracking with a per-epoch CSV row (copy of
``promptttspp_tpu/train/tracker.py``; ``logs/loss.csv`` in the trainer)."""

from __future__ import annotations

import os
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Tracker:
    """Accumulates named scalars; ``write`` appends one CSV row per epoch
    (``logs/loss.csv`` in the reference)."""

    def __init__(self, csv_path: Optional[str] = None):
        self.csv_path = csv_path
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        self.meters = {}

    def write(self, epoch: int):
        if self.csv_path is None:
            return
        avgs = self.averages()
        header_needed = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a") as f:
            if header_needed:
                f.write("epoch," + ",".join(avgs.keys()) + "\n")
            f.write(f"{epoch}," + ",".join(f"{v:.6f}" for v in avgs.values())
                    + "\n")
