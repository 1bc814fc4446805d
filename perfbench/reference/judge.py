"""The numbers that decide ``correct``: each a gap between what the
program produced and what the reference computed, compared with a limit
(``workloads/<cell>.json``'s ``limits``; the readings each limit was set
from are in PERF.md).

Serving (``serve_gaps``), over the requests checked:

- ``frames``: the largest difference in frame count (exact: limit 0);
- ``mel``: the largest |program - reference| of a request's denormalised
  mel over the largest |reference| of it;
- ``wav``: the largest |program - reference| of a request's waveform
  (in [-1, 1]).

Training (``train_gaps``), over the first three updates:

- ``loss``: the largest |program - reference| / |reference| of an
  update's loss;
- ``grad``: the worst leaf's gap between the norm of the first gradient
  as AdamW got it (its first moment after one update over 1 - beta1) and
  the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change``: the same of the parameters' change over the three updates.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought but for rounding, as a key's bias under softmax) are left
out of ``grad`` and ``change``. A missing or misshapen answer reads
``MISSING``, beyond any limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MISSING = 1e30
GRAD_FLOOR = 1e-3


def serve_gaps(program: Sequence[Dict], reference: Sequence[Dict]):
    """``program`` and ``reference``: per batch {"mels", "wavs"} lists.
    -> {"frames", "mel", "wav"}."""
    frames = mel = wav = 0.0
    for p, r in zip(program, reference):
        if p is None or len(p["mels"]) != len(r["mels"]):
            return {"frames": MISSING, "mel": MISSING, "wav": MISSING}
        for pm, rm, pw, rw in zip(p["mels"], r["mels"], p["wavs"],
                                  r["wavs"]):
            frames = max(frames, abs(len(pm) - len(rm)))
            if pm.shape != rm.shape or pw.shape != rw.shape:
                mel = wav = MISSING
                continue
            scale = max(float(np.abs(rm).max()), 1e-12)
            mel = max(mel, float(np.abs(pm - rm).max()) / scale)
            wav = max(wav, float(np.abs(pw - rw).max()))
    return {"frames": float(frames), "mel": _finite(mel),
            "wav": _finite(wav)}


def _finite(x: float) -> float:
    return x if np.isfinite(x) else MISSING


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    if not keep:
        return MISSING
    median = float(np.median([ref[k] for k in keep]))
    gaps = [abs(prog.get(k, MISSING) - ref[k]) / max(ref[k], median, 1e-30)
            for k in keep]
    return _finite(max(gaps))


def train_gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """Each side: {"losses": [3 floats], "grad": {leaf: norm}, "change":
    {leaf: norm}}. -> {"loss", "grad", "change"}."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr):
        loss = MISSING
    else:
        loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
    g = reference["grad"]
    median = float(np.median(list(g.values())))
    keep = [k for k, v in g.items() if v >= GRAD_FLOOR * median]
    return {"loss": _finite(loss),
            "grad": _leaf_gap(program["grad"], g, keep),
            "change": _leaf_gap(program["change"], reference["change"],
                                keep)}
