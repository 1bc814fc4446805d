"""Linear interpolation over the unvoiced gaps of an F0 contour.

Counterpart of ``promptttspp_tpu/ops/interp.py`` (nnmnkwii's ``interp1d`` as
the reference uses it): voiced samples (f0 > 0) are the knots, gaps are
filled linearly, leading and trailing unvoiced runs copy the nearest voiced
value, and an all-unvoiced contour gives zeros. Prefix and suffix scans
(``torch.cummax``) over the last axis, so it batches without
data-dependent shapes.
"""

from __future__ import annotations

import torch


def interp1d(f0: torch.Tensor) -> torch.Tensor:
    """f0 [..., T] with zeros at unvoiced frames -> continuous contour."""
    T = f0.shape[-1]
    voiced = f0 > 0
    pos = torch.arange(T, dtype=torch.float32, device=f0.device)
    neg_inf = torch.tensor(float("-inf"), device=f0.device)

    # the most recent voiced frame at or before t (running max), and the
    # next one at or after t (a running max of -t over the reversed axis)
    prev_idx = torch.cummax(torch.where(voiced, pos, neg_inf), -1).values
    next_idx = -torch.cummax(torch.where(voiced, -pos, neg_inf).flip(-1),
                             -1).values.flip(-1)

    has_prev = torch.isfinite(prev_idx)
    has_next = torch.isfinite(next_idx)
    prev_i = prev_idx.clamp(0, T - 1).long()
    next_i = next_idx.clamp(0, T - 1).long()
    prev_val = torch.gather(f0, -1, prev_i)
    next_val = torch.gather(f0, -1, next_i)

    span = torch.clamp(next_idx - prev_idx, min=1.0)
    w = ((pos - prev_idx) / span).clamp(0.0, 1.0)
    interp = prev_val * (1.0 - w) + next_val * w

    zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
    out = torch.where(has_prev & has_next, interp, zero)
    out = torch.where(has_prev & ~has_next, prev_val, out)
    out = torch.where(~has_prev & has_next, next_val, out)
    return torch.where(voiced, f0, out)
