"""Zero-phase Butterworth smoothing of F0 contours.

Counterpart of ``promptttspp_tpu/ops/filters.py`` (``pad=False``, the
serving path): Butterworth N=5, 20 Hz at fs 100, forward then backward
filtering with no edge padding (torchaudio's ``filtfilt``). Coefficients
come from scipy as float32, with ``nyquist = fs // 2``.

The IIR runs without a loop over samples: with zero initial state the
filter is linear and time-invariant, so ``y = H x`` with the
lower-triangular Toeplitz matrix of its impulse response. The response is
computed on the host in float64 from the float32 coefficients; the product
runs on the input's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import signal as _scipy_signal


@functools.lru_cache(maxsize=None)
def butter_lowpass(order: int, cutoff_hz: float, fs: float):
    nyquist = fs // 2
    b, a = _scipy_signal.butter(order, cutoff_hz / nyquist, "lowpass")
    return np.asarray(b, np.float32), np.asarray(a, np.float32)


def impulse_response(b, a, length: int) -> np.ndarray:
    """First ``length`` samples of the filter's impulse response (float64)."""
    impulse = np.zeros(length)
    impulse[0] = 1.0
    return _scipy_signal.lfilter(np.asarray(b, np.float64),
                                 np.asarray(a, np.float64), impulse)


def lfilter(x: torch.Tensor, b, a) -> torch.Tensor:
    """Zero-state IIR filter along the last axis of x [..., T]."""
    T = x.shape[-1]
    h = torch.as_tensor(impulse_response(b, a, T), dtype=x.dtype,
                        device=x.device)
    idx = torch.arange(T, device=x.device)
    lag = idx[:, None] - idx[None, :]
    H = torch.where(lag >= 0, h[lag.clamp(min=0)], torch.zeros_like(h[0]))
    return x @ H.T


def filtfilt(x: torch.Tensor, b, a) -> torch.Tensor:
    """Forward then backward filtering, no edge padding."""
    y = lfilter(x, b, a)
    return lfilter(y.flip(-1), b, a).flip(-1)


def lowpass_filter(x: torch.Tensor, fs: int = 100, cutoff: int = 20,
                   N: int = 5) -> torch.Tensor:
    """Zero-phase Butterworth lowpass of an F0 contour [..., T]."""
    b, a = butter_lowpass(N, cutoff, fs)
    if x.shape[-1] <= max(len(a), len(b)) * (N // 2 + 1):
        return x  # too short: the reference returns the input unchanged
    return filtfilt(x, b, a)
