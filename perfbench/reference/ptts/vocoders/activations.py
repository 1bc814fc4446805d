"""Anti-aliased Snake activation and kaiser-sinc resampling.

Counterpart of ``promptttspp_tpu/vocoders/activations.py``: Snake
``x + (1/a) sin^2(a x)`` with a = exp(alpha) per channel, bracketed by 2x
kaiser-windowed-sinc up/downsampling with replicate padding. The
resamplers here are the plain PyTorch versions (depthwise
``conv_transpose1d`` / strided ``conv1d``, torch semantics of the
reference's ``UpSample1d`` / ``DownSample1d``); ``AntiAliasActivation``
runs the whole sandwich through ``ops/kernels/snake.py::antialias_snake``,
which launches the CUDA kernel for a CUDA tensor.

Public functions take and return ``[B, T, C]``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int):
    """[kernel_size] normalized lowpass taps (float32 numpy)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _depthwise(filt: np.ndarray, channels: int, like: torch.Tensor):
    """[K] taps -> [C, 1, K] depthwise weight on ``like``'s device."""
    w = torch.as_tensor(filt, dtype=like.dtype, device=like.device)
    return w.view(1, 1, -1).expand(channels, 1, -1)


def upsample2(x, ratio: int = 2, kernel_size: int = 12):
    """Kaiser-sinc 2x upsampling: [B, T, C] -> [B, ratio*T, C]."""
    C = x.shape[-1]
    stride = ratio
    pad = kernel_size // ratio - 1
    pad_left = pad * stride + (kernel_size - stride) // 2
    pad_right = pad * stride + (kernel_size - stride + 1) // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)
    xc = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xc, _depthwise(filt, C, x), stride=stride,
                                   groups=C)
    return y[:, :, pad_left:-pad_right].transpose(1, 2)


def lowpass(x, cutoff: float, half_width: float, stride: int = 1,
            kernel_size: int = 12):
    """Replicate-padded kaiser-sinc lowpass over [B, T, C]."""
    C = x.shape[-1]
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    filt = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
    xc = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    y = F.conv1d(xc, _depthwise(filt, C, x), stride=stride, groups=C)
    return y.transpose(1, 2)


def downsample2(x, ratio: int = 2, kernel_size: int = 12):
    return lowpass(x, 0.5 / ratio, 0.6 / ratio, stride=ratio,
                   kernel_size=kernel_size)


def snake(x, alpha):
    """Snake with log-parameterized per-channel alpha: a = exp(alpha)."""
    a = torch.exp(alpha)
    return x + (1.0 / (a + 1e-9)) * torch.square(torch.sin(x * a))


class Snake(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return snake(x, self.alpha)


class AntiAliasActivation(nn.Module):
    """up2 -> snake -> down2 over [B, T, C], unfused (the plain version of
    the port's kernel K1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = Snake(channels)

    def forward(self, x):
        return antialias_snake_plain(x, self.act.alpha)


def antialias_snake_plain(x, alpha):
    """The unfused up2 -> snake -> down2."""
    return downsample2(snake(upsample2(x), alpha))
