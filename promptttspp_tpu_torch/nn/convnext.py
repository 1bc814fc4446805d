"""ConvNeXt-1d stack over ``[B, T, C]``; mask float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/nn/convnext.py``: a LayerNorm, then per
layer a depthwise 7-tap convolution, LayerNorm, pointwise expansion, exact
GELU, pointwise projection and a learned per-channel scale (initialized
to 1 / num_layers) on a residual, masked; a closing LayerNorm, masked.
The LayerNorms' ``eps`` is 1e-5 as in JAX; Vocos's backbone
(``vocoders/vocos.py``) takes 1e-6.

ConvNeXt-V2 (``ConvNeXtV2Block``, F5-TTS's text encoder): a depthwise
7-tap convolution, LayerNorm (eps 1e-6), pointwise expansion, exact GELU,
global response normalisation (``GRN``) and the pointwise projection on a
residual.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear


class ConvNeXtLayer(nn.Module):
    def __init__(self, channels: int, h_channels: int, scale_init: float,
                 eps: float = 1e-5):
        super().__init__()
        self.dw_conv = Conv1d(channels, channels, 7, groups=channels)
        self.norm = LayerNorm(channels, eps=eps)
        self.pw_conv1 = Linear(channels, h_channels)
        self.pw_conv2 = Linear(h_channels, channels)
        self.scale = nn.Parameter(torch.full((channels,), float(scale_init)))

    def forward(self, x, mask):
        res = x
        x = self.norm(self.dw_conv(x))
        x = self.pw_conv2(F.gelu(self.pw_conv1(x)))
        return (res + self.scale * x) * mask


class ConvNeXt1d(nn.Module):
    def __init__(self, channels: int, h_channels: int, num_layers: int,
                 eps: float = 1e-5):
        super().__init__()
        self.norm_pre = LayerNorm(channels, eps=eps)
        self.layers = nn.ModuleList(
            ConvNeXtLayer(channels, h_channels, 1.0 / num_layers, eps)
            for _ in range(num_layers))
        self.norm_post = LayerNorm(channels, eps=eps)

    def forward(self, x, mask):
        """x [B, T, C]; mask float [B, T, 1] -> [B, T, C]."""
        x = self.norm_pre(x)
        for layer in self.layers:
            x = layer(x, mask)
        return self.norm_post(x) * mask


class GRN(nn.Module):
    """Global response normalisation over time: G = ||x||_2 over the
    frames ``mask`` keeps (all without one), N = G / (mean_c G + 1e-6),
    gamma * (x * N) + beta + x. G is summed in float32 whatever x's dtype,
    so a float16 x of many frames cannot overflow it."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, mask=None):
        """x [B, T, C]; mask bool [B, T, 1] or None."""
        kept = x if mask is None else torch.where(mask, x, 0.0)
        g = torch.linalg.vector_norm(kept, dim=1, keepdim=True,
                                     dtype=torch.float32)
        n = (g / (g.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma * (x * n) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, channels: int, h_channels: int):
        super().__init__()
        self.dw_conv = Conv1d(channels, channels, 7, groups=channels)
        self.norm = LayerNorm(channels, eps=1e-6)
        self.pw_conv1 = Linear(channels, h_channels)
        self.grn = GRN(h_channels)
        self.pw_conv2 = Linear(h_channels, channels)

    def forward(self, x, mask=None):
        """x [B, T, C]; mask bool [B, T, 1]: the frames GRN pools over."""
        y = self.norm(self.dw_conv(x))
        y = self.grn(F.gelu(self.pw_conv1(y)), mask)
        return x + self.pw_conv2(y)
