"""ConvNeXt-1d stack over ``[B, T, C]``; mask float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/nn/convnext.py``: a LayerNorm, then per
layer a depthwise 7-tap convolution, LayerNorm, pointwise expansion, exact
GELU, pointwise projection and a learned per-channel scale (initialized
to 1 / num_layers) on a residual, masked; a closing LayerNorm, masked.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear


class ConvNeXtLayer(nn.Module):
    def __init__(self, channels: int, h_channels: int, scale_init: float):
        super().__init__()
        self.dw_conv = Conv1d(channels, channels, 7, groups=channels)
        self.norm = LayerNorm(channels, eps=1e-5)
        self.pw_conv1 = Linear(channels, h_channels)
        self.pw_conv2 = Linear(h_channels, channels)
        self.scale = nn.Parameter(torch.full((channels,), float(scale_init)))

    def forward(self, x, mask):
        res = x
        x = self.norm(self.dw_conv(x))
        x = self.pw_conv2(F.gelu(self.pw_conv1(x)))
        return (res + self.scale * x) * mask


class ConvNeXt1d(nn.Module):
    def __init__(self, channels: int, h_channels: int, num_layers: int):
        super().__init__()
        self.norm_pre = LayerNorm(channels, eps=1e-5)
        self.layers = nn.ModuleList(
            ConvNeXtLayer(channels, h_channels, 1.0 / num_layers)
            for _ in range(num_layers))
        self.norm_post = LayerNorm(channels, eps=1e-5)

    def forward(self, x, mask):
        """x [B, T, C]; mask float [B, T, 1] -> [B, T, C]."""
        x = self.norm_pre(x)
        for layer in self.layers:
            x = layer(x, mask)
        return self.norm_post(x) * mask
