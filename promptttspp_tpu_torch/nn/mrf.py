"""HiFi-GAN-style multi-receptive-field blocks with LeakyReLU over
``[B, T, C]``; mask float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/nn/mrf.py``. The reference builds an
``in_conv`` and an ``out_conv`` but its forward never applies them; the
port, as JAX, has no parameters for them, and the checkpoint loader
leaves the reference's entries for them unread
(``compat/torch_ckpt.py``). Weight norm is folded at load.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Conv1d

LRELU_SLOPE = 0.1


class MRFLayer(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, kernel_size,
                            dilation=dilation)
        self.conv2 = Conv1d(channels, channels, kernel_size)

    def forward(self, x):
        y = self.conv1(F.leaky_relu(x, LRELU_SLOPE))
        return x + self.conv2(F.leaky_relu(y, LRELU_SLOPE))


class MRFBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(MRFLayer(channels, kernel_size, d)
                                    for d in dilations)

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x) * mask
        return x


class MRFNet(nn.Module):
    # the reference's modules that its forward never runs
    UNREAD = ("in_conv.", "out_conv.")

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 kernel_sizes: Sequence[int], dilations: Sequence[int]):
        super().__init__()
        self.blocks = nn.ModuleList(MRFBlock(channels, k, tuple(dilations))
                                    for k in kernel_sizes)

    def forward(self, x, mask, g: Optional = None):
        """x [B, T, C]; mask [B, T, 1]; g [B, 1, C] or None, added before
        every block."""
        for block in self.blocks:
            if g is not None:
                x = x + g
            x = block(x, mask)
        return x
