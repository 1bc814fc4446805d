"""BigVGAN generator over ``[B, T, C]``.

Counterpart of ``promptttspp_tpu/vocoders/bigvgan.py``: mel [B, T, 80] ->
conv k7 -> per upsample stage [ConvTranspose1d -> mean of the MRF's
AMPBlocks] -> anti-aliased snake -> conv k7 -> tanh -> wav [B, 240*T, 1].

Parameter names follow the reference's torch ``state_dict``
(``upsamples.0.weight``, ``mrfs.0.0.layers.0.conv1.weight``,
``mrfs.0.0.layers.0.act1.act.alpha``, ...); weight norm stays folded, as in
the JAX package. Every AMPLayer runs through
``ops/kernels/amp.py::amp_layer`` (kernel K2 on a CUDA tensor) and the final
activation through kernel K1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Conv1d
from promptttspp_tpu_torch.ops.kernels import amp as amp_kernel
from promptttspp_tpu_torch.vocoders.activations import AntiAliasActivation


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch ``ConvTranspose1d`` taking and returning ``[B, T, C]``:
    out_len = (T-1)*stride - 2*padding + kernel_size + output_padding.
    Weight ``[in, out, K]`` (torch layout)."""

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               self.stride, self.padding,
                               self.output_padding)
        return y.transpose(1, 2)


class AMPLayer(nn.Module):
    """AA-snake -> dilated conv -> AA-snake -> conv, plus the residual.

    ``conv_precision`` is kept for the JAX interface ("default" = bf16
    operands there, "highest" = f32); the CUDA kernel computes float32 for
    both, which meets both of the JAX kernel's tolerances."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 conv_precision: str = "default"):
        super().__init__()
        self.dilation = dilation
        self.conv_precision = conv_precision
        self.act1 = AntiAliasActivation(channels)
        self.conv1 = Conv1d(channels, channels, kernel_size,
                            dilation=dilation)
        self.act2 = AntiAliasActivation(channels)
        self.conv2 = Conv1d(channels, channels, kernel_size)

    def forward(self, x):
        return amp_kernel.amp_layer(
            x, self.act1.act.alpha, self.conv1.weight, self.conv1.bias,
            self.act2.act.alpha, self.conv2.weight, self.conv2.bias,
            self.dilation)


class AMPBlock(nn.Module):
    """A chain of AMPLayers over one kernel size, one K2 call per layer."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int], conv_precision: str = "default"):
        super().__init__()
        self.layers = nn.ModuleList(
            AMPLayer(channels, kernel_size, d, conv_precision)
            for d in dilations)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MRFStage(nn.ModuleList):
    """One upsample stage's multi-receptive-field blocks: the mean of the
    AMPBlocks (a bare ModuleList in the reference: ``mrfs.<i>.<j>``)."""

    def __init__(self, channels: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilations: Sequence[Sequence[int]],
                 conv_precision: str = "default"):
        super().__init__(
            AMPBlock(channels, k, d, conv_precision)
            for k, d in zip(resblock_kernel_sizes, resblock_dilations))

    def forward(self, x):
        x = x.contiguous()  # the kernels take contiguous [B, T, C]
        acc = 0.0
        for block in self:
            acc = acc + block(x)
        return acc / len(self)


class BigVGAN(nn.Module):
    def __init__(self, in_channel: int = 80,
                 upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (6, 5, 4, 2),
                 upsample_kernel_sizes: Sequence[int] = (12, 10, 8, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3,
                 conv_precision: str = "default"):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.conv_pre = Conv1d(in_channel, upsample_initial_channel, 7)
        self.upsamples = nn.ModuleList()
        self.mrfs = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates,
                                       upsample_kernel_sizes)):
            cin = upsample_initial_channel // (2 ** i)
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.upsamples.append(ConvTranspose1d(
                cin, ch, k, stride=u, padding=u // 2 + u % 2,
                output_padding=u % 2))
            self.mrfs.append(MRFStage(ch, resblock_kernel_sizes,
                                      resblock_dilations, conv_precision))
        last_ch = upsample_initial_channel // (2 ** len(upsample_rates))
        self.act_post = AntiAliasActivation(last_ch)
        self.conv_post = Conv1d(last_ch, 1, 7)

    def forward(self, mel):
        """mel [B, T, in_channel] -> wav [B, T * prod(rates), 1]."""
        x = self.conv_pre(mel)
        for up, mrf in zip(self.upsamples, self.mrfs):
            x = mrf(up(x))
        x = self.act_post(x)
        return torch.tanh(self.conv_post(x))
