"""Primitive layers over channel-last ``[B, T, C]`` tensors.

Counterpart of ``promptttspp_tpu/nn/layers.py``. Parameters keep torch's
own layouts (``Conv1d.weight`` is ``[out, in/groups, k]``, ``Linear.weight``
is ``[out, in]``) and the reference's ``state_dict`` names, so the weight
converter (``compat/from_jax.py``) is a fixed transpose per leaf.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def swish(x):
    return x * torch.sigmoid(x)


def conv1d_btc(x, weight, bias=None, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1):
    """``F.conv1d`` on ``[B, T, C_in]`` -> ``[B, T', C_out]`` with a torch
    weight ``[C_out, C_in/groups, k]``. A 1x1 conv is the same product as a
    linear layer and runs as one."""
    if (weight.shape[-1] == 1 and groups == 1 and stride == 1
            and padding == 0):
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride, padding, dilation,
                 groups)
    return y.transpose(1, 2)


def conv1d_same(x, weight, bias, dilation: int = 1):
    """Stride-1 SAME conv (odd kernels): padding ``(k-1)//2 * dilation``."""
    k = weight.shape[-1]
    return conv1d_btc(x, weight, bias, padding=(k - 1) // 2 * dilation,
                      dilation=dilation)


class Conv1d(nn.Conv1d):
    """torch ``Conv1d`` taking and returning ``[B, T, C]``. ``padding=None``
    is the reference's universal ``(k-1)//2 * dilation`` (SAME for the odd
    kernels used throughout)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, stride: int = 1, padding=None):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dilation=dilation,
                         groups=groups, bias=bias)

    def forward(self, x):
        return conv1d_btc(x, self.weight, self.bias, self.stride[0],
                          self.padding[0], self.dilation[0], self.groups)


class ChannelLayerNorm(nn.Module):
    """The reference's ``layers/norm.py`` LayerNorm: ``gamma``/``beta``
    parameters, eps 1e-5, over the channel (last) axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta,
                            self.eps)


def layer_norm(features: int, eps: float = 1e-12) -> nn.LayerNorm:
    """ESPnet LayerNorm (eps 1e-12) over the channel (last) axis."""
    return nn.LayerNorm(features, eps=eps)
