"""Primitive layers over channel-last ``[B, T, C]`` tensors.

Counterpart of ``promptttspp_tpu/nn/layers.py``. Parameters keep torch's
own layouts (``Conv1d.weight`` is ``[out, in/groups, k]``, ``Linear.weight``
is ``[out, in]``) and the reference's ``state_dict`` names, so the weight
converter (``compat/from_jax.py``) is a fixed transpose per leaf.

Train mode (``module.train()``) switches ``WeightedBatchNorm`` to batch
statistics and ``Dropout`` to drawing masks, together. Dropout draws from
the generator that ``dropout_generator`` lends it for one call, never
from torch's global RNG.
"""

from __future__ import annotations

import contextlib
import math

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


class WeightedBatchNorm(nn.Module):
    """Flax's ``BatchNorm`` on ``[B, C, ...]`` (channel at dim 1), with the
    JAX package's per-row weight (``WeightedBatchNorm`` of
    ``promptttspp_tpu/nn/layers.py``).

    Eval: the running statistics (as ``F.batch_norm``). Train: the batch
    statistics in float32, mean and mean of squares over every dim but 1
    and the variance as ``mean2 - mean**2`` (biased), rows of
    ``row_weight`` 0 left out; then ``running = momentum * running +
    (1 - momentum) * batch`` (flax's momentum 0.9 keeps 0.9 of the old
    value). The names are ``BatchNorm1d``'s, so checkpoints load as
    before."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, row_weight=None):
        """x [B, C, ...]; row_weight [B] float or None (every row)."""
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        if row_weight is None:
            mean = xf.mean(dims)
            mean2 = xf.square().mean(dims)
        else:
            w = row_weight.float().reshape((-1,) + (1,) * (x.ndim - 1))
            n = w.sum() * math.prod(x.shape[2:])
            mean = (xf * w).sum(dims) / n
            mean2 = (xf.square() * w).sum(dims) / n
        var = mean2 - mean.square()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        return (y * self.weight.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


class Dropout(nn.Module):
    """Flax's ``Dropout``: in train mode keep each element with probability
    1 - p and scale it by 1 / (1 - p); the mask comes from the generator
    that ``dropout_generator`` lends. Eval mode, or p = 0, is the
    identity."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in train mode draws from a generator: "
                               "call the model inside dropout_generator()")
        keep_prob = 1.0 - self.p
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator):
    """Lend ``generator`` to every ``Dropout`` under ``module`` for the
    duration of the block."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None
