"""2-D (time and feature axes) lightweight and dynamic convolution.

Counterpart of ``promptttspp_tpu/nn/lightconv2d.py``: on top of the time
convolution of ``nn/lightconv.py`` a second convolution runs along the
feature axis (zero-padded, one kernel shared by every channel), and the two
paths are concatenated before the output Linear (2C -> C). The lightweight
variant's feature kernel is learned (``weight_f`` [1, 1, k], softmax then
dropout, the reverse of its time kernel's order); the dynamic variant's is
predicted per position (``linear_weight_f``, no softmax, no dropout), as
JAX does. Odd kernel sizes only. [B, T, C] layout; ``mask`` [B, 1|T, T].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Dropout, Linear
from promptttspp_tpu_torch.nn.lightconv import (
    causal_kernel, dynamic_conv, glu, kernel_size_of, lightweight_conv,
    valid_steps)


def feature_axis_conv(x, w):
    """x [B, T, C]; w [k] or [B, T, k] -> out[b, t, c] = sum_j w[.., j]
    x_padded[b, t, c + j - k//2], zero-padded along C."""
    k = w.shape[-1]
    C = x.shape[-1]
    xp = F.pad(x, (k // 2, k // 2))
    out = 0.0
    for j in range(k):
        wj = w[j] if w.ndim == 1 else w[..., j, None]
        out = out + wj * xp[..., j:j + C]
    return out


def _odd(k: int) -> int:
    if k % 2 != 1:
        raise ValueError(f"2-D light/dynamic convolution needs an odd "
                         f"kernel size, not {k}")
    return k


class LightweightConvolution2D(nn.Module):
    """The attention API with the query alone."""

    def __init__(self, wshare: int, n_feat: int, dropout_rate: float = 0.0,
                 kernel_size_str: str = "3", lnum: int = 0,
                 use_kernel_mask: bool = False, use_bias: bool = False):
        super().__init__()
        self.k = _odd(kernel_size_of(kernel_size_str, lnum))
        self.use_kernel_mask = use_kernel_mask
        self.linear1 = Linear(n_feat, 2 * n_feat)
        self.linear2 = Linear(2 * n_feat, n_feat)
        self.weight = nn.Parameter(torch.rand(wshare, 1, self.k))
        self.weight_f = nn.Parameter(torch.rand(1, 1, self.k))
        self.bias = nn.Parameter(torch.zeros(n_feat)) if use_bias else None
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, mask=None):
        x = glu(self.linear1(query))
        wf = self.dropout(torch.softmax(self.weight_f[0, 0], dim=-1),
                          batched=False)
        xf = feature_axis_conv(x, wf)
        weight = self.dropout(self.weight, batched=False)
        if self.use_kernel_mask:
            weight = causal_kernel(weight, self.k)
        xt = lightweight_conv(x, torch.softmax(weight, dim=-1), self.k)
        if self.bias is not None:
            xt = xt + self.bias
        x = torch.cat([xt, xf], dim=-1)
        if not self.use_kernel_mask:
            x = valid_steps(x, mask)
        return self.linear2(x)


class DynamicConvolution2D(nn.Module):
    """The attention API with the query alone."""

    def __init__(self, wshare: int, n_feat: int, dropout_rate: float = 0.0,
                 kernel_size_str: str = "3", lnum: int = 0,
                 use_kernel_mask: bool = False, use_bias: bool = False):
        super().__init__()
        self.k, self.h = _odd(kernel_size_of(kernel_size_str, lnum)), wshare
        self.use_kernel_mask = use_kernel_mask
        self.linear1 = Linear(n_feat, 2 * n_feat)
        self.linear2 = Linear(2 * n_feat, n_feat)
        self.linear_weight = Linear(n_feat, wshare * self.k)
        self.linear_weight_f = Linear(n_feat, self.k)
        self.bias = nn.Parameter(torch.zeros(n_feat)) if use_bias else None
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, mask=None):
        x = glu(self.linear1(query))
        B, T, _ = x.shape
        xf = feature_axis_conv(x, self.linear_weight_f(x))
        w = self.dropout(self.linear_weight(x)).reshape(B, T, self.h, self.k)
        xt = dynamic_conv(x, w, self.k, self.use_kernel_mask)
        if self.bias is not None:
            xt = xt + self.bias
        x = torch.cat([xt, xf], dim=-1)
        if not self.use_kernel_mask:
            x = valid_steps(x, mask)
        return self.linear2(x)
