"""Lightweight and dynamic convolution, the attention substitutes of the
ESPnet transformer suite.

Counterpart of ``promptttspp_tpu/nn/lightconv.py``: Linear -> GLU ->
(lightweight | dynamic) depthwise convolution over time with
softmax-normalized kernels -> Linear. The lightweight kernel is a learned
[wshare, 1, k] shared by channel c % wshare; the dynamic one is predicted
per position from the input and applied as a banded [T, T] matrix per
kernel group (contiguous channel blocks), as JAX does. ``use_kernel_mask``
(the decoder's) makes the kernel causal. [B, T, C] layout; ``mask`` bool
or float [B, 1|T, T] (only its first row's time validity is read) zeroes
padded steps where the kernel is not causal.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Dropout, Linear


def kernel_size_of(kernel_size_str: str, lnum: int) -> int:
    """The kernel size of layer ``lnum`` in an ESPnet "k0_k1_..." string."""
    return int(kernel_size_str.split("_")[lnum])


def glu(x):
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def valid_steps(x, mask):
    """``x`` [B, T, C] with the steps that ``mask`` [B, 1|T, T] marks
    invalid in its first row set to 0."""
    if mask is None:
        return x
    valid = mask[:, 0:1, :].transpose(1, 2)
    return torch.where(valid > 0, x, torch.zeros_like(x))


def causal_kernel(weight, k: int):
    """``weight`` [..., k] with its future taps (the last k // 2) at -inf."""
    keep = torch.arange(k, device=weight.device) <= k // 2
    return weight.masked_fill(~keep, -torch.inf)


def lightweight_conv(x, weight, k: int):
    """x [B, T, C]; weight [H, 1, k] (softmaxed) -> the depthwise
    convolution of channel c with kernel c % H, padded (k//2, k//2 - 1 +
    k % 2) as JAX pads it."""
    C = x.shape[-1]
    w = weight.repeat(C // weight.shape[0], 1, 1)  # [C, 1, k]
    pad = k // 2
    xt = F.pad(x.transpose(1, 2), (pad, pad - (1 - k % 2)))
    return F.conv1d(xt, w.to(x.dtype), groups=C).transpose(1, 2)


def dynamic_conv(x, w, k: int, causal: bool):
    """x [B, T, C]; w [B, T, H, k] per-position kernels -> the banded
    product: out[b, t, c] = sum_s softmax_s(band)[b, h, t, s] x[b, s, c],
    h the block of c, band[t, s] = w[t, s - t + (k-1)//2] inside the band
    (and s <= t where ``causal``), -inf outside."""
    B, T, C = x.shape
    H = w.shape[2]
    w = w.transpose(1, 2)  # [B, H, T, k]
    t = torch.arange(T, device=x.device)[:, None]
    s = torch.arange(T, device=x.device)[None, :]
    rel = s - t + (k - 1) // 2
    inside = (rel >= 0) & (rel < k)
    if causal:
        inside = inside & (s <= t)
    band = torch.gather(w, -1, rel.clamp(0, k - 1).expand(B, H, T, T))
    band = torch.softmax(band.masked_fill(~inside, -torch.inf), dim=-1)
    xh = x.reshape(B, T, H, C // H).transpose(1, 2)  # [B, H, T, C/H]
    return (band @ xh).transpose(1, 2).reshape(B, T, C)


class LightweightConvolution(nn.Module):
    """The attention API with the query alone: ``forward(query, key=None,
    value=None, mask=None)``."""

    def __init__(self, wshare: int, n_feat: int, dropout_rate: float = 0.0,
                 kernel_size_str: str = "3", lnum: int = 0,
                 use_kernel_mask: bool = False, use_bias: bool = False):
        super().__init__()
        self.k = kernel_size_of(kernel_size_str, lnum)
        self.use_kernel_mask = use_kernel_mask
        self.linear1 = Linear(n_feat, 2 * n_feat)
        self.linear2 = Linear(n_feat, n_feat)
        self.weight = nn.Parameter(torch.rand(wshare, 1, self.k))
        self.bias = nn.Parameter(torch.zeros(n_feat)) if use_bias else None
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, mask=None):
        x = glu(self.linear1(query))
        weight = self.dropout(self.weight, batched=False)
        if self.use_kernel_mask:
            weight = causal_kernel(weight, self.k)
        x = lightweight_conv(x, torch.softmax(weight, dim=-1), self.k)
        if self.bias is not None:
            x = x + self.bias
        if not self.use_kernel_mask:
            x = valid_steps(x, mask)
        return self.linear2(x)


class DynamicConvolution(nn.Module):
    """Per-position kernels from ``linear_weight``; the attention API with
    the query alone."""

    def __init__(self, wshare: int, n_feat: int, dropout_rate: float = 0.0,
                 kernel_size_str: str = "3", lnum: int = 0,
                 use_kernel_mask: bool = False, use_bias: bool = False):
        super().__init__()
        self.k, self.h = kernel_size_of(kernel_size_str, lnum), wshare
        self.use_kernel_mask = use_kernel_mask
        self.linear1 = Linear(n_feat, 2 * n_feat)
        self.linear2 = Linear(n_feat, n_feat)
        self.linear_weight = Linear(n_feat, wshare * self.k)
        self.bias = nn.Parameter(torch.zeros(n_feat)) if use_bias else None
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, mask=None):
        x = glu(self.linear1(query))
        B, T, _ = x.shape
        w = self.dropout(self.linear_weight(x)).reshape(B, T, self.h, self.k)
        x = dynamic_conv(x, w, self.k, self.use_kernel_mask)
        if self.bias is not None:
            x = x + self.bias
        if not self.use_kernel_mask:
            x = valid_steps(x, mask)
        return self.linear2(x)
