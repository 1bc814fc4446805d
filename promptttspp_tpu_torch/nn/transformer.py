"""The VITS-style transformer: post-norm blocks, a convolutional FFN and,
optionally, VITS's windowed relative attention, over ``[B, T, C]``; masks
float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/nn/transformer.py``. The relative
attention adds learned key and value embeddings for the relative
positions within ``window_size`` (zero beyond it). The reference moves
between relative [T, 2T-1] and absolute [T, T] layouts by padding and
reshaping; JAX and the port gather instead (``rel_to_abs``,
``abs_to_rel``), the same values at any T. Masked scores are -1e4, as in
the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import ChannelLayerNorm, Conv1d, Dropout


def rel_to_abs(rel):
    """rel [B, H, T, 2T-1] (column r = s - t + T - 1) -> [B, H, T, T]."""
    T = rel.shape[2]
    ar = torch.arange(T, device=rel.device)
    idx = ar[None, :] - ar[:, None] + T - 1
    return torch.gather(rel, -1, idx.expand(*rel.shape[:2], T, T))


def abs_to_rel(p):
    """p [B, H, T, T] -> [B, H, T, 2T-1], zero where s = r + t - (T - 1)
    lies outside [0, T)."""
    T = p.shape[2]
    s = (torch.arange(2 * T - 1, device=p.device)[None, :]
         + torch.arange(T, device=p.device)[:, None] - (T - 1))
    valid = (s >= 0) & (s < T)
    out = torch.gather(p, -1, s.clamp(0, T - 1).expand(*p.shape[:2], T,
                                                       2 * T - 1))
    return out.masked_fill(~valid, 0.0)


def window_to_full(emb, T: int, window_size: int):
    """The learned window [2w+1, D] -> the [2T-1, D] table of relative
    positions T-1 .. -(T-1), zero beyond the window."""
    pad = max(0, T - (window_size + 1))
    start = max(0, (window_size + 1) - T)
    return F.pad(emb, (0, 0, pad, pad))[start:start + 2 * T - 1]


def _masked(scores, attn_mask):
    return scores if attn_mask is None else scores.masked_fill(~attn_mask,
                                                              -1e4)


class MultiHeadAttention(nn.Module):
    """Plain attention with a fused qkv 1x1 convolution."""

    def __init__(self, channels: int, n_heads: int, dropout: float):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.out = Conv1d(channels, channels, 1)
        self.dropout = Dropout(dropout)

    def forward(self, x, attn_mask):
        B, T, C = x.shape
        H, D = self.n_heads, C // self.n_heads
        qkv = self.qkv(x).reshape(B, T, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, H, T, D]
        scores = _masked(q @ k.transpose(-1, -2) / math.sqrt(D), attn_mask)
        p = self.dropout(torch.softmax(scores, dim=-1))
        return self.out((p @ v).transpose(1, 2).reshape(B, T, C))


class RelativeMultiHeadAttention(nn.Module):
    """VITS's windowed relative attention."""

    def __init__(self, channels: int, n_heads: int, dropout: float,
                 window_size: int = 4):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.window_size = window_size
        D = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(
            torch.randn(2 * window_size + 1, D) * D ** -0.5)
        self.emb_rel_v = nn.Parameter(
            torch.randn(2 * window_size + 1, D) * D ** -0.5)
        self.dropout = Dropout(dropout)

    def forward(self, x, attn_mask):
        B, T, C = x.shape
        H, D = self.n_heads, C // self.n_heads

        def split(a):
            return a.reshape(B, T, H, D).transpose(1, 2)  # [B, H, T, D]

        q = split(self.conv_q(x)) / math.sqrt(D)
        k, v = split(self.conv_k(x)), split(self.conv_v(x))
        k_emb = window_to_full(self.emb_rel_k, T, self.window_size)
        scores = (q @ k.transpose(-1, -2)
                  + rel_to_abs(q @ k_emb.transpose(0, 1)))
        p = self.dropout(torch.softmax(_masked(scores, attn_mask), dim=-1))
        v_emb = window_to_full(self.emb_rel_v, T, self.window_size)
        out = p @ v + abs_to_rel(p) @ v_emb
        return self.conv_o(out.transpose(1, 2).reshape(B, T, C))


class FFN(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dropout: float,
                 scale: int):
        super().__init__()
        self.conv1 = Conv1d(channels, channels * scale, kernel_size)
        self.conv2 = Conv1d(channels * scale, channels, 1)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask):
        x = self.dropout(torch.relu(self.conv1(x * mask)))
        return self.conv2(x * mask) * mask


class _PostNorm(nn.Module):
    """norm(x + dropout(sublayer(x, ...))), under the reference's names:
    ``attention.{attention_layer,norm}`` and ``ffn.{ffn,norm}``."""

    def __init__(self, name: str, sublayer: nn.Module, channels: int,
                 dropout: float):
        super().__init__()
        self.name = name
        setattr(self, name, sublayer)
        self.norm = ChannelLayerNorm(channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, *args):
        return self.norm(x + self.dropout(getattr(self, self.name)(x, *args)))


class TransformerLayer(nn.Module):
    def __init__(self, channels: int, num_head: int, kernel_size: int,
                 dropout: float, scale: int,
                 window_size: Optional[int] = None, use_rel: bool = False):
        super().__init__()
        attn = (RelativeMultiHeadAttention(channels, num_head, dropout,
                                           window_size) if use_rel
                else MultiHeadAttention(channels, num_head, dropout))
        self.attention = _PostNorm("attention_layer", attn, channels,
                                   dropout)
        self.ffn = _PostNorm("ffn", FFN(channels, kernel_size, dropout,
                                        scale), channels, dropout)

    def forward(self, x, mask, attn_mask):
        return self.ffn(self.attention(x, attn_mask), mask) * mask


class Transformer(nn.Module):
    def __init__(self, channels: int, num_head: int, num_layers: int,
                 kernel_size: int, dropout: float, scale: int = 4,
                 window_size: Optional[int] = None, use_rel: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(channels, num_head, kernel_size, dropout, scale,
                             window_size, use_rel)
            for _ in range(num_layers))

    def forward(self, x, mask, g: Optional[torch.Tensor] = None):
        """x [B, T, C]; mask float [B, T, 1]; g [B, 1, C] or None, added
        before every layer."""
        m = mask[:, :, 0] > 0
        attn_mask = (m[:, None, :] & m[:, :, None])[:, None]  # [B,1,T,T]
        for layer in self.layers:
            if g is not None:
                x = x + g
            x = layer(x, mask, attn_mask)
        return x
