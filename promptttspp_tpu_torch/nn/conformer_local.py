"""The self-contained conformer with a conditioning vector ``g`` added
before every layer, over ``[B, T, C]``; mask float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/nn/conformer_local.py``. It differs from
the ESPnet conformer (``nn/conformer.py``): the relative encoding does not
scale x by sqrt(d), the FFNs are SiLU with 4x hidden width and no
masking, the convolution module is unmasked with a ReLU after its
BatchNorm, and each block ends in a LayerNorm. The attention is the
port's ``RelPositionMultiHeadedAttention`` on the 'new' 2T-1 table.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from promptttspp_tpu_torch.nn.embedding import _device_table, rel_sinusoid_table
from promptttspp_tpu_torch.nn.layers import (
    Conv1d, Dropout, Linear, WeightedBatchNorm, layer_norm, swish)


class LocalRelPositionalEncoding(nn.Module):
    """(dropout(x), dropout(pos_emb [1, 2T-1, d])), x not scaled."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        pos_emb = _device_table(rel_sinusoid_table, x.shape[1],
                                self.d_model, x.device)
        return self.dropout(x), self.dropout(pos_emb[None], batched=False)


class LocalConvolutionModule(nn.Module):
    """Pointwise GLU, depthwise conv, BatchNorm, ReLU, pointwise; no
    mask."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     groups=channels)
        self.norm = WeightedBatchNorm(channels)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def forward(self, x):
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(b))
        x = torch.relu(self.norm(x.transpose(1, 2)).transpose(1, 2))
        return self.pointwise_conv2(x)


class LocalFFN(nn.Module):
    def __init__(self, idim: int, hidden_units: int, dropout_rate: float):
        super().__init__()
        self.w_1 = Linear(idim, hidden_units)
        self.w_2 = Linear(hidden_units, idim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        return self.w_2(self.dropout(swish(self.w_1(x))))


class ConformerLayer(nn.Module):
    def __init__(self, channels: int, num_head: int, kernel_size: int,
                 dropout: float, ffn_scale: int = 4):
        super().__init__()
        self.norm1 = layer_norm(channels)
        self.ffn1 = LocalFFN(channels, channels * ffn_scale, dropout)
        self.norm_attn = layer_norm(channels)
        self.attn = RelPositionMultiHeadedAttention(num_head, channels,
                                                    dropout)
        self.norm_conv = layer_norm(channels)
        self.conv_module = LocalConvolutionModule(channels, kernel_size)
        self.norm2 = layer_norm(channels)
        self.ffn2 = LocalFFN(channels, channels * ffn_scale, dropout)
        self.norm_final = layer_norm(channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, pos_emb, mask):
        """x [B, T, C]; pos_emb [1, 2T-1, C]; mask float [B, T, 1]."""
        x = x + 0.5 * self.dropout(self.ffn1(self.norm1(x))) * mask
        m = mask[:, :, 0] > 0
        attn_mask = m[:, None, :] & m[:, :, None]  # [B, T, T]
        y = self.norm_attn(x)
        x = x + self.dropout(self.attn(y, y, y, pos_emb, attn_mask)) * mask
        x = x + self.dropout(self.conv_module(self.norm_conv(x))) * mask
        x = x + 0.5 * self.dropout(self.ffn2(self.norm2(x))) * mask
        return self.norm_final(x)


class Conformer(nn.Module):
    def __init__(self, num_layers: int, channels: int, num_head: int,
                 kernel_size: int, dropout: float, ffn_scale: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.rel_pos_emb = LocalRelPositionalEncoding(channels, dropout)
        self.layers = nn.ModuleList(
            ConformerLayer(channels, num_head, kernel_size, dropout,
                           ffn_scale) for _ in range(num_layers))

    def forward(self, x, mask, g: Optional[torch.Tensor] = None):
        """x [B, T, C]; mask float [B, T, 1]; g [B, 1, C] or None, added
        before every layer."""
        x, pos_emb = self.rel_pos_emb(x)
        for layer in self.layers:
            if g is not None:
                x = x + g
            x = layer(x, pos_emb, mask)
        return x
