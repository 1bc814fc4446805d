"""Conformer encoder stack, eval mode.

Counterpart of ``promptttspp_tpu/nn/conformer.py`` for the configuration
the flagship runs (``conf/model/prompttts_mdn_v2_wo_erg_final.yaml``):
'new' relative positions, conv1d position-wise FFN, macaron style (0.5 x
FFN before attention), conv module (pointwise + GLU, depthwise k,
BatchNorm with running stats, swish, pointwise), LayerNorm eps 1e-12,
and the reference's mask-multiply points. Other options of the JAX module
are not ported; ``flagship.py`` checks a config against this set.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from promptttspp_tpu_torch.nn.embedding import RelPositionalEncoding
from promptttspp_tpu_torch.nn.layers import Conv1d, layer_norm, swish
from promptttspp_tpu_torch.ops.masks import sequence_mask


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     groups=channels)
        self.norm = nn.BatchNorm1d(channels, eps=1e-5)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def forward(self, x, mask):
        """x [B, T, C]; mask float [B, T, 1]."""
        x = self.pointwise_conv1(x) * mask
        a, b = x.chunk(2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(b)) * mask
        x = self.norm(x.transpose(1, 2)).transpose(1, 2)
        return self.pointwise_conv2(swish(x)) * mask


class MultiLayeredConv1d(nn.Module):
    """FastSpeech conv1d FFN."""

    def __init__(self, in_chans: int, hidden_chans: int, kernel_size: int):
        super().__init__()
        self.w_1 = Conv1d(in_chans, hidden_chans, kernel_size)
        self.w_2 = Conv1d(hidden_chans, in_chans, kernel_size)

    def forward(self, x, mask):
        x = torch.relu(self.w_1(x * mask)) * mask
        return self.w_2(x) * mask


class EncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 positionwise_conv_kernel_size: int, cnn_module_kernel: int):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(attention_heads,
                                                         size)
        self.feed_forward = MultiLayeredConv1d(
            size, linear_units, positionwise_conv_kernel_size)
        self.feed_forward_macaron = MultiLayeredConv1d(
            size, linear_units, positionwise_conv_kernel_size)
        self.conv_module = ConvolutionModule(size, cnn_module_kernel)
        self.norm_ff = layer_norm(size)
        self.norm_mha = layer_norm(size)
        self.norm_ff_macaron = layer_norm(size)
        self.norm_conv = layer_norm(size)
        self.norm_final = layer_norm(size)

    def forward(self, x, pos_emb, attn_mask, mask):
        """x [B,T,C]; pos_emb [1,2T-1,C]; attn_mask bool [B,T,T];
        mask float [B,T,1]."""
        x = x * mask
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x),
                                                mask)
        xn = self.norm_mha(x)
        x = x + self.self_attn(xn, xn, xn, pos_emb, attn_mask) * mask
        x = x + self.conv_module(self.norm_conv(x), mask) * mask
        x = x + 0.5 * self.feed_forward(self.norm_ff(x), mask) * mask
        return self.norm_final(x) * mask


class Encoder(nn.Module):
    def __init__(self, attention_dim: int, attention_heads: int,
                 linear_units: int, num_blocks: int,
                 positionwise_conv_kernel_size: int, cnn_module_kernel: int):
        super().__init__()
        self.pos_enc = RelPositionalEncoding(attention_dim)
        self.encoders = nn.ModuleList(
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         positionwise_conv_kernel_size, cnn_module_kernel)
            for _ in range(num_blocks))
        self.after_norm = layer_norm(attention_dim)

    def forward(self, x, attn_mask, mask):
        x, pos_emb = self.pos_enc(x)
        for layer in self.encoders:
            x = layer(x, pos_emb, attn_mask, mask)
        return self.after_norm(x)


class ConformerEncoder(nn.Module):
    """The reference wrapper: square length mask, encoder, re-mask.
    [B, T, C] in and out (input width == attention_dim)."""

    def __init__(self, attention_dim: int, attention_heads: int,
                 linear_units: int, num_blocks: int,
                 positionwise_conv_kernel_size: int, cnn_module_kernel: int):
        super().__init__()
        self.encoder = Encoder(attention_dim, attention_heads, linear_units,
                               num_blocks, positionwise_conv_kernel_size,
                               cnn_module_kernel)

    def forward(self, emb, input_lens):
        """emb [B, T, C]; input_lens [B] -> [B, T, C]."""
        non_pad = sequence_mask(input_lens, emb.shape[1])
        attn_mask = non_pad[:, None, :] & non_pad[:, :, None]
        mask = non_pad[:, :, None].to(emb.dtype)
        return self.encoder(emb, attn_mask, mask) * mask
