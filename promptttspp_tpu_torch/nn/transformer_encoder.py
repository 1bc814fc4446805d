"""Plain (not conformer) transformer encoder of the ESPnet suite.

Counterpart of ``promptttspp_tpu/nn/transformer_encoder.py``: an input
layer (``conv2d``, ``conv2d6``, ``conv2d8``: a subsampler as ``embed``;
``linear``: ``embed.0`` a Linear, ``embed.1`` a LayerNorm of eps 1e-5,
dropout, ReLU, then ``pos_enc``; ``embed``: ``embed.0`` an Embedding, then
``pos_enc``; None: ``pos_enc`` alone; ``no_pos_enc``: nothing), N blocks
of [self-attention or a light/dynamic convolution (not causal)] ->
position-wise FFN (``linear``, ``conv1d``, ``conv1d-linear``), pre- or
post-norm, each residual branch added or, with ``concat_after``,
concatenated with its input through a Linear; then ``after_norm``
(pre-norm). ``forward(xs, masks)``: xs [B, T, idim] (int ids [B, T] for
``embed``), masks bool [B, 1, T] or None -> (ys, masks), subsampled where
the input layer subsamples.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.conformer import feed_forward
from promptttspp_tpu_torch.nn.decoder import pos_encoding, self_attention
from promptttspp_tpu_torch.nn.layers import (
    Dropout, LayerNorm, Linear, layer_norm)
from promptttspp_tpu_torch.nn.subsampling import (
    Conv2dSubsampling, Conv2dSubsampling6, Conv2dSubsampling8)

SUBSAMPLERS = {"conv2d": Conv2dSubsampling, "conv2d6": Conv2dSubsampling6,
               "conv2d8": Conv2dSubsampling8}
INPUT_LAYERS = (*SUBSAMPLERS, "linear", "embed", None, "no_pos_enc")


class TransformerEncoderLayer(nn.Module):
    def __init__(self, size: int, selfattention_layer_type: str,
                 attention_heads: int, attention_dropout_rate: float,
                 linear_units: int, dropout_rate: float,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1,
                 conv_wshare: int = 4, conv_kernel_length: str = "11",
                 conv_usebias: bool = False, lnum: int = 0,
                 normalize_before: bool = True, concat_after: bool = False):
        super().__init__()
        self.normalize_before, self.concat_after = (normalize_before,
                                                    concat_after)
        self.self_attn = self_attention(
            selfattention_layer_type, size, attention_heads,
            attention_dropout_rate, conv_wshare, conv_kernel_length,
            conv_usebias, lnum, causal=False)
        self.feed_forward = feed_forward(
            positionwise_layer_type, size, linear_units,
            positionwise_conv_kernel_size, dropout_rate)
        self.norm1 = layer_norm(size)
        self.norm2 = layer_norm(size)
        self.drop = Dropout(dropout_rate)
        if concat_after:
            self.concat_linear = Linear(2 * size, size)

    def forward(self, x, mask):
        pre = self.normalize_before
        residual = x
        if pre:
            x = self.norm1(x)
        sa = self.self_attn(x, x, x, mask)
        if self.concat_after:
            x = residual + self.concat_linear(torch.cat([x, sa], -1))
        else:
            x = residual + self.drop(sa)
        if not pre:
            x = self.norm1(x)
        residual = x
        if pre:
            x = self.norm2(x)
        x = residual + self.drop(self.feed_forward(x, 1.0))
        if not pre:
            x = self.norm2(x)
        return x, mask


class TransformerEncoder(nn.Module):
    """The encoder stack; the arguments and defaults are JAX's
    ``TransformerEncoder`` fields (``padding_idx`` is read by nothing, in
    JAX as here)."""

    def __init__(self, idim: int, selfattention_layer_type: str = "selfattn",
                 attention_dim: int = 256, attention_heads: int = 4,
                 conv_wshare: int = 4, conv_kernel_length: str = "11",
                 conv_usebias: bool = False, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: Optional[str] = "conv2d",
                 pos_enc_type: str = "abs", normalize_before: bool = True,
                 concat_after: bool = False,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1,
                 padding_idx: int = -1):
        super().__init__()
        if input_layer not in INPUT_LAYERS:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.input_layer = input_layer
        if input_layer in SUBSAMPLERS:
            self.embed = SUBSAMPLERS[input_layer](idim, attention_dim,
                                                  dropout_rate)
        elif input_layer == "linear":
            # torch's LayerNorm eps (1e-5), not ESPnet's 1e-12
            self.embed = nn.ModuleList([Linear(idim, attention_dim),
                                        LayerNorm(attention_dim, eps=1e-5)])
            self.embed_drop = Dropout(dropout_rate)
        elif input_layer == "embed":
            self.embed = nn.ModuleList([nn.Embedding(idim, attention_dim)])
        if input_layer in ("linear", "embed", None):
            self.pos_enc = pos_encoding(pos_enc_type, attention_dim,
                                        positional_dropout_rate)
        self.encoders = nn.ModuleList(
            TransformerEncoderLayer(
                attention_dim, selfattention_layer_type, attention_heads,
                attention_dropout_rate, linear_units, dropout_rate,
                positionwise_layer_type, positionwise_conv_kernel_size,
                conv_wshare, conv_kernel_length, conv_usebias, i,
                normalize_before, concat_after)
            for i in range(num_blocks))
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = layer_norm(attention_dim)

    def forward(self, xs, masks):
        if self.input_layer in SUBSAMPLERS:
            xs, masks = self.embed(xs, masks)
        elif self.input_layer == "linear":
            xs = torch.relu(self.embed_drop(self.embed[1](self.embed[0](xs))))
            xs = self.pos_enc(xs)
        elif self.input_layer == "embed":
            xs = self.pos_enc(self.embed[0](xs))
        elif self.input_layer is None:
            xs = self.pos_enc(xs)
        for layer in self.encoders:
            xs, masks = layer(xs, masks)
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs, masks
