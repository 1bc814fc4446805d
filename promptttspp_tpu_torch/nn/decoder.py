"""Transformer decoder of the ESPnet suite.

Counterpart of ``promptttspp_tpu/nn/decoder.py``: an input layer (token
``embed``: ``embed.0`` an Embedding; or ``linear``: ``embed.0`` a Linear,
``embed.1`` a LayerNorm of eps 1e-5, dropout, ReLU), the absolute or
scaled positional encoding (``pos_enc``), N blocks of [self-attention
(``selfattn``) or a causal light/dynamic convolution (``lightconv``,
``lightconv2d``, ``dynamicconv``, ``dynamicconv2d``)] -> source attention
over the memory -> Linear FFN, pre- or post-norm, each residual branch
added or, with ``concat_after``, concatenated with its input through a
Linear; then ``after_norm`` (pre-norm) and the output Linear.

``forward_one_step`` is the incremental step: every block keeps its
output as the next step's cache and computes only the last position's
query; it re-embeds the whole prefix, as the reference does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.attention import MultiHeadedAttention
from promptttspp_tpu_torch.nn.conformer import PositionwiseFeedForward
from promptttspp_tpu_torch.nn.embedding import (
    PositionalEncoding, ScaledPositionalEncoding)
from promptttspp_tpu_torch.nn.layers import (
    Dropout, LayerNorm, Linear, layer_norm)
from promptttspp_tpu_torch.nn.lightconv import (
    DynamicConvolution, LightweightConvolution)
from promptttspp_tpu_torch.nn.lightconv2d import (
    DynamicConvolution2D, LightweightConvolution2D)

CONV_ATTENTIONS = {
    "lightconv": LightweightConvolution,
    "lightconv2d": LightweightConvolution2D,
    "dynamicconv": DynamicConvolution,
    "dynamicconv2d": DynamicConvolution2D,
}
POS_ENCODINGS = {"abs": PositionalEncoding,
                 "scaled": ScaledPositionalEncoding}


def self_attention(kind: str, size: int, heads: int, dropout_rate: float,
                   conv_wshare: int, conv_kernel_length: str,
                   conv_usebias: bool, lnum: int, causal: bool) -> nn.Module:
    """The self-attention of a block: ``selfattn`` or a convolution of
    ``CONV_ATTENTIONS`` (``causal``: its kernel sees no future step)."""
    if kind == "selfattn":
        return MultiHeadedAttention(heads, size, dropout_rate)
    if kind not in CONV_ATTENTIONS:
        raise ValueError(f"selfattention_layer_type {kind!r}: selfattn or "
                         f"one of {tuple(CONV_ATTENTIONS)}")
    return CONV_ATTENTIONS[kind](
        conv_wshare, size, dropout_rate, kernel_size_str=conv_kernel_length,
        lnum=lnum, use_kernel_mask=causal, use_bias=conv_usebias)


def pos_encoding(kind: str, dim: int, dropout_rate: float) -> nn.Module:
    """The absolute (``abs``) or scaled positional encoding."""
    if kind not in POS_ENCODINGS:
        raise ValueError(f"pos_enc_type {kind!r}: one of "
                         f"{tuple(POS_ENCODINGS)}")
    return POS_ENCODINGS[kind](dim, dropout_rate)


class DecoderLayer(nn.Module):
    def __init__(self, size: int, selfattention_layer_type: str,
                 attention_heads: int, self_attention_dropout_rate: float,
                 src_attention_dropout_rate: float, linear_units: int,
                 dropout_rate: float, conv_wshare: int = 4,
                 conv_kernel_length: str = "11", conv_usebias: bool = False,
                 lnum: int = 0, normalize_before: bool = True,
                 concat_after: bool = False):
        super().__init__()
        self.size = size
        self.normalize_before, self.concat_after = (normalize_before,
                                                    concat_after)
        self.self_attn = self_attention(
            selfattention_layer_type, size, attention_heads,
            self_attention_dropout_rate, conv_wshare, conv_kernel_length,
            conv_usebias, lnum, causal=True)
        self.src_attn = MultiHeadedAttention(attention_heads, size,
                                             src_attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = layer_norm(size)
        self.norm2 = layer_norm(size)
        self.norm3 = layer_norm(size)
        self.drop = Dropout(dropout_rate)
        if concat_after:
            self.concat_linear1 = Linear(2 * size, size)
            self.concat_linear2 = Linear(2 * size, size)

    def forward(self, tgt, tgt_mask, memory, memory_mask, cache=None):
        """tgt [B, L, C]; tgt_mask bool [B, L, L] or None; memory
        [B, T, C]; memory_mask bool [B, 1, T] or None; cache [B, L-1, C]
        or None -> (out [B, L, C], tgt_mask, memory, memory_mask)."""
        pre = self.normalize_before
        residual = tgt
        x = self.norm1(tgt) if pre else tgt
        tgt_q, tgt_q_mask = x, tgt_mask
        if cache is not None:
            want = (tgt.shape[0], tgt.shape[1] - 1, self.size)
            if tuple(cache.shape) != want:
                raise ValueError(f"cache shape {tuple(cache.shape)} != "
                                 f"{want}")
            tgt_q, residual = x[:, -1:], residual[:, -1:]
            tgt_q_mask = None if tgt_mask is None else tgt_mask[:, -1:]
        sa = self.self_attn(tgt_q, x, x, tgt_q_mask)
        if self.concat_after:
            y = residual + self.concat_linear1(torch.cat([tgt_q, sa], -1))
        else:
            y = residual + self.drop(sa)
        if not pre:
            y = self.norm1(y)

        residual = y
        x = self.norm2(y) if pre else y
        ca = self.src_attn(x, memory, memory, memory_mask)
        if self.concat_after:
            y = residual + self.concat_linear2(torch.cat([x, ca], -1))
        else:
            y = residual + self.drop(ca)
        if not pre:
            y = self.norm2(y)

        residual = y
        x = self.norm3(y) if pre else y
        y = residual + self.drop(self.feed_forward(x, 1.0))
        if not pre:
            y = self.norm3(y)
        if cache is not None:
            y = torch.cat([cache, y], dim=1)
        return y, tgt_mask, memory, memory_mask


class Decoder(nn.Module):
    """The decoder stack; the arguments and defaults are JAX's
    ``Decoder`` fields."""

    def __init__(self, odim: int, selfattention_layer_type: str = "selfattn",
                 attention_dim: int = 256, attention_heads: int = 4,
                 conv_wshare: int = 4, conv_kernel_length: str = "11",
                 conv_usebias: bool = False, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 input_layer: str = "embed", use_output_layer: bool = True,
                 pos_enc_type: str = "abs", normalize_before: bool = True,
                 concat_after: bool = False):
        super().__init__()
        if input_layer == "embed":
            self.embed = nn.ModuleList([nn.Embedding(odim, attention_dim)])
        elif input_layer == "linear":
            # torch's LayerNorm eps (1e-5), not ESPnet's 1e-12
            self.embed = nn.ModuleList([Linear(odim, attention_dim),
                                        LayerNorm(attention_dim, eps=1e-5)])
            self.embed_drop = Dropout(dropout_rate)
        else:
            raise ValueError(f"input_layer {input_layer!r}: embed or linear")
        self.input_layer = input_layer
        self.pos_enc = pos_encoding(pos_enc_type, attention_dim,
                                    positional_dropout_rate)
        self.decoders = nn.ModuleList(
            DecoderLayer(attention_dim, selfattention_layer_type,
                         attention_heads, self_attention_dropout_rate,
                         src_attention_dropout_rate, linear_units,
                         dropout_rate, conv_wshare, conv_kernel_length,
                         conv_usebias, i, normalize_before, concat_after)
            for i in range(num_blocks))
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = layer_norm(attention_dim)
        self.output_layer = (Linear(attention_dim, odim) if use_output_layer
                             else None)

    def _embed(self, tgt):
        x = self.embed[0](tgt)
        if self.input_layer == "linear":
            x = torch.relu(self.embed_drop(self.embed[1](x)))
        return self.pos_enc(x)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt int ids [B, L] (or [B, L, odim] for the linear input);
        tgt_mask bool [B, L, L] (``ops/masks.py::target_mask``); memory
        [B, T, D]; memory_mask bool [B, 1, T] -> (scores [B, L, odim],
        tgt_mask)."""
        x = self._embed(tgt)
        for layer in self.decoders:
            x, tgt_mask, memory, memory_mask = layer(x, tgt_mask, memory,
                                                     memory_mask)
        if self.normalize_before:
            x = self.after_norm(x)
        if self.output_layer is not None:
            x = self.output_layer(x)
        return x, tgt_mask

    def forward_one_step(self, tgt, tgt_mask, memory, memory_mask=None,
                         cache: Optional[Sequence[torch.Tensor]] = None):
        """The prefix ``tgt`` [B, L] -> (log-softmax scores of its last
        position [B, odim], the blocks' outputs as the next cache)."""
        x = self._embed(tgt)
        if cache is None:
            cache = [None] * len(self.decoders)
        new_cache = []
        for c, layer in zip(cache, self.decoders):
            x, tgt_mask, memory, memory_mask = layer(x, tgt_mask, memory,
                                                     memory_mask, cache=c)
            new_cache.append(x)
        y = self.after_norm(x[:, -1]) if self.normalize_before else x[:, -1]
        if self.output_layer is not None:
            y = torch.log_softmax(self.output_layer(y), dim=-1)
        return y, new_cache
