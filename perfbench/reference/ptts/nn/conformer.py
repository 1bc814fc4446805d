"""Conformer encoder stack.

Counterpart of ``promptttspp_tpu/nn/conformer.py`` with every option of
JAX's ``EncoderLayer``, ``Encoder`` and ``ConformerEncoder``:

- position-wise FFN ``linear`` (Linear -> ReLU -> Linear), ``conv1d``
  (FastSpeech's two convolutions) or ``conv1d-linear``;
- self-attention ``selfattn`` (plain), ``rel_selfattn`` ('new' 2T-1
  relative positions) or ``legacy_rel_selfattn``, with the positional
  encoding ``abs_pos``, ``scaled_abs_pos``, ``rel_pos`` or
  ``legacy_rel_pos``; ``ConformerEncoder``'s ``rel_pos_type`` (None means
  legacy, as in JAX) picks the relative variant;
- macaron style (0.5 x FFN before attention) and the conv module
  (pointwise + GLU, depthwise k, ``WeightedBatchNorm``, swish,
  pointwise), each on or off;
- an input ``Linear`` (``embed_linear``) where ``idim != attention_dim``;
- ``mid_out`` (every block's output), ``return_mask``, and a block's
  one-frame streaming ``cache``.

As in JAX, every block is pre-norm whatever ``normalize_before`` says; it
only decides the encoder's ``after_norm``. LayerNorm eps is 1e-12, and the
mask multiplies sit where the reference's do. In train mode the BatchNorm
uses the batch statistics of the rows whose ``row_weight`` is not 0
(padded time steps of those rows included, as in the reference), and
dropout applies where JAX's does: the positional encoding
(``positional_dropout_rate``), the attention weights
(``attention_dropout_rate``), inside the FFNs and on each residual branch
(``dropout_rate``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from perfbench.reference.ptts.nn.attention import (
    LegacyRelPositionMultiHeadedAttention, MultiHeadedAttention,
    RelPositionMultiHeadedAttention)
from perfbench.reference.ptts.nn.embedding import (
    LegacyRelPositionalEncoding, PositionalEncoding, RelPositionalEncoding,
    ScaledPositionalEncoding)
from perfbench.reference.ptts.nn.layers import (
    Conv1d, Dropout, Linear, WeightedBatchNorm, layer_norm, swish)
from perfbench.reference.ptts.ops.masks import sequence_mask

ATTENTIONS = {"selfattn": MultiHeadedAttention,
              "rel_selfattn": RelPositionMultiHeadedAttention,
              "legacy_rel_selfattn": LegacyRelPositionMultiHeadedAttention}
POS_ENCODINGS = {"abs_pos": PositionalEncoding,
                 "scaled_abs_pos": ScaledPositionalEncoding,
                 "rel_pos": RelPositionalEncoding,
                 "legacy_rel_pos": LegacyRelPositionalEncoding}
# the attention each relative encoding needs (JAX asserts it)
_REL_ATTENTION = {"rel_pos": "rel_selfattn",
                  "legacy_rel_pos": "legacy_rel_selfattn"}


def rel_pos_variant(rel_pos_type):
    """JAX's reading of ``rel_pos_type``: None or "legacy" -> "legacy",
    "new" -> "new", anything else raises."""
    if rel_pos_type is None or rel_pos_type == "legacy":
        return "legacy"
    if rel_pos_type != "new":
        raise ValueError(f"Unknown rel_pos_type: {rel_pos_type}")
    return "new"


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     groups=channels)
        self.norm = WeightedBatchNorm(channels, eps=1e-5)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def forward(self, x, mask, row_weight=None):
        """x [B, T, C]; mask float [B, T, 1]; row_weight [B] or None."""
        x = self.pointwise_conv1(x) * mask
        a, b = x.chunk(2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(b)) * mask
        x = self.norm(x.transpose(1, 2), row_weight).transpose(1, 2)
        return self.pointwise_conv2(swish(x)) * mask


class MultiLayeredConv1d(nn.Module):
    """FastSpeech conv1d FFN."""

    def __init__(self, in_chans: int, hidden_chans: int, kernel_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Conv1d(in_chans, hidden_chans, kernel_size)
        self.w_2 = Conv1d(hidden_chans, in_chans, kernel_size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask):
        x = torch.relu(self.w_1(x * mask)) * mask
        return self.w_2(self.dropout(x)) * mask


class Conv1dLinear(MultiLayeredConv1d):
    """Conv1d expansion, Linear contraction."""

    def __init__(self, in_chans: int, hidden_chans: int, kernel_size: int,
                 dropout_rate: float = 0.0):
        super().__init__(in_chans, hidden_chans, kernel_size, dropout_rate)
        self.w_2 = Linear(hidden_chans, in_chans)


class PositionwiseFeedForward(nn.Module):
    """Linear -> ReLU -> dropout -> Linear, masked as JAX masks it."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Linear(idim, hidden_units)
        self.w_2 = Linear(hidden_units, idim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask):
        x = torch.relu(self.w_1(x) * mask)
        return self.w_2(self.dropout(x)) * mask


def feed_forward(kind: str, size: int, hidden: int, kernel_size: int,
                 dropout_rate: float) -> nn.Module:
    """The position-wise FFN of ``positionwise_layer_type`` ``kind``."""
    if kind == "linear":
        return PositionwiseFeedForward(size, hidden, dropout_rate)
    if kind == "conv1d":
        return MultiLayeredConv1d(size, hidden, kernel_size, dropout_rate)
    if kind == "conv1d-linear":
        return Conv1dLinear(size, hidden, kernel_size, dropout_rate)
    raise ValueError(f"positionwise_layer_type {kind!r}: one of linear, "
                     "conv1d, conv1d-linear")


def _choice(table, kind: str, what: str):
    if kind not in table:
        raise ValueError(f"{what} {kind!r}: one of {tuple(table)}")
    return table[kind]


class EncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 positionwise_conv_kernel_size: int = 1,
                 cnn_module_kernel: int = 31,
                 selfattention_layer_type: str = "rel_selfattn",
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 positionwise_layer_type: str = "conv1d",
                 macaron_style: bool = True, use_cnn_module: bool = True):
        super().__init__()
        self.size = size
        self.macaron_style, self.use_cnn_module = macaron_style, use_cnn_module
        self.self_attn = _choice(ATTENTIONS, selfattention_layer_type,
                                 "selfattention_layer_type")(
            attention_heads, size, attention_dropout_rate)
        self.uses_pos_emb = selfattention_layer_type != "selfattn"
        ff = lambda: feed_forward(  # noqa: E731
            positionwise_layer_type, size, linear_units,
            positionwise_conv_kernel_size, dropout_rate)
        self.feed_forward = ff()
        if macaron_style:
            self.feed_forward_macaron = ff()
        if use_cnn_module:
            self.conv_module = ConvolutionModule(size, cnn_module_kernel)
        self.norm_ff = layer_norm(size)
        self.norm_mha = layer_norm(size)
        if macaron_style:
            self.norm_ff_macaron = layer_norm(size)
        if use_cnn_module:
            self.norm_conv = layer_norm(size)
            self.norm_final = layer_norm(size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, pos_emb, attn_mask, mask, row_weight=None,
                cache=None):
        """x [B,T,C]; pos_emb [1,2T-1,C] ('new'), [1,T,C] (legacy) or None
        (plain attention); attn_mask bool [B,T,T]; mask float [B,T,1];
        row_weight [B] or None (the conv module's BatchNorm).

        ``cache`` [B,T-1,C] (a streaming step): the attention queries only
        the last frame (keys and values over all of x), the modules after
        it run on that frame, and the cache is put back in front of it,
        giving [B,T,C]. The caller passes a one-frame mask (mask [B,1,1],
        attn_mask [B,1,T]), as the reference's contract says."""
        drop = self.dropout
        ff_scale = 0.5 if self.macaron_style else 1.0
        x = x * mask
        if self.macaron_style:
            x = x + ff_scale * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), mask))
        residual = x
        xn = self.norm_mha(x)
        x_q = xn
        if cache is not None:
            want = (x.shape[0], x.shape[1] - 1, self.size)
            if tuple(cache.shape) != want:
                raise ValueError(f"cache shape {tuple(cache.shape)} != "
                                 f"{want}")
            x_q, residual = xn[:, -1:], residual[:, -1:]
        if self.uses_pos_emb:
            att = self.self_attn(x_q, xn, xn, pos_emb, attn_mask)
        else:
            att = self.self_attn(x_q, xn, xn, attn_mask)
        x = residual + drop(att * mask)
        if self.use_cnn_module:
            x = x + drop(self.conv_module(self.norm_conv(x), mask,
                                          row_weight)) * mask
        x = x + ff_scale * drop(self.feed_forward(self.norm_ff(x),
                                                  mask)) * mask
        if self.use_cnn_module:
            x = self.norm_final(x) * mask
        if cache is not None:
            x = torch.cat([cache, x], dim=1)
        return x


class Encoder(nn.Module):
    """The conformer stack. ``input_layer`` None (``idim`` must then be
    ``attention_dim``) or "linear" (``embed_linear``); ``mid_out``
    returns every block's output, each through ``after_norm`` where
    ``normalize_before`` keeps it."""

    def __init__(self, idim: int, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: Optional[str] = None,
                 normalize_before: bool = True,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1,
                 macaron_style: bool = False,
                 pos_enc_layer_type: str = "abs_pos",
                 selfattention_layer_type: str = "selfattn",
                 use_cnn_module: bool = False, cnn_module_kernel: int = 31,
                 mid_out: bool = False):
        super().__init__()
        pos_enc = _choice(POS_ENCODINGS, pos_enc_layer_type,
                          "pos_enc_layer_type")
        _choice(ATTENTIONS, selfattention_layer_type,
                "selfattention_layer_type")
        rel = _REL_ATTENTION.get(pos_enc_layer_type)
        if rel is not None and selfattention_layer_type != rel:
            raise ValueError(f"pos_enc_layer_type {pos_enc_layer_type!r} "
                             f"needs selfattention_layer_type {rel!r}, not "
                             f"{selfattention_layer_type!r}")
        self.pos_enc = pos_enc(attention_dim, positional_dropout_rate)
        self.rel_pos = rel is not None
        if input_layer == "linear":
            self.embed_linear = Linear(idim, attention_dim)
        elif input_layer is not None:
            raise ValueError(f"input_layer {input_layer} not supported")
        elif idim != attention_dim:
            raise ValueError(f"idim {idim} != attention_dim {attention_dim} "
                             "needs input_layer='linear'")
        self.input_layer = input_layer
        self.encoders = nn.ModuleList(
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         positionwise_conv_kernel_size, cnn_module_kernel,
                         selfattention_layer_type, dropout_rate,
                         attention_dropout_rate, positionwise_layer_type,
                         macaron_style, use_cnn_module)
            for _ in range(num_blocks))
        self.normalize_before, self.mid_out = normalize_before, mid_out
        if normalize_before:
            self.after_norm = layer_norm(attention_dim)

    def forward(self, x, attn_mask, mask, row_weight=None):
        """x [B,T,idim]; attn_mask bool [B,T,T]; mask float [B,T,1] ->
        [B,T,attention_dim], or the list of every block's with
        ``mid_out``."""
        if self.input_layer == "linear":
            x = self.embed_linear(x)
        if self.rel_pos:
            x, pos_emb = self.pos_enc(x)
        else:
            x, pos_emb = self.pos_enc(x), None
        outs = []
        for layer in self.encoders:
            x = layer(x, pos_emb, attn_mask, mask, row_weight)
            outs.append(x)
        norm = self.after_norm if self.normalize_before else (lambda y: y)
        if self.mid_out:
            return [norm(o) for o in outs]
        return norm(x)


class ConformerEncoder(nn.Module):
    """The reference wrapper: square length mask, encoder, re-mask.
    [B, T, idim] in, [B, T, attention_dim] out (and the float mask
    [B, T, 1] with ``return_mask``). The arguments and their defaults are
    JAX's ``ConformerEncoder`` fields; ``rel_pos_type`` None or "legacy"
    turns ``rel_pos`` / ``rel_selfattn`` into their legacy variants, "new"
    keeps them. ``activation_type`` is read by nothing, in JAX as here:
    the conv module's activation is swish."""

    def __init__(self, idim: int = 8, attention_dim: int = 8,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True,
                 positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1,
                 macaron_style: bool = False,
                 pos_enc_layer_type: str = "abs_pos",
                 selfattention_layer_type: str = "selfattn",
                 activation_type: str = "swish",
                 use_cnn_module: bool = False, cnn_module_kernel: int = 31,
                 return_mask: bool = False, rel_pos_type=None):
        super().__init__()
        if rel_pos_variant(rel_pos_type) == "legacy":
            pos_enc_layer_type = {"rel_pos": "legacy_rel_pos"}.get(
                pos_enc_layer_type, pos_enc_layer_type)
            selfattention_layer_type = {
                "rel_selfattn": "legacy_rel_selfattn"}.get(
                selfattention_layer_type, selfattention_layer_type)
        self.return_mask = return_mask
        self.out_dim = attention_dim
        self.encoder = Encoder(
            idim, attention_dim, attention_heads, linear_units, num_blocks,
            dropout_rate, positional_dropout_rate, attention_dropout_rate,
            None if idim == attention_dim else "linear", normalize_before,
            positionwise_layer_type, positionwise_conv_kernel_size,
            macaron_style, pos_enc_layer_type, selfattention_layer_type,
            use_cnn_module, cnn_module_kernel)

    def forward(self, emb, input_lens, row_weight=None):
        """emb [B, T, idim]; input_lens [B] -> [B, T, attention_dim].
        row_weight [B] or None: rows of weight 0 stay out of the
        BatchNorm statistics."""
        non_pad = sequence_mask(input_lens, emb.shape[1])
        attn_mask = non_pad[:, None, :] & non_pad[:, :, None]
        mask = non_pad[:, :, None].to(emb.dtype)
        out = self.encoder(emb, attn_mask, mask, row_weight) * mask
        return (out, mask) if self.return_mask else out
