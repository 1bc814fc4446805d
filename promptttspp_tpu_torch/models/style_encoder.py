"""Global style token (GST) encoder.

Counterpart of ``promptttspp_tpu/models/style_encoder.py``: mel
[B, Tf, idim] -> 6 x (Conv2d k3 s2 + ``WeightedBatchNorm`` (running
statistics in eval; in train the batch's, rows of ``row_weight`` 0 left
out) + ReLU) over (time, mel) -> [B, Tf', C * idim'] (channel-major flatten, as the
reference's transpose of NCHW) -> GRU, final hidden state at each row's
last valid step, lengths ceil(len / stride^layers) and at least 1 -> 10
learned tokens under multi-head cross-attention -> style [B, 1, C].

Names follow the reference's torch ``state_dict``: ``ref_enc.convs.{3i}``
(Conv2d, no bias), ``ref_enc.convs.{3i+1}`` (BatchNorm2d), ``ref_enc.gru``,
``stl.gst_embs``, ``stl.mha.linear_{q,k,v,out}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.attention import GSTCrossAttention
from promptttspp_tpu_torch.nn.gru import GRU
from promptttspp_tpu_torch.nn.layers import WeightedBatchNorm


class ReferenceEncoder(nn.Module):
    def __init__(self, idim: int = 80, conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        if conv_kernel_size % 2 != 1 or len(conv_chans_list) != conv_layers:
            raise ValueError("odd conv_kernel_size and one channel count "
                             "per conv layer are required")
        pad = (conv_kernel_size - 1) // 2
        layers, cin = [], 1
        for cout in conv_chans_list:
            layers += [nn.Conv2d(cin, cout, conv_kernel_size, conv_stride,
                                 pad, bias=False),
                       WeightedBatchNorm(cout, eps=1e-5), nn.ReLU()]
            cin = cout
        self.convs = nn.Sequential(*layers)
        self.stride_total = conv_stride ** conv_layers
        gru_in = idim
        for _ in range(conv_layers):
            gru_in = (gru_in - conv_kernel_size + 2 * pad) // conv_stride + 1
        self.gru = GRU(gru_in * conv_chans_list[-1], gru_units, gru_layers)

    def forward(self, speech, in_lens=None, row_weight=None):
        """speech [B, Tf, idim] -> [B, gru_units]."""
        h = speech[:, None]
        for i in range(0, len(self.convs), 3):
            conv, norm, relu = self.convs[i:i + 3]
            h = relu(norm(conv(h), row_weight))  # -> [B, C, Tf', idim']
        B, _, Tr, _ = h.shape
        h = h.transpose(1, 2).reshape(B, Tr, -1)  # [B, Tf', C * idim']
        hs_lens = None
        if in_lens is not None:
            hs_lens = torch.clamp(torch.ceil(
                in_lens.to(torch.float32) / self.stride_total), min=1)
        return self.gru(h, hs_lens)


class StyleTokenLayer(nn.Module):
    """Learned token bank (tanh) under multi-head cross-attention."""

    def __init__(self, ref_embed_dim: int = 128, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4):
        super().__init__()
        self.gst_embs = nn.Parameter(
            torch.randn(gst_tokens, gst_token_dim // gst_heads))
        self.mha = GSTCrossAttention(gst_heads, ref_embed_dim,
                                     gst_token_dim // gst_heads,
                                     gst_token_dim)

    def forward(self, ref_embs):
        """[B, ref_embed_dim] -> [B, gst_token_dim]."""
        tokens = torch.tanh(self.gst_embs)[None].expand(
            ref_embs.shape[0], -1, -1)
        return self.mha(ref_embs[:, None, :], tokens)[:, 0, :]


class StyleEncoder(nn.Module):
    """mel [B, Tf, idim] (+ lengths) -> style [B, 1, gst_token_dim]."""

    def __init__(self, idim: int = 80, gst_tokens: int = 10,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 conv_layers: int = 6,
                 conv_chans_list: Sequence[int] = (32, 32, 64, 64, 128, 128),
                 conv_kernel_size: int = 3, conv_stride: int = 2,
                 gru_layers: int = 1, gru_units: int = 128):
        super().__init__()
        self.ref_enc = ReferenceEncoder(idim, conv_layers, conv_chans_list,
                                        conv_kernel_size, conv_stride,
                                        gru_layers, gru_units)
        self.stl = StyleTokenLayer(gru_units, gst_tokens, gst_token_dim,
                                   gst_heads)

    def forward(self, speech, in_lens=None, row_weight=None):
        return self.stl(self.ref_enc(speech, in_lens,
                                     row_weight))[:, None, :]
