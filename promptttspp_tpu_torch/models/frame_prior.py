"""Frame prior network.

Counterpart of ``promptttspp_tpu/models/frame_prior.py`` (absolute
positional encoding): PE (dropout ``pos_enc_p_dropout``) + ChannelLayerNorm,
then n_layers of [conv k -> exact GELU -> dropout ``p_dropout`` -> residual
-> ChannelLayerNorm] over [B, Tf, C].
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.embedding import PositionalEncoding
from promptttspp_tpu_torch.nn.layers import ChannelLayerNorm, Conv1d, Dropout


class FramePriorNetwork(nn.Module):
    def __init__(self, hidden_channels: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 pos_enc_p_dropout: float = 0.0):
        super().__init__()
        self.embed = PositionalEncoding(hidden_channels, pos_enc_p_dropout)
        self.norm_emb = ChannelLayerNorm(hidden_channels)
        self.convs = nn.ModuleList(
            Conv1d(hidden_channels, hidden_channels, kernel_size)
            for _ in range(n_layers))
        self.norms = nn.ModuleList(
            ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.drop = Dropout(p_dropout)

    def forward(self, x, mask):
        """x [B, Tf, C]; mask float [B, Tf, 1]."""
        x = self.norm_emb(self.embed(x * mask))
        for conv, norm in zip(self.convs, self.norms):
            x = norm(x + self.drop(F.gelu(conv(x * mask))))
        return x * mask
