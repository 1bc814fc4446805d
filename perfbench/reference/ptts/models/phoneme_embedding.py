"""Phoneme embedding: [B, Tp] ids -> [B, Tp, C] masked rows.

Counterpart of ``promptttspp_tpu/models/phoneme_embedding.py``
(``PhonemeEmbedding``, ``PhonemeEmbedding2``).
"""

from __future__ import annotations

import math

import torch.nn as nn


class PhonemeEmbedding(nn.Module):
    """``do_scale`` (JAX's default) multiplies the rows by sqrt(C); the
    flagship config turns it off."""

    def __init__(self, num_vocab: int, channels: int, do_scale: bool = True):
        super().__init__()
        self.emb = nn.Embedding(num_vocab, channels)
        self.scale = math.sqrt(channels) if do_scale else None

    def forward(self, ids, mask):
        """ids [B, Tp]; mask float [B, Tp, 1]."""
        x = self.emb(ids)
        if self.scale is not None:
            x = x * self.scale
        return x * mask


class PhonemeEmbedding2(PhonemeEmbedding):
    """The unscaled variant."""

    def __init__(self, num_vocab: int, channels: int):
        super().__init__(num_vocab, channels, do_scale=False)
