"""Phoneme embedding: [B, Tp] ids -> [B, Tp, C] masked rows.

Counterpart of ``promptttspp_tpu/models/phoneme_embedding.py``
(``PhonemeEmbedding``).
"""

from __future__ import annotations

import torch.nn as nn


class PhonemeEmbedding(nn.Module):
    """Unscaled (``do_scale: false`` in the flagship config)."""

    def __init__(self, num_vocab: int, channels: int):
        super().__init__()
        self.emb = nn.Embedding(num_vocab, channels)

    def forward(self, ids, mask):
        """ids [B, Tp]; mask float [B, Tp, 1]."""
        return self.emb(ids) * mask
