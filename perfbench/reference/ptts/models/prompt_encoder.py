"""Prompt encoder: BERT CLS vector -> MLP adaptor -> style space.

Counterpart of ``promptttspp_tpu/models/prompt_encoder.py``
(``PromptEncoder``, ``SepPromptEncoder``). Prompts arrive tokenized ([B, L] ids + mask). Names follow the reference's
``state_dict``: ``bert.model.<HF BertModel>`` and ``adaptor.0/2/4`` (ReLUs at
1 and 3), i.e. 768 -> 512 -> 512 -> 256 in the flagship.
"""

from __future__ import annotations

import torch.nn as nn

from perfbench.reference.ptts.models.bert import BertConfig, BertModel
from perfbench.reference.ptts.nn.layers import Linear


class _BertHolder(nn.Module):
    """The reference wraps the HF model as ``bert.model``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.model = BertModel(cfg)


class PromptEncoder(nn.Module):
    def __init__(self, bert_config: BertConfig, mid_channels: int = 512,
                 out_channels: int = 256):
        super().__init__()
        self.bert = _BertHolder(bert_config)
        self.adaptor = nn.Sequential(
            Linear(bert_config.hidden_size, mid_channels), nn.ReLU(),
            Linear(mid_channels, mid_channels), nn.ReLU(),
            Linear(mid_channels, out_channels))

    def forward(self, input_ids, attention_mask):
        """[B, L] ids + mask -> [B, 1, out_channels]."""
        hidden = self.bert.model(input_ids, attention_mask)
        return self.adaptor(hidden[:, 0, :])[:, None, :]


class SepPromptEncoder(nn.Module):
    """Two prompt encoders, ``style_enc`` and ``spk_enc``, over the style
    and speaker halves of a prompt (split on '|' and tokenized apart by
    the caller); their embeddings add up. No model path builds it, in JAX
    as here."""

    def __init__(self, bert_config: BertConfig, mid_channels: int = 512,
                 out_channels: int = 256):
        super().__init__()
        self.style_enc = PromptEncoder(bert_config, mid_channels,
                                       out_channels)
        self.spk_enc = PromptEncoder(bert_config, mid_channels, out_channels)

    def forward(self, style_ids, style_mask, spk_ids, spk_mask):
        """-> [B, 1, out_channels]."""
        return (self.style_enc(style_ids, style_mask)
                + self.spk_enc(spk_ids, spk_mask))

    def infer(self, style_ids, style_mask, spk_ids, spk_mask):
        """-> (the sum, the style half's, the speaker half's)."""
        x1 = self.style_enc(style_ids, style_mask)
        x2 = self.spk_enc(spk_ids, spk_mask)
        return x1 + x2, x1, x2
