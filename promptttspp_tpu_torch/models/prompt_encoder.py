"""Prompt encoder: BERT CLS vector -> MLP adaptor -> style space.

Counterpart of ``promptttspp_tpu/models/prompt_encoder.py::PromptEncoder``.
Prompts arrive tokenized ([B, L] ids + mask). Names follow the reference's
``state_dict``: ``bert.model.<HF BertModel>`` and ``adaptor.0/2/4`` (ReLUs at
1 and 3), i.e. 768 -> 512 -> 512 -> 256 in the flagship.
"""

from __future__ import annotations

import torch.nn as nn

from promptttspp_tpu_torch.models.bert import BertConfig, BertModel


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
            nn.Linear(bert_config.hidden_size, mid_channels), nn.ReLU(),
            nn.Linear(mid_channels, mid_channels), nn.ReLU(),
            nn.Linear(mid_channels, out_channels))

    def forward(self, input_ids, attention_mask):
        """[B, L] ids + mask -> [B, 1, out_channels]."""
        hidden = self.bert.model(input_ids, attention_mask)
        return self.adaptor(hidden[:, 0, :])[:, None, :]
