"""Sinusoidal positional encodings (eval mode: no dropout).

Counterpart of ``promptttspp_tpu/nn/embedding.py``: the absolute encoding
the frame prior uses and the 'new' relative encoding of the conformer.
Tables are numpy float32 constants, as in the JAX package, copied to the
input's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn


def _div_term(d_model: int) -> np.ndarray:
    return np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                  * -(math.log(10000.0) / d_model))


@functools.lru_cache(maxsize=32)
def sinusoid_table(length: int, d_model: int) -> np.ndarray:
    """[length, d_model]: sin on even dims, cos on odd."""
    position = np.arange(0, length, dtype=np.float32)[:, None]
    div_term = _div_term(d_model)
    pe = np.zeros((length, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=32)
def rel_sinusoid_table(length: int, d_model: int) -> np.ndarray:
    """[2*length-1, d_model]: relative positions length-1 ... -(length-1)."""
    position = np.arange(0, length, dtype=np.float32)[:, None]
    div_term = _div_term(d_model)
    pos = np.zeros((length, d_model), dtype=np.float32)
    neg = np.zeros((length, d_model), dtype=np.float32)
    pos[:, 0::2] = np.sin(position * div_term)
    pos[:, 1::2] = np.cos(position * div_term)
    neg[:, 0::2] = np.sin(-position * div_term)
    neg[:, 1::2] = np.cos(-position * div_term)
    return np.concatenate([pos[::-1], neg[1:]], axis=0)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x):
        pe = torch.as_tensor(sinusoid_table(x.shape[1], self.d_model),
                             device=x.device)
        return x * math.sqrt(self.d_model) + pe[None]


class RelPositionalEncoding(nn.Module):
    """'New' relative PE: (x * sqrt(d), pos_emb [1, 2T-1, d])."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x):
        pos_emb = torch.as_tensor(
            rel_sinusoid_table(x.shape[1], self.d_model), device=x.device)
        return x * math.sqrt(self.d_model), pos_emb[None]
