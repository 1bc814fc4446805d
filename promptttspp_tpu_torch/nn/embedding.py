"""Sinusoidal positional encodings, with dropout in train mode.

Counterpart of ``promptttspp_tpu/nn/embedding.py``: the absolute encoding
the frame prior uses and the 'new' and legacy relative encodings of the
conformer. Tables are numpy float32 constants, as in the JAX package,
copied to each device once per length (the legacy table once per device):
a copy from host memory waits for the device's queue, so a request must not
make one on every call.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.layers import Dropout


def _div_term(d_model: int) -> np.ndarray:
    return np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                  * -(math.log(10000.0) / d_model))


@functools.lru_cache(maxsize=32)
def sinusoid_table(length: int, d_model: int,
                   reverse: bool = False) -> np.ndarray:
    """[length, d_model]: sin on even dims, cos on odd; positions 0 ..
    length-1, or length-1 .. 0 with ``reverse``."""
    if reverse:
        position = np.arange(length - 1, -1, -1.0, dtype=np.float32)[:, None]
    else:
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


def legacy_rel_table(length: int, d_model: int) -> np.ndarray:
    """[length, d_model]: positions length-1 .. 0 (the legacy encoding's
    table before it is sliced)."""
    return sinusoid_table(length, d_model, reverse=True)


@functools.lru_cache(maxsize=32)
def _device_table(table, length: int, d_model: int, device: torch.device):
    # a plain (not inference-mode) tensor, so a later autograd use may
    # read it
    with torch.inference_mode(False):
        return torch.as_tensor(table(length, d_model), device=device)


class PositionalEncoding(nn.Module):
    """dropout(x * sqrt(d) + PE)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        pe = _device_table(sinusoid_table, x.shape[1], self.d_model,
                           x.device)
        return self.dropout(x * math.sqrt(self.d_model) + pe[None])


class RelPositionalEncoding(nn.Module):
    """'New' relative PE: (dropout(x * sqrt(d)), dropout(pos_emb
    [1, 2T-1, d])), two draws."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        pos_emb = _device_table(rel_sinusoid_table, x.shape[1],
                                self.d_model, x.device)
        return (self.dropout(x * math.sqrt(self.d_model)),
                self.dropout(pos_emb[None]))


class LegacyRelPositionalEncoding(nn.Module):
    """Legacy relative PE: (x * sqrt(d), pos_emb [1, T, d]). ``pos_emb`` is
    the first T rows of the reversed ``max_len`` table, positions
    max_len-1 .. max_len-T (not T-1 .. 0): the reference grows its table
    only when T exceeds ``max_len``, and the JAX package keeps that quirk.
    One table of ``max(max_len, T)`` rows per device, sliced per call.
    Dropout as in the 'new' variant."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0,
                 max_len: int = 5000):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        T = x.shape[1]
        table = _device_table(legacy_rel_table, max(self.max_len, T),
                              self.d_model, x.device)
        return (self.dropout(x * math.sqrt(self.d_model)),
                self.dropout(table[None, :T]))
