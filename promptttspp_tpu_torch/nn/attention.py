"""Relative-position multi-head attention ('new' 2T-1 variant and the
legacy T variant) and the GST token cross-attention, with dropout on the
attention weights in train mode.

Counterpart of ``promptttspp_tpu/nn/attention.py``
(``RelPositionMultiHeadedAttention``,
``LegacyRelPositionMultiHeadedAttention``, ``GSTCrossAttention``). The
relative-position attention takes Transformer-XL scores
``(q + u) k^T + rel_shift((q + v) p^T)`` over sqrt(d_k), masked with the
dtype's minimum and re-zeroed so fully padded rows give zeros, not NaNs. Masks are boolean [B, Tq, Tk] (True = attend).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Dropout


def masked_softmax(scores, mask):
    """scores [B, H, Tq, Tk]; mask bool [B, Tq|1, Tk] or None."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    m = mask[:, None]
    scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)


def rel_shift(x):
    """[B, H, T, 2T-1] -> [B, H, T, T] (relative positions 0 .. -(T-1))."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, P + 1, T)
    return x[:, :, 1:].reshape(B, H, T, P)[..., : P // 2 + 1]


def rel_shift_legacy(x):
    """[B, H, T, T] legacy shift: pad one zero column, view as [T+1, T],
    drop the first row."""
    B, H, T1, T2 = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, T2 + 1, T1)
    return x[:, :, 1:].reshape(B, H, T1, T2)


class RelPositionMultiHeadedAttention(nn.Module):
    """'New' variant: ``pos_emb`` [1, 2T-1, C], ``rel_shift``."""

    shift = staticmethod(rel_shift)

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        assert n_feat % n_head == 0
        self.h, self.d_k = n_head, n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)
        self.attn_dropout = Dropout(dropout_rate)

    def _split(self, x):
        return x.reshape(x.shape[0], -1, self.h, self.d_k).transpose(1, 2)

    def forward(self, query, key, value, pos_emb, mask=None):
        q = self._split(self.linear_q(query))  # [B, H, T, d_k]
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        p = self._split(self.linear_pos(pos_emb))  # [1, H, 2T-1 or T, d_k]
        q_u = q + self.pos_bias_u[None, :, None, :]
        q_v = q + self.pos_bias_v[None, :, None, :]
        matrix_ac = q_u @ k.transpose(-1, -2)
        matrix_bd = self.shift(q_v @ p.transpose(-1, -2))
        scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k)
        x = self.attn_dropout(masked_softmax(scores, mask)) @ v
        x = x.transpose(1, 2).reshape(x.shape[0], -1, self.h * self.d_k)
        return self.linear_out(x)


class LegacyRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """Legacy variant: ``pos_emb`` [1, T, C], ``rel_shift_legacy``; the
    same parameters and names as the 'new' variant."""

    shift = staticmethod(rel_shift_legacy)


class GSTCrossAttention(nn.Module):
    """GST token cross-attention (counterpart of
    ``promptttspp_tpu/nn/attention.py::GSTCrossAttention``): distinct query
    and key/value input widths, and the reference's scale 1/sqrt(d_k * h)
    (not 1/sqrt(d_k))."""

    def __init__(self, n_head: int, q_dim: int, kv_dim: int, n_feat: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.d_k = n_head, n_feat // n_head
        self.linear_q = nn.Linear(q_dim, n_feat)
        self.linear_k = nn.Linear(kv_dim, n_feat)
        self.linear_v = nn.Linear(kv_dim, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.dropout = Dropout(dropout_rate)

    def _split(self, x):
        return x.reshape(x.shape[0], -1, self.h, self.d_k).transpose(1, 2)

    def forward(self, ref_emb, gst_emb):
        """ref_emb [B, 1, q_dim]; gst_emb [B, n_tokens, kv_dim]
        -> [B, 1, n_feat]."""
        q = self._split(self.linear_q(ref_emb))
        k = self._split(self.linear_k(gst_emb))
        v = self._split(self.linear_v(gst_emb))
        score = self.dropout(torch.softmax(q @ k.transpose(-1, -2)
                                           / math.sqrt(self.d_k * self.h),
                                           dim=-1))
        o = (score @ v).transpose(1, 2).reshape(ref_emb.shape[0], 1, -1)
        return self.linear_out(o)
