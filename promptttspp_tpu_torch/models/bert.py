"""BERT encoder written by hand, plus a copy of the WordPiece tokenizer.

Counterpart of ``promptttspp_tpu/models/bert.py``: last_hidden_state of a
post-LayerNorm BERT (exact GELU, LayerNorm eps 1e-12), with JAX's dropout
in train mode (``hidden_dropout`` on the embeddings and on each sublayer's
output, ``attention_dropout`` on the attention weights). Module
names follow the Hugging Face torch ``state_dict``
(``embeddings.word_embeddings``, ``encoder.layer.N.attention.self.query``,
...), so a ``bert-base-uncased`` checkpoint maps by name. The tokenizer is
host code: lowercase, strip accents, punctuation split, greedy
longest-match WordPiece.
"""

from __future__ import annotations

import dataclasses
import math
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import (
    Dropout, LayerNorm, Linear, promoted)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(pos)[None]
               + self.token_type_embeddings.weight[0])  # token type 0
        return self.dropout(self.LayerNorm(emb))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.h = cfg.num_attention_heads
        self.d = cfg.hidden_size // cfg.num_attention_heads
        self.query = Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_dropout)

    def forward(self, hidden, bias):
        B, T, _ = hidden.shape
        split = lambda x: x.reshape(B, T, self.h, self.d).transpose(1, 2)
        q = split(self.query(hidden))
        k = split(self.key(hidden))
        v = split(self.value(hidden))
        # JAX divides by np.sqrt(d), a float32 scalar that promotes bf16
        # scores to float32; the probabilities and the context follow
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(self.d)
        if bias is not None:
            scores = scores + bias
        probs, v = promoted(self.dropout(torch.softmax(scores, dim=-1)), v)
        return (probs @ v).transpose(1, 2).reshape(B, T, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, bias):
        return self.output(self.self(hidden, bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, bias):
        hidden = self.attention(hidden, bias)
        return self.output(self.intermediate(hidden), hidden)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias):
        for layer in self.layer:
            hidden = layer(hidden, bias)
        return hidden


class BertModel(nn.Module):
    """[B, T] ids (+ attention mask) -> last_hidden_state [B, T, hidden]."""
    # the reference's pooler, which inference does not read
    UNREAD = ("pooler.",)

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids, attention_mask=None):
        hidden = self.embeddings(input_ids)
        bias = None
        if attention_mask is not None:
            # float32, as the scores it is added to
            m = attention_mask.to(torch.float32)[:, None, None, :]
            bias = (1.0 - m) * torch.finfo(torch.float32).min
        return self.encoder(hidden, bias)


# ---------------------------------------------------------------------------
# WordPiece tokenizer (host side; copy of promptttspp_tpu/models/bert.py)
# ---------------------------------------------------------------------------

def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer."""

    def __init__(self, vocab: Dict[str, int],
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.max_chars = max_input_chars_per_word
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab["[PAD]"]
        self.unk_id = vocab["[UNK]"]

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out, buf = [], []
        for ch in text:
            if ch.isspace():
                if buf:
                    out.append("".join(buf))
                    buf = []
            elif _is_punctuation(ch):
                if buf:
                    out.append("".join(buf))
                    buf = []
                out.append(ch)
            else:
                buf.append(ch)
        if buf:
            out.append("".join(buf))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        ids.append(self.sep_id)
        return ids

    def batch_encode(self, texts: Sequence[str],
                     max_length: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids [B, L], attention_mask [B, L]) padded arrays."""
        seqs = [self.encode(t) for t in texts]
        L = max_length or max(len(s) for s in seqs)
        ids = np.full((len(seqs), L), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask
