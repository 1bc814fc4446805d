"""Host-side (numpy) helpers: list padding, duration-repeat expansion,
pad masks, and seeding.

Counterpart of ``promptttspp_tpu/utils/host.py``. ``seed_everything``
seeds torch's generators where JAX derives its keys from the seed. The
device-side masks are ``ops/masks.py``.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch


def seed_everything(seed: int):
    """Seed Python's, numpy's and torch's generators (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def pad_list(xs: Sequence[np.ndarray], pad_value: float,
             max_len: Optional[int] = None) -> np.ndarray:
    """[T_i, ...] arrays -> [N, max_len, ...], filled with ``pad_value``."""
    max_len = max(x.shape[0] for x in xs) if max_len is None else max_len
    out = np.full((len(xs), max_len) + tuple(xs[0].shape[1:]), pad_value,
                  dtype=xs[0].dtype)
    for i, x in enumerate(xs):
        out[i, : x.shape[0]] = x
    return out


def repeat_by_durations(xs: Sequence[np.ndarray], ds: Sequence[np.ndarray],
                        pad_value: float = 0,
                        max_len: Optional[int] = None) -> np.ndarray:
    """Each [T_in, C] repeated row by row by its durations, then padded
    (``pad_list``)."""
    expanded = [np.repeat(x, np.asarray(d).reshape(-1).astype(int), axis=0)
                for x, d in zip(xs, ds)]
    return pad_list(expanded, pad_value, max_len)


def make_pad_mask(lengths, maxlen: Optional[int] = None) -> np.ndarray:
    """[B, maxlen] bool, True at the padded positions."""
    lengths = np.asarray(lengths)
    maxlen = int(lengths.max()) if maxlen is None else maxlen
    return np.arange(maxlen)[None, :] >= lengths[:, None]


def make_non_pad_mask(lengths, maxlen: Optional[int] = None) -> np.ndarray:
    return ~make_pad_mask(lengths, maxlen)
