"""Token-bucketed batching and shape buckets (copy of
``promptttspp_tpu/data/batching.py``).

``batch_by_size`` is the fairseq-style bucketing of the reference's
trainer: walk length-sorted indices, close a batch when (len + 1) *
max_len would exceed ``max_tokens``, trim it to a multiple of the required
batch-size multiple. ``ShuffleBatchSampler`` shuffles that batch list per
epoch as a pure function of (seed, epoch). ``bucket_shape`` rounds padded
lengths up to fixed quanta, which keeps the set of padded shapes small;
the parity tests run the port at exactly the padded shapes the JAX package
uses.
"""

from __future__ import annotations

import random as _random
import sys
from typing import Callable, List, Optional, Sequence


def batch_by_size(
    indices: Sequence[int],
    num_tokens_fn: Callable[[int], int],
    max_tokens: Optional[int] = None,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 1,
) -> List[List[int]]:
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple

    sample_len = 0
    sample_lens: List[int] = []
    batch: List[int] = []
    batches: List[List[int]] = []
    for idx in indices:
        idx = int(idx)
        num = num_tokens_fn(idx)
        sample_lens.append(num)
        sample_len = max(sample_len, num)
        if sample_len > max_tokens:
            raise ValueError(f"sentence at index {idx} of size {sample_len} "
                             f"exceeds max_tokens limit of {max_tokens}!")
        projected = (len(batch) + 1) * sample_len
        full = len(batch) > 0 and (
            projected > max_tokens or len(batch) == max_sentences)
        if full:
            mod_len = max(bsz_mult * (len(batch) // bsz_mult),
                          len(batch) % bsz_mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


class ShuffleBatchSampler:
    """Shuffles the precomputed batch list each epoch. The order is a pure
    function of (seed, epoch) through ``set_epoch``, so a run resumed at
    epoch k sees the order an uninterrupted run sees."""

    def __init__(self, batches: List[List[int]], shuffle: bool = True,
                 seed: Optional[int] = None):
        self.batches = batches
        self.shuffle = shuffle
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        batches = list(self.batches)
        if self.shuffle:
            # mix seed and epoch into one deterministic stream id
            _random.Random(self.seed * 1_000_003 + self.epoch).shuffle(
                batches)
        return iter(batches)

    def __len__(self):
        return len(self.batches)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_shape(length: int, quantum: int, minimum: int = 0) -> int:
    """Round a padded length up to the next shape bucket."""
    return max(round_up(max(length, 1), quantum), minimum)
