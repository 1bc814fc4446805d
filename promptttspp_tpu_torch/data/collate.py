"""Batch assembly: pad to shape buckets, tokenize the prompts.

Counterpart of ``promptttspp_tpu/data/collate.py::PromptTTSCollator``: the
same buckets (phones, frames and prompt tokens rounded up to quanta of 16,
64 and 16) and the same zero padding, the prompts WordPiece-tokenized on
the host (``models/bert.py::WordPieceTokenizer``). Arrays are numpy; the
trainer moves the model's keys to the device. ``batch_weight`` (ones) is
always set: the port pads no rows, so every row counts.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from promptttspp_tpu_torch.data.batching import bucket_shape


PHONE_QUANTUM, FRAME_QUANTUM, PROMPT_QUANTUM = 16, 64, 16


class PromptTTSCollator:
    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer

    def __call__(self, items: List[Dict]) -> Dict:
        """Dataset items -> a batch dict: phoneme, duration [B, Tp] int32,
        phone_lengths, mel [B, Tf, n_mels], log_cf0, vuv, energy [B, Tf, 1],
        frame_lengths, batch_weight [B] float32, spk_ids, utt_ids, prompts
        and, with a tokenizer, prompt_ids and prompt_mask [B, L] int32."""
        B = len(items)
        plens = np.asarray([len(it["phonemes"]) for it in items], np.int32)
        flens = np.asarray([it["mel"].shape[0] for it in items], np.int32)
        Tp = bucket_shape(int(plens.max()), PHONE_QUANTUM)
        Tf = bucket_shape(int(flens.max()), FRAME_QUANTUM)
        mel_dim = items[0]["mel"].shape[1]

        phoneme = np.zeros((B, Tp), np.int32)
        duration = np.zeros((B, Tp), np.int32)
        mel = np.zeros((B, Tf, mel_dim), np.float32)
        log_cf0 = np.zeros((B, Tf, 1), np.float32)
        vuv = np.zeros((B, Tf, 1), np.float32)
        energy = np.zeros((B, Tf, 1), np.float32)
        for i, it in enumerate(items):
            p, f = plens[i], flens[i]
            phoneme[i, :p] = it["phonemes"]
            duration[i, :p] = it["duration"]
            mel[i, :f] = it["mel"]
            log_cf0[i, :f] = it["log_cf0"]
            vuv[i, :f] = it["vuv"]
            energy[i, :f] = it["energy"]

        batch = dict(
            phoneme=phoneme, duration=duration, phone_lengths=plens,
            mel=mel, log_cf0=log_cf0, vuv=vuv, energy=energy,
            frame_lengths=flens, batch_weight=np.ones((B,), np.float32),
            spk_ids=[it["spk_id"] for it in items],
            utt_ids=[it["utt_id"] for it in items],
            prompts=[it["prompt"] for it in items],
        )
        if self.tokenizer is not None:
            raw_ids, raw_mask = self.tokenizer.batch_encode(batch["prompts"])
            L = bucket_shape(raw_ids.shape[1], PROMPT_QUANTUM)
            ids = np.full((B, L), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((B, L), np.int32)
            ids[:, : raw_ids.shape[1]] = raw_ids
            mask[:, : raw_mask.shape[1]] = raw_mask
            batch["prompt_ids"] = ids
            batch["prompt_mask"] = mask
        return batch
