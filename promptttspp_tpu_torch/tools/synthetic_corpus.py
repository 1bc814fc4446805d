"""A synthetic eval corpus in the layout that the synthesize CLI reads
(``conf/path/default.yaml`` under one ``path.root``), for smoke runs and
tests where the real corpus is absent:

- ``data_prep/out/libritts_r_per_spk_cleaned/<spk>/wav24k/<utt>.wav``: a
  seeded, amplitude-modulated harmonic tone per utterance (16-bit, 24 kHz);
- ``dump/libritts_r_per_spk_cleaned/df_filtered/eval_filtered.csv``
  (``spk_id``, ``item_name``, ``seq``, ``style_prompt_key``);
- ``dump/libritts_r_per_spk_cleaned/mel63/stats.yaml``;
- ``metadata/style_prompt_candidates.csv`` (``key|prompt;prompt``);
- ``metadata/bert-base-uncased-vocab.txt``: BERT's special tokens, the
  prompts' words and punctuation, then filler tokens up to ``vocab_size``
  lines (a stand-in for the real vocabulary, whose ids it keeps below).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import numpy as np

SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _vocab(prompts: Mapping[str, Sequence[str]], vocab_size: int):
    words = set()
    for cands in prompts.values():
        for p in cands:
            words.update(re.findall(r"[a-z0-9]+|[^\sa-z0-9]", p.lower()))
    vocab = SPECIAL + sorted(words | {".", ","})
    if len(vocab) > vocab_size:
        raise ValueError(f"{len(vocab)} tokens do not fit a vocabulary of "
                         f"{vocab_size}")
    return vocab + [f"[unused{i}]" for i in range(vocab_size - len(vocab))]


def write_corpus(root, rows: List[Dict], prompts: Mapping[str, Sequence[str]],
                 vocab_size: int = 30522, wav_seconds: float = 3.0,
                 mel_mean: float = -5.0, mel_std: float = 2.0) -> Path:
    """Write the corpus under ``root``. ``rows``: dicts with ``spk_id``,
    ``item_name``, ``seq`` (phoneme ids) and ``style_prompt_key`` (a key of
    ``prompts``). Returns ``root``."""
    from scipy.io import wavfile

    root = Path(root)
    rng = np.random.RandomState(0)
    data_root = root / "data_prep/out/libritts_r_per_spk_cleaned"
    dump = root / "dump/libritts_r_per_spk_cleaned"
    lines = ["spk_id,item_name,seq,style_prompt_key"]
    t = np.arange(int(24000 * wav_seconds)) / 24000.0
    for row in rows:
        wav_dir = data_root / str(row["spk_id"]) / "wav24k"
        wav_dir.mkdir(parents=True, exist_ok=True)
        f0 = 100.0 + 100.0 * rng.rand()
        wav = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t)
                  for k in (1, 2, 3)) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        wavfile.write(wav_dir / f"{row['item_name']}.wav", 24000,
                      (wav * 32767).astype(np.int16))
        seq = " ".join(str(int(s)) for s in row["seq"])
        lines.append(f"{row['spk_id']},{row['item_name']},{seq},"
                     f"{row['style_prompt_key']}")
    (dump / "df_filtered").mkdir(parents=True, exist_ok=True)
    (dump / "df_filtered/eval_filtered.csv").write_text(
        "\n".join(lines) + "\n")
    (dump / "mel63").mkdir(parents=True, exist_ok=True)
    (dump / "mel63/stats.yaml").write_text(
        f"mean: {mel_mean!r}\nstd: {mel_std!r}\n")
    meta = root / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    (meta / "style_prompt_candidates.csv").write_text("".join(
        f"{key}|{';'.join(cands)}\n" for key, cands in prompts.items()))
    (meta / "bert-base-uncased-vocab.txt").write_text(
        "\n".join(_vocab(prompts, vocab_size)) + "\n")
    return root
