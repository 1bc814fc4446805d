"""Synthetic corpora in the layouts that the port's entry points read
(``conf/path/default.yaml`` under one ``path.root``), for smoke runs and
tests where the real corpus is absent.

``write_corpus``, the eval corpus of the synthesize CLI:

- ``data_prep/out/libritts_r_per_spk_cleaned/<spk>/wav24k/<utt>.wav``: a
  seeded, amplitude-modulated harmonic tone per utterance (16-bit, 24 kHz);
- ``dump/libritts_r_per_spk_cleaned/df_filtered/eval_filtered.csv``
  (``spk_id``, ``item_name``, ``seq``, ``style_prompt_key``);
- ``dump/libritts_r_per_spk_cleaned/mel63/stats.yaml``;
- ``metadata/style_prompt_candidates.csv`` (``key|prompt;prompt``);
- ``metadata/bert-base-uncased-vocab.txt``: BERT's special tokens, the
  prompts' words and punctuation, then filler tokens up to ``vocab_size``
  lines (a stand-in for the real vocabulary, whose ids it keeps below).

``write_training_corpus``, the training layout of
``data/dataset.py::AllWithSpkPromptNormDataset`` (``bin/train.py``):

- ``dump/libritts_r_per_spk_cleaned/df_filtered/{trn,val}.csv`` with the
  dataset's columns (``spk_id``, ``item_name``, ``gender``, ``pitch``,
  ``speaking_speed``, ``energy``, ``style_prompt_key``, ``seq``,
  ``durations``);
- ``dump/libritts_r_per_spk_cleaned/mel63/<spk>/<utt>.npy``: a log-mel
  [80, T] with one seeded spectrum per phone held over its frames, plus
  frame noise, around ``mel_mean`` / ``mel_std`` (``mel63/stats.yaml``);
- ``dump/libritts_r_per_spk_cleaned/feats/<spk>/{cf0,vuv}/<utt>.npy``: a
  continuous log-F0 per phone around the speaker's and a voicing flag
  [T];
- ``metadata/style_prompt_candidates.csv``,
  ``metadata/speaker_prompt_candidates.csv`` (``spk|word,word``) and the
  stand-in vocabulary, which also holds the speaker prompts' words.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from promptttspp_tpu_torch.data.dataset import USE_COLS
from promptttspp_tpu_torch.data.prompts import SPEAKER_TEMPLATES

SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _vocab(texts: Iterable[str], vocab_size: int):
    words = set()
    for p in texts:
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
    texts = [p for cands in prompts.values() for p in cands]
    (meta / "bert-base-uncased-vocab.txt").write_text(
        "\n".join(_vocab(texts, vocab_size)) + "\n")
    return root


def training_rows(n: int, prompts: Mapping[str, Sequence[str]],
                  spk_words: Mapping[int, Sequence[str]], phones=(8, 40),
                  frames_per_phone=(2, 12), valid_every: int = 10,
                  seed: int = 0) -> List[Dict]:
    """``n`` rows for ``write_training_corpus``: a style key of ``prompts``
    each (``<gender>_p-<pitch>_s-<speed>_e-<energy>``, its tags in the
    columns, a third of the non-normal ones as "very <tag>"), a speaker of
    ``spk_words``, ``phones`` [lo, hi) phoneme ids in 1..89 with
    ``frames_per_phone`` [lo, hi) frames each; every ``valid_every``-th row
    goes to the validation split."""
    rng = np.random.RandomState(seed)
    keys, spks = sorted(prompts), sorted(spk_words)
    rows = []
    for i in range(n):
        key = keys[rng.randint(len(keys))]
        gender, *tags = key.split("_")
        tag = dict(t.split("-", 1) for t in tags)
        for k, v in tag.items():
            if v != "normal" and rng.rand() < 1 / 3:
                tag[k] = f"very {v}"
        n_ph = rng.randint(*phones)
        rows.append(dict(
            spk_id=spks[rng.randint(len(spks))], item_name=f"utt_{i:05d}",
            gender=gender, pitch=tag.get("p", "normal"),
            speaking_speed=tag.get("s", "normal"),
            energy=tag.get("e", "normal"), style_prompt_key=key,
            seq=rng.randint(1, 90, n_ph).tolist(),
            durations=rng.randint(*frames_per_phone, n_ph).tolist(),
            split="val" if i % valid_every == valid_every - 1 else "trn"))
    return rows


def write_training_corpus(root, rows: List[Dict],
                          prompts: Mapping[str, Sequence[str]],
                          spk_words: Mapping[int, Sequence[str]],
                          vocab_size: int = 30522, mel_mean: float = -5.0,
                          mel_std: float = 2.0, n_mels: int = 80,
                          seed: int = 0) -> Path:
    """Write the training layout under ``root``. ``rows``: dicts with the
    dataset's columns (``seq`` and ``durations`` as int lists; the speaker
    and style tags as strings) and ``split`` ("trn" or "val"). Features
    are drawn from ``seed``. Returns ``root``."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    dump = root / "dump/libritts_r_per_spk_cleaned"
    mel_dir, feats_dir = dump / "mel63", dump / "feats"
    tables = {"trn": [",".join(USE_COLS)], "val": [",".join(USE_COLS)]}
    spk_f0 = {}
    for row in rows:
        spk, utt = str(row["spk_id"]), row["item_name"]
        dur = np.asarray(row["durations"], np.int64)
        n_ph = len(dur)
        if len(row["seq"]) != n_ph:
            raise ValueError(f"{utt}: {len(row['seq'])} phones, {n_ph} "
                             "durations")
        spectra = rng.randn(n_ph, n_mels) * 0.8
        mel = np.repeat(spectra, dur, axis=0).T
        mel = mel_mean + mel_std * (mel + 0.2 * rng.randn(*mel.shape))
        f0 = spk_f0.setdefault(spk, np.log(90.0 + 160.0 * rng.rand()))
        cf0 = np.repeat(f0 + 0.1 * rng.randn(n_ph), dur)
        vuv = np.repeat((rng.rand(n_ph) < 0.8).astype(np.float32), dur)
        for d, name, arr in ((mel_dir / spk, f"{utt}.npy", mel),
                             (feats_dir / spk / "cf0", f"{utt}.npy", cf0),
                             (feats_dir / spk / "vuv", f"{utt}.npy", vuv)):
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / name, arr.astype(np.float32))
        cells = dict(row, seq=" ".join(str(int(s)) for s in row["seq"]),
                     durations=" ".join(str(int(d)) for d in dur))
        tables[row["split"]].append(",".join(str(cells[c])
                                             for c in USE_COLS))
    (dump / "df_filtered").mkdir(parents=True, exist_ok=True)
    for split, lines in tables.items():
        (dump / f"df_filtered/{split}.csv").write_text("\n".join(lines)
                                                      + "\n")
    (mel_dir / "stats.yaml").write_text(
        f"mean: {mel_mean!r}\nstd: {mel_std!r}\n")
    meta = root / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    (meta / "style_prompt_candidates.csv").write_text("".join(
        f"{key}|{';'.join(cands)}\n" for key, cands in prompts.items()))
    (meta / "speaker_prompt_candidates.csv").write_text("".join(
        f"{spk}|{','.join(words)}\n" for spk, words in spk_words.items()))
    texts = [p for cands in prompts.values() for p in cands]
    texts += [", ".join(words) for words in spk_words.values()]
    texts += [t.format(words="") for t in SPEAKER_TEMPLATES]
    (meta / "bert-base-uncased-vocab.txt").write_text(
        "\n".join(_vocab(texts, vocab_size)) + "\n")
    return root
