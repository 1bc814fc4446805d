"""The training corpus, written at set-up in the layout the port's
``data/dataset.py::AllWithSpkPromptNormDataset`` reads (copied from the
port's ``tools/synthetic_corpus.py``: ``training_rows`` and
``write_training_corpus``, re-parameterised):

- ``n`` utterances whose phone counts are spread evenly over ``phones``
  [lo, hi] (inclusive) and whose per-phone durations are the values of
  ``frames_per_phone`` [lo, hi] (inclusive) cycled to the phone count:
  every seed gets the same lengths; the seed orders them and draws the
  phone ids, the durations' order, the speakers, the style keys and the
  features;
- ``dump/libritts_r_per_spk_cleaned/df_filtered/{trn,val}.csv``, a log-mel
  [80, T] per utterance (one spectrum per phone over its frames, plus
  frame noise), a continuous log-F0 and a voicing flag [T];
- the prompt candidates (``data/*.csv``, copies of the repository's
  ``metadata/``) and a stand-in WordPiece vocabulary of their words.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import numpy as np

from perfbench.reference.ptts.data import yaml_lite
from perfbench.reference.ptts.data.dataset import (
    USE_COLS, read_prompt_candidate, read_spk_prompt_candidate)
from perfbench.reference.ptts.data.prompts import SPEAKER_TEMPLATES

DATA = Path(__file__).resolve().parent / "data"
SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
DUMP = "dump/libritts_r_per_spk_cleaned"


def candidates():
    """(style key -> prompts, speaker -> words) of ``data/``."""
    return (read_prompt_candidate(DATA / "style_prompt_candidates.csv"),
            read_spk_prompt_candidate(DATA / "speaker_prompt_candidates.csv"))


def _vocab(texts, vocab_size: int) -> List[str]:
    words = set()
    for p in texts:
        words.update(re.findall(r"[a-z0-9]+|[^\sa-z0-9]", p.lower()))
    vocab = SPECIAL + sorted(words | {".", ","})
    if len(vocab) > vocab_size:
        raise ValueError(f"{len(vocab)} tokens do not fit a vocabulary of "
                         f"{vocab_size}")
    return vocab + [f"[unused{i}]" for i in range(vocab_size - len(vocab))]


def training_rows(n: int, prompts: Mapping[str, Sequence[str]],
                  spk_words: Mapping[int, Sequence[str]], phones=(13, 125),
                  frames_per_phone=(6, 10), valid_every: int = 0,
                  seed: int = 0) -> List[Dict]:
    """``n`` rows (module docstring); with ``valid_every`` every
    ``valid_every``-th row goes to the validation split."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 3])
    keys, spks = sorted(prompts), sorted(spk_words)
    lo, hi = phones
    counts = rng.permutation(np.rint(np.linspace(lo, hi, n)).astype(int))
    cycle = np.arange(frames_per_phone[0], frames_per_phone[1] + 1)
    rows = []
    for i in range(n):
        key = keys[rng.integers(len(keys))]
        gender, *tags = key.split("_")
        tag = dict(t.split("-", 1) for t in tags)
        for k, v in tag.items():
            if v != "normal" and rng.random() < 1 / 3:
                tag[k] = f"very {v}"
        n_ph = int(counts[i])
        durations = rng.permutation(np.resize(cycle, n_ph))
        rows.append(dict(
            spk_id=spks[rng.integers(len(spks))], item_name=f"utt_{i:05d}",
            gender=gender, pitch=tag.get("p", "normal"),
            speaking_speed=tag.get("s", "normal"),
            energy=tag.get("e", "normal"), style_prompt_key=key,
            seq=rng.integers(1, 90, n_ph).tolist(),
            durations=durations.tolist(),
            split="val" if valid_every and i % valid_every == valid_every - 1
            else "trn"))
    return rows


def write_training_corpus(root, rows: List[Dict],
                          prompts: Mapping[str, Sequence[str]],
                          spk_words: Mapping[int, Sequence[str]],
                          vocab_size: int = 30522, mel_mean: float = -5.0,
                          mel_std: float = 2.0, n_mels: int = 80,
                          seed: int = 0) -> Path:
    """Write the training layout under ``root`` (emptied first). Features
    are drawn from ``seed``. Returns ``root``."""
    root = Path(root)
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 4])
    dump = root / DUMP
    mel_dir, feats_dir = dump / "mel63", dump / "feats"
    tables = {"trn": [",".join(USE_COLS)], "val": [",".join(USE_COLS)]}
    spk_f0 = {}
    for row in rows:
        spk, utt = str(row["spk_id"]), row["item_name"]
        dur = np.asarray(row["durations"], np.int64)
        n_ph = len(dur)
        spectra = rng.standard_normal((n_ph, n_mels)) * 0.8
        mel = np.repeat(spectra, dur, axis=0).T
        mel = mel_mean + mel_std * (
            mel + 0.2 * rng.standard_normal(mel.shape))
        f0 = spk_f0.setdefault(spk, np.log(90.0 + 160.0 * rng.random()))
        cf0 = np.repeat(f0 + 0.1 * rng.standard_normal(n_ph), dur)
        vuv = np.repeat((rng.random(n_ph) < 0.8).astype(np.float32), dur)
        for d, arr in ((mel_dir / spk, mel), (feats_dir / spk / "cf0", cf0),
                       (feats_dir / spk / "vuv", vuv)):
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"{utt}.npy", arr.astype(np.float32))
        cells = dict(row, seq=" ".join(str(int(s)) for s in row["seq"]),
                     durations=" ".join(str(int(d)) for d in dur))
        tables[row["split"]].append(",".join(str(cells[c])
                                             for c in USE_COLS))
    (dump / "df_filtered").mkdir(parents=True, exist_ok=True)
    for split, lines in tables.items():
        (dump / f"df_filtered/{split}.csv").write_text("\n".join(lines)
                                                      + "\n")
    yaml_lite.dump_flat(mel_dir / "stats.yaml",
                        dict(mean=mel_mean, std=mel_std))
    meta = root / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    for name in ("style_prompt_candidates.csv",
                 "speaker_prompt_candidates.csv"):
        shutil.copyfile(DATA / name, meta / name)
    texts = [p for cands in prompts.values() for p in cands]
    texts += [", ".join(words) for words in spk_words.values()]
    texts += [t.format(words="") for t in SPEAKER_TEMPLATES]
    (meta / "bert-base-uncased-vocab.txt").write_text(
        "\n".join(_vocab(texts, vocab_size)) + "\n")
    return root


def paths(root) -> Dict[str, str]:
    """The dataset's constructor arguments for a corpus under ``root``."""
    root = Path(root)
    dump = root / DUMP
    return dict(file_path=str(dump / "df_filtered/trn.csv"),
                data_root=str(root), feats_dir=str(dump / "feats"),
                mel_dir=str(dump / "mel63"),
                prompt_candidate_file=str(
                    root / "metadata/style_prompt_candidates.csv"),
                spk_prompt_candidate_file=str(
                    root / "metadata/speaker_prompt_candidates.csv"))


def vocab_file(root) -> str:
    return str(Path(root) / "metadata/bert-base-uncased-vocab.txt")
