"""The training dataset and the readers of the corpus files, without
pandas or PyYAML (the machine with the GPU has neither).

Counterparts of ``promptttspp_tpu/data/dataset.py``
(``AllWithSpkPromptNormDataset``, ``read_prompt_candidate`` and
``read_spk_prompt_candidate``, pipe-separated files) and a reader of the
``stats.yaml`` that ``preprocess/pipeline.py`` writes as ``yaml.safe_dump``
does: a flat mapping of numbers.
"""

from __future__ import annotations

import csv
import random as _random
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench.reference.ptts.data import yaml_lite
from perfbench.reference.ptts.data.prompts import build_prompt


def _pipe_rows(filepath):
    with open(filepath, newline="") as f:
        return [row for row in csv.reader(f, delimiter="|") if row]


def read_prompt_candidate(filepath) -> Dict[str, List[str]]:
    """style_key -> list of lowercase paraphrases."""
    return {row[0]: [s.lower().strip() for s in row[1].split(";")]
            for row in _pipe_rows(filepath)}


def read_spk_prompt_candidate(filepath) -> Dict[int, List[str]]:
    """spk_id -> descriptor word list."""
    return {int(row[0]): row[1].split(",") for row in _pipe_rows(filepath)}


def read_mel_stats(filepath) -> Dict[str, float]:
    """``stats.yaml`` (a flat mapping of numbers, ``data/yaml_lite.py``)
    -> {key: float}."""
    stats = yaml_lite.load(filepath)
    nested = [k for k, v in stats.items() if isinstance(v, dict)]
    if nested:
        raise ValueError(f"{filepath}: not a flat mapping (at {nested})")
    return {k: float(v) for k, v in stats.items()}


def read_csv_rows(filepath) -> List[Dict[str, str]]:
    """A comma-separated file with a header -> one dict per row."""
    with open(filepath, newline="") as f:
        return list(csv.DictReader(f))


# the columns of the train/valid CSVs that the dataset reads
USE_COLS = ["spk_id", "item_name", "gender", "pitch", "speaking_speed",
            "energy", "style_prompt_key", "seq", "durations"]


def _cell(value: str):
    """A CSV cell as pandas types it here: an integer where it is one
    (``spk_id``), the string otherwise. pandas reads no underscores in a
    number, where Python's ``int`` does: LibriTTS-R's item names
    (``100_121669_000001_000000``) stay strings."""
    return int(value) if re.fullmatch(r"[-+]?[0-9]+", value.strip()) \
        else value


class AllWithSpkPromptNormDataset:
    """Per utterance: phoneme ids and durations from the CSV row, the mel
    (``<mel_dir>/<spk>/<utt>.npy`` [n_mels, T], normalized by the mean and
    std of ``<mel_dir>/stats.yaml``), log-F0 and V/UV
    (``<feats_dir>/<spk>/{cf0,vuv}/<utt>.npy``), the energy computed from
    the mel, the last duration cut by one where the durations overrun the
    frames, and a prompt drawn from ``random.Random(seed)``
    (``data/prompts.py``). Items are those of the JAX dataset: mel [T,
    n_mels], log_cf0 / vuv / energy [T, 1] float32.

    ``set_epoch(epoch)`` re-seeds the prompt draws from (seed, epoch) when
    a seed was given, so a resumed run draws the prompts of an
    uninterrupted one; without a seed the draws are unseeded, as in JAX.

    An item is ``load_item_features(item_meta(idx))``, the split the
    prefetching pipeline (``data/prefetch.py``) needs: ``item_meta`` draws
    the prompt from the dataset's generator, so it is called in sampler
    order on one thread; ``load_item_features`` reads and computes the
    features and may run on any thread."""

    def __init__(self, file_path, data_root, feats_dir, mel_dir,
                 prompt_candidate_file, spk_prompt_candidate_file,
                 use_spk_prompt: bool = True, p_augment: float = 0.0,
                 seed: Optional[int] = None):
        rows = read_csv_rows(file_path)
        missing = [c for c in USE_COLS if rows and c not in rows[0]]
        if missing:
            raise ValueError(f"{file_path} lacks the columns {missing}")
        self.data = [[_cell(row[c]) for c in USE_COLS] for row in rows]
        self.lengths = [sum(int(d) for d in str(row[-1]).split())
                        for row in self.data]
        self.data_root = Path(data_root)
        self.feats_dir = Path(feats_dir)
        self.mel_dir = Path(mel_dir)
        self.prompt_candidate = read_prompt_candidate(prompt_candidate_file)
        self.spk_prompt_candidate = read_spk_prompt_candidate(
            spk_prompt_candidate_file)
        self.use_spk_prompt = use_spk_prompt
        self.p_augment = p_augment
        self.stats = read_mel_stats(self.mel_dir / "stats.yaml")
        self.seed = seed
        self.rng = _random.Random(seed)

    def __len__(self):
        return len(self.data)

    def set_epoch(self, epoch: int):
        if self.seed is not None:
            self.rng = _random.Random(f"{self.seed}/{epoch}")

    def num_tokens(self, index: int) -> int:
        return self.lengths[index]

    def num_phones(self, index: int) -> int:
        """The phone count from the CSV row (no feature file read): data
        parallelism's global phone bucket."""
        return str(self.data[index][-2]).count(" ") + 1

    def ordered_indices(self) -> np.ndarray:
        """Length-sorted (stable) indices."""
        return np.argsort(np.asarray(self.lengths), kind="mergesort")

    def _load_features(self, spk, utt_id, seq, durations):
        phonemes = np.asarray([int(s) for s in str(seq).split()], np.int32)
        dur = np.asarray([int(d) for d in str(durations).split()], np.int32)
        mel = np.load(self.mel_dir / f"{spk}/{utt_id}.npy")  # [80, T]
        mel_norm = (mel - self.stats["mean"]) / self.stats["std"]
        log_cf0 = np.load(self.feats_dir / f"{spk}/cf0/{utt_id}.npy")
        vuv = np.load(self.feats_dir / f"{spk}/vuv/{utt_id}.npy")
        log_cf0 = log_cf0.reshape(-1)
        vuv = vuv.reshape(-1)
        energy = np.sqrt(np.sum(np.exp(mel) ** 2, axis=0)).reshape(-1)
        T = mel.shape[-1]
        if not T == log_cf0.shape[-1] == vuv.shape[-1]:
            raise ValueError(f"{spk}/{utt_id}: {T} mel frames, "
                             f"{log_cf0.shape[-1]} cf0, {vuv.shape[-1]} vuv")
        if T < dur.sum():  # off-by-one of the duration extraction
            dur[-1] -= 1
        if T != dur.sum():
            raise ValueError(f"{spk}/{utt_id}: {T} mel frames, durations "
                             f"sum to {dur.sum()}")
        return (
            phonemes, dur,
            np.ascontiguousarray(mel_norm.T, np.float32),      # [T, 80]
            log_cf0[:, None].astype(np.float32),               # [T, 1]
            vuv[:, None].astype(np.float32),
            energy[:, None].astype(np.float32),
        )

    def item_meta(self, idx: int) -> Dict:
        """Item ``idx`` without its features: the ids, ``seq`` and
        ``durations`` (the CSV's strings), the prompt (drawn now),
        ``n_frames`` and the paths of its three feature files."""
        (spk_id, utt_id, gender, pitch, speaking_speed, energy_tag,
         style_prompt_key, seq, durations) = self.data[idx]
        prompt = build_prompt(
            style_prompt_key, spk_id, pitch, speaking_speed, energy_tag,
            self.prompt_candidate, self.spk_prompt_candidate, self.rng,
            use_spk_prompt=self.use_spk_prompt, p_augment=self.p_augment)
        return dict(
            spk_id=spk_id, utt_id=utt_id, seq=str(seq),
            durations=str(durations), prompt=prompt,
            n_frames=self.lengths[idx],
            mel_path=str(self.mel_dir / f"{spk_id}/{utt_id}.npy"),
            cf0_path=str(self.feats_dir / f"{spk_id}/cf0/{utt_id}.npy"),
            vuv_path=str(self.feats_dir / f"{spk_id}/vuv/{utt_id}.npy"))

    def load_item_features(self, meta: Dict) -> Dict:
        """The item of ``meta`` (``item_meta``) with its features."""
        phonemes, dur, mel, log_cf0, vuv, energy = self._load_features(
            meta["spk_id"], meta["utt_id"], meta["seq"], meta["durations"])
        return dict(spk_id=meta["spk_id"], utt_id=meta["utt_id"],
                    phonemes=phonemes, duration=dur, mel=mel,
                    log_cf0=log_cf0, vuv=vuv, energy=energy,
                    prompt=meta["prompt"])

    def __getitem__(self, idx: int) -> Dict:
        return self.load_item_features(self.item_meta(idx))
