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

``write_raw_corpus``, the raw layout that ``preprocess/pipeline.py::
preprocess_corpus`` (``bin/preprocess.py``) reads, from ``raw_rows``:

- ``data_prep/out/libritts_r_per_spk_cleaned/<spk>/wav24k/<utt>.wav``:
  ``speech_like`` signals (16-bit, 24 kHz): a glottal pulse train with
  vibrato through three formant filters, an unvoiced hiss, noise, and
  silence at both ends;
- ``data_prep/out/libritts_r_per_spk_cleaned/<spk>/textgrid/<utt>.TextGrid``
  with a ``words`` and a ``phones`` tier (``sil`` first, ``sp`` last);
- ``metadata/metadata_w_style_prompt_tags.csv`` (``spk_id``, ``item_name``,
  ``gender``, ``pitch``, ``speaking_speed``, ``energy``,
  ``style_prompt_key``), both prompt-candidate files, the stand-in
  vocabulary and, where given, a copy of the per-speaker F0 bounds
  (``metadata/libritts_r_f0_stats.yaml``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from promptttspp_tpu_torch.data import yaml_lite
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
    yaml_lite.dump_flat(dump / "mel63/stats.yaml",
                        dict(mean=mel_mean, std=mel_std))
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
    yaml_lite.dump_flat(mel_dir / "stats.yaml",
                        dict(mean=mel_mean, std=mel_std))
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


# ARPAbet phones of text/eng.py and the words of the words tier
RAW_PHONES = ["HH", "AH0", "L", "OW1", "W", "ER1", "D", "B", "IY1", "M",
              "AA1", "N", "S", "T", "EH1", "K"]
RAW_WORDS = ["hello", "world", "speech", "voice", "quiet", "morning",
             "river", "table", "garden", "window"]
RAW_COLS = ["spk_id", "item_name", "gender", "pitch", "speaking_speed",
            "energy", "style_prompt_key"]
EDGE_SILENCE = 0.2  # seconds of silence at each end of a raw utterance


def speech_like(seconds: float, f0: float, seed: int,
                sr: int = 24000) -> np.ndarray:
    """A seeded speech-like wav in [-1, 1]: ``EDGE_SILENCE`` s of silence at
    each end; between them a glottal pulse train at ``f0`` Hz with 6%
    vibrato and per-pulse amplitude jitter through formant resonators at
    500, 1500 and 2500 Hz, an unvoiced hiss over a tenth of the speech from
    40%, and low noise."""
    from scipy import signal as sps

    rng = np.random.RandomState(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    edge = int(sr * EDGE_SILENCE)
    track = f0 * (1 + 0.06 * np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6))
    speech = np.zeros(n, bool)
    speech[edge:n - edge] = True
    voiced = speech.copy()
    h0 = edge + int(0.4 * (n - 2 * edge))
    voiced[h0:h0 + (n - 2 * edge) // 10] = False
    pulses = np.zeros(n)
    at = np.where(np.diff(np.floor(np.cumsum(track / sr))) > 0)[0]
    at = at[voiced[at]]
    pulses[at] = 1.0 + 0.1 * rng.randn(len(at))
    out = pulses
    for fc, bw in ((500, 80), (1500, 120), (2500, 160)):
        r = np.exp(-np.pi * bw / sr)
        out = sps.lfilter([1.0], [1.0, -2 * r * np.cos(2 * np.pi * fc / sr),
                                  r * r], out)
    hiss = sps.lfilter([1, -0.95], [1], np.where(
        speech & ~voiced, 0.15 * rng.randn(n), 0.0))
    x = out / max(np.abs(out).max(), 1e-9) * 0.6 + hiss \
        + np.where(speech, 0.01 * rng.randn(n), 0.0)
    return np.clip(x, -1.0, 32766 / 32767)


def raw_rows(utts_per_spk: Mapping[int, int], prompts: Mapping[str,
             Sequence[str]], seconds=(3.0, 5.0), f0_stats: Mapping = None,
             seed: int = 0) -> List[Dict]:
    """Rows for ``write_raw_corpus``: ``utts_per_spk[spk]`` utterances of
    each speaker, each of ``seconds`` [lo, hi) seconds with a style key of
    ``prompts`` (its tags in the columns) and the speaker's F0: its
    ``f0_center`` in ``f0_stats`` (``metadata/libritts_r_f0_stats.yaml``)
    where it has one, else 120 Hz."""
    rng = np.random.RandomState(seed)
    keys = sorted(prompts)
    rows = []
    for spk, n in utts_per_spk.items():
        f0 = float(((f0_stats or {}).get(str(spk)) or {}).get("f0_center",
                                                              120.0))
        for u in range(n):
            key = keys[rng.randint(len(keys))]
            gender, *tags = key.split("_")
            tag = dict(t.split("-", 1) for t in tags)
            rows.append(dict(
                spk_id=spk, item_name=f"{spk}_{u:04d}", gender=gender,
                pitch=tag.get("p", "normal"),
                speaking_speed=tag.get("s", "normal"),
                energy=tag.get("e", "normal"), style_prompt_key=key,
                seconds=float(rng.uniform(*seconds)),
                f0=f0 * float(rng.uniform(0.9, 1.1))))
    return rows


def raw_textgrid(seconds: float, rng) -> str:
    """A long-format TextGrid: a ``words`` and a ``phones`` tier over
    ``seconds``; about 10 phones a second between the edge silences, three
    phones a word."""
    start, stop = EDGE_SILENCE, seconds - EDGE_SILENCE
    n_ph = max(4, int((stop - start) * 10))
    cuts = np.cumsum(rng.uniform(0.6, 1.4, n_ph))
    bounds = start + (stop - start) * np.concatenate([[0.0], cuts / cuts[-1]])
    phones = [(0.0, start, "sil")] + [
        (bounds[i], bounds[i + 1], RAW_PHONES[rng.randint(len(RAW_PHONES))])
        for i in range(n_ph)] + [(stop, seconds, "sp")]
    words = [(0.0, start, "")] + [
        (bounds[i], bounds[min(i + 3, n_ph)],
         RAW_WORDS[rng.randint(len(RAW_WORDS))])
        for i in range(0, n_ph, 3)] + [(stop, seconds, "")]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0 ", f"xmax = {seconds!r} ", "tiers? <exists> ",
             "size = 2 ", "item []: "]
    for i, (name, ivs) in enumerate((("words", words), ("phones", phones))):
        lines += [f"    item [{i + 1}]:", '        class = "IntervalTier" ',
                  f'        name = "{name}" ', "        xmin = 0 ",
                  f"        xmax = {seconds!r} ",
                  f"        intervals: size = {len(ivs)} "]
        for j, (a, b, text) in enumerate(ivs):
            lines += [f"        intervals [{j + 1}]:",
                      f"            xmin = {float(a)!r} ",
                      f"            xmax = {float(b)!r} ",
                      f'            text = "{text}" ']
    return "\n".join(lines) + "\n"


def write_raw_corpus(root, rows: List[Dict],
                     prompts: Mapping[str, Sequence[str]],
                     spk_words: Mapping[int, Sequence[str]],
                     f0_stats_file=None, vocab_size: int = 30522,
                     seed: int = 0) -> Path:
    """Write the raw layout under ``root`` (module docstring). ``rows``:
    from ``raw_rows``. ``f0_stats_file``: copied to
    ``metadata/libritts_r_f0_stats.yaml`` where given. Returns ``root``."""
    import shutil

    from scipy.io import wavfile

    root = Path(root)
    rng = np.random.RandomState(seed)
    data_root = root / "data_prep/out/libritts_r_per_spk_cleaned"
    lines = [",".join(RAW_COLS)]
    for i, row in enumerate(rows):
        spk, utt = str(row["spk_id"]), row["item_name"]
        for sub in ("wav24k", "textgrid"):
            (data_root / spk / sub).mkdir(parents=True, exist_ok=True)
        wav = speech_like(row["seconds"], row["f0"], seed * 100003 + i)
        wavfile.write(data_root / spk / "wav24k" / f"{utt}.wav", 24000,
                      np.round(wav * 32767).astype(np.int16))
        (data_root / spk / "textgrid" / f"{utt}.TextGrid").write_text(
            raw_textgrid(len(wav) / 24000, rng))
        lines.append(",".join(str(row[c]) for c in RAW_COLS))
    meta = root / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    (meta / "metadata_w_style_prompt_tags.csv").write_text(
        "\n".join(lines) + "\n")
    (meta / "style_prompt_candidates.csv").write_text("".join(
        f"{key}|{';'.join(cands)}\n" for key, cands in prompts.items()))
    (meta / "speaker_prompt_candidates.csv").write_text("".join(
        f"{spk}|{','.join(words)}\n" for spk, words in spk_words.items()))
    texts = [p for cands in prompts.values() for p in cands]
    texts += [", ".join(words) for words in spk_words.values()]
    texts += [t.format(words="") for t in SPEAKER_TEMPLATES]
    (meta / "bert-base-uncased-vocab.txt").write_text(
        "\n".join(_vocab(texts, vocab_size)) + "\n")
    if f0_stats_file is not None:
        shutil.copyfile(f0_stats_file, meta / "libritts_r_f0_stats.yaml")
    return root
