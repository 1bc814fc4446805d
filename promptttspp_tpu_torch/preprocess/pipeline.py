"""Offline feature preprocessing: wav + TextGrid -> durations, cf0/vuv,
mel, stats, CSVs.

Counterpart of ``promptttspp_tpu/preprocess/pipeline.py``: utterances are
padded into 2-s sample buckets, and F0 (``ops/f0.py``, batched YIN) and the
mel (``ops/mel.py``) run as one batched call each on the card; the octave
fix of the contours (``preprocess/world_f0.py::fix_f0_contour``) runs on
the host, as in JAX. Outputs are per-utterance ``.npy`` files, the mel
statistics and CSVs with the reference's schema, plus the ``finish``
markers that make each stage idempotent.

CSVs are read and written with ``csv`` (no pandas on the machine with the
GPU): each cell is written as it was read, where pandas would retype a
column (a float column "0.50" comes back as "0.5"); the split orders
speakers as pandas' ``groupby`` does, by integer id.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.data.dataset import read_csv_rows
from promptttspp_tpu_torch.ops.f0 import extract_f0
from promptttspp_tpu_torch.ops.interp import interp1d
from promptttspp_tpu_torch.ops.masks import to_log_scale
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.duration import process_textgrid
from promptttspp_tpu_torch.preprocess.world_f0 import (
    extract_pitch_world, fix_f0_contour)


def read_wav(path):
    """int16/int32/float wav -> (float64 samples in [-1, 1], mono; sample
    rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float64) / 2147483648.0
    else:
        data = data.astype(np.float64)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def write_csv(path, rows: Sequence[Dict[str, str]],
              columns: Sequence[str]):
    """``rows`` under the header ``columns``, as pandas' ``to_csv(index=
    False)`` writes them (minimal quoting, "\\n" line ends)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([row.get(c, "") for c in columns] for row in rows)


def _columns(path) -> List[str]:
    with open(path, newline="") as f:
        return next(csv.reader(f), [])


def _speaker_key(spk: str):
    """pandas reads an all-integer ``spk_id`` column as int64 and groups
    by integer value: "19" before "100"."""
    return (0, int(spk), "") if spk.lstrip("-+").isdigit() else (1, 0, spk)


class MelStats:
    """The global statistics of the mels, accumulated in float32 as NumPy 2
    accumulates the JAX package's (a Python float plus a float32 sum is a
    float32)."""

    def __init__(self):
        self.sum = self.sqsum = np.float32(0.0)
        self.count = 0
        self.min, self.max = np.inf, -np.inf

    def add(self, mel: np.ndarray):
        self.sum = np.float32(self.sum + mel.sum())
        self.sqsum = np.float32(self.sqsum + (mel ** 2).sum())
        self.count += mel.size
        self.min = min(self.min, float(mel.min()))
        self.max = max(self.max, float(mel.max()))

    def write(self, mel_dir: Path) -> float:
        """Write ``<mel_dir>/stats.yaml`` (as ``yaml.safe_dump``) and the
        ``finish`` marker; returns the mean."""
        count = np.float32(max(self.count, 1))
        mean = self.sum / count
        var = self.sqsum / count - mean ** 2
        mel_dir.mkdir(parents=True, exist_ok=True)
        yaml_lite.dump_flat(mel_dir / "stats.yaml", dict(
            min=float(self.min), max=float(self.max), mean=float(mean),
            std=float(np.sqrt(max(var, 0.0))), var=float(var)))
        (mel_dir / "finish").write_text("done\n")
        return float(mean)


class BatchedFeatureExtractor:
    """Length-bucketed batched F0 + mel extraction on ``device`` (``cuda``
    unless given ``"cpu"``)."""

    def __init__(self, sample_rate=24000, hop_length=240,
                 sample_quantum=24000 * 2, transform=None,
                 f0_method: str = "yin", device="cuda"):
        """f0_method: "yin" (batched on the device, ``ops/f0.py``) or
        "world" (host numpy DIO + StoneMask, ``preprocess/world_f0.py``)."""
        if f0_method not in ("yin", "world"):
            raise ValueError(f"f0_method={f0_method!r}: yin or world")
        self.device = resolve_device(device)
        self.sr = sample_rate
        self.hop = hop_length
        self.quantum = sample_quantum
        self.f0_method = f0_method
        self.to_mel = transform or MelSpectrogramTransform(
            sample_rate=sample_rate, hop_length=hop_length)

    def __call__(self, wavs: List[np.ndarray], f0_floor, f0_ceil):
        """wavs: float arrays; f0_floor / f0_ceil: scalars or [B]. Returns
        per-utterance dicts of f0, cf0, vuv [n] and mel [n, n_mels] (numpy
        float32), trimmed to n = (len + n_fft // 2) // hop frames."""
        B = len(wavs)
        Ts = bucket_shape(max(len(w) for w in wavs), self.quantum)
        padded = np.zeros((B, Ts), np.float32)
        for i, w in enumerate(wavs):
            padded[i, : len(w)] = w
        floors = np.broadcast_to(np.asarray(f0_floor, np.float32), (B,))
        ceils = np.broadcast_to(np.asarray(f0_ceil, np.float32), (B,))
        wav_dev = torch.from_numpy(padded).to(self.device)
        with torch.inference_mode():
            if self.f0_method == "world":
                T = 1 + Ts // self.hop
                f0, cf0, vuv = (np.zeros((B, T), np.float32)
                                for _ in range(3))
                for i in range(B):
                    fi, ci, vi = extract_pitch_world(
                        padded[i], self.sr, self.hop,
                        f0_floor=float(floors[i]), f0_ceil=float(ceils[i]))
                    n = min(T, len(fi))
                    f0[i, :n], cf0[i, :n], vuv[i, :n] = (fi[:n], ci[:n],
                                                         vi[:n])
            else:
                f0_dev, _ = extract_f0(
                    wav_dev, sample_rate=self.sr, hop_length=self.hop,
                    f0_floor=torch.tensor(floors, device=self.device),
                    f0_ceil=torch.tensor(ceils, device=self.device))
                # the host's octave fix of the contours, then vuv and cf0
                # from the fixed contour
                f0 = np.stack([
                    fix_f0_contour(row, float(floors[i]), float(ceils[i]))
                    for i, row in enumerate(f0_dev.cpu().numpy())])
                vuv = (f0 > 0).astype(np.float32)
                cf0 = to_log_scale(interp1d(
                    torch.from_numpy(f0).to(self.device))).cpu().numpy()
            mel = self.to_mel(wav_dev).cpu().numpy()
        out = []
        for i, w in enumerate(wavs):
            n = (len(w) + self.to_mel.n_fft // 2) // self.hop
            out.append(dict(f0=f0[i, :n], cf0=cf0[i, :n], vuv=vuv[i, :n],
                            mel=mel[i, :n]))
        return out


def preprocess_corpus(
    data_csv: Path,
    data_root: Path,
    feats_dir: Path,
    mel_dir: Path,
    df_dir: Path,
    f0_stats: Optional[Dict] = None,
    eval_ids=(),
    sample_rate: int = 24000,
    n_fft: int = 512,
    hop_length: int = 240,
    batch_size: int = 16,
    debug: bool = False,
    f0_method: str = "yin",
    device="cuda",
):
    """The whole corpus: durations from the TextGrids, batched F0 + mel on
    ``device``, the global mel statistics, the train/eval CSVs split by
    speaker."""
    feats_dir, mel_dir, df_dir = Path(feats_dir), Path(mel_dir), Path(df_dir)
    finish_marker = df_dir / "finish"
    if finish_marker.exists():
        print("preprocess: already finished (marker present)")
        return

    records = read_csv_rows(data_csv)
    if debug:
        records = records[:50]
    extractor = BatchedFeatureExtractor(sample_rate, hop_length,
                                        f0_method=f0_method, device=device)

    rows, stats = [], MelStats()
    for start in range(0, len(records), batch_size):
        wavs, metas = [], []
        for r in records[start:start + batch_size]:
            spk, utt = r["spk_id"], r["item_name"]
            wav_path = Path(data_root) / spk / "wav24k" / f"{utt}.wav"
            tg_path = Path(data_root) / spk / "textgrid" / f"{utt}.TextGrid"
            if not wav_path.exists() or not tg_path.exists():
                continue
            wav, sr = read_wav(wav_path)
            if sr != sample_rate:
                raise ValueError(f"{wav_path}: {sr} Hz, not {sample_rate}")
            res = process_textgrid(spk, utt, wav, tg_path, sample_rate,
                                   n_fft, hop_length)
            if res is None:
                continue
            seq, durations = res
            wavs.append(wav.astype(np.float32))
            metas.append((r, spk, utt, seq, durations))
        if not wavs:
            continue
        bounds = [(f0_stats or {}).get(m[1], {}) for m in metas]
        feats = extractor(
            wavs, np.asarray([b.get("f0_floor", 60.0) for b in bounds],
                             np.float32),
            np.asarray([b.get("f0_ceil", 600.0) for b in bounds],
                       np.float32))
        for (r, spk, utt, seq, durations), ft in zip(metas, feats):
            n = min(len(ft["mel"]), int(durations.sum()))
            for sub in ("cf0", "vuv"):
                d = feats_dir / spk / sub
                d.mkdir(parents=True, exist_ok=True)
                np.save(d / f"{utt}.npy", ft[sub][:n][None, :])
            md = mel_dir / spk
            md.mkdir(parents=True, exist_ok=True)
            mel = ft["mel"][:n]
            np.save(md / f"{utt}.npy", np.ascontiguousarray(mel.T))
            stats.add(mel)
            rows.append(dict(r, seq=" ".join(str(s) for s in seq),
                             durations=" ".join(str(int(d))
                                                for d in durations)))

    # the mels and their statistics are complete here, so the compute_mel
    # stage becomes an idempotent no-op
    mean = stats.write(mel_dir)

    columns = _columns(data_csv) + ["seq", "durations"]
    df_dir.mkdir(parents=True, exist_ok=True)
    write_csv(df_dir / "data.csv", rows, columns)
    eval_ids = {int(e) for e in eval_ids}
    is_eval = [int(r["spk_id"]) in eval_ids for r in rows]
    write_csv(df_dir / "train.csv",
              [r for r, e in zip(rows, is_eval) if not e], columns)
    write_csv(df_dir / "eval.csv",
              [r for r, e in zip(rows, is_eval) if e], columns)
    finish_marker.write_text("done\n")
    print(f"preprocess: {len(rows)} utterances ({sum(is_eval)} eval), "
          f"stats mean={mean:.3f}")


def split_train_valid(df_dir: Path, filtered_df_dir: Path,
                      valid_frac: float = 0.02, seed: int = 0):
    """Speaker-stratified 98/2 train/val split of ``train.csv``: per
    speaker in integer order, one ``RandomState(seed).permutation``."""
    df_dir, filtered_df_dir = Path(df_dir), Path(filtered_df_dir)
    rows = read_csv_rows(df_dir / "train.csv")
    if not rows:
        raise ValueError(f"{df_dir / 'train.csv'}: no rows to split")
    columns = _columns(df_dir / "train.csv")
    groups: Dict[str, List[Dict[str, str]]] = {}
    for r in rows:
        groups.setdefault(r["spk_id"], []).append(r)
    rng = np.random.RandomState(seed)
    trn, val = [], []
    for spk in sorted(groups, key=_speaker_key):
        g = groups[spk]
        idx = rng.permutation(len(g))
        n_val = max(1, int(len(g) * valid_frac)) if len(g) > 1 else 0
        val += [g[i] for i in idx[:n_val]]
        trn += [g[i] for i in idx[n_val:]]
    filtered_df_dir.mkdir(parents=True, exist_ok=True)
    write_csv(filtered_df_dir / "trn.csv", trn, columns)
    write_csv(filtered_df_dir / "val.csv", val, columns)


def filter_eval(df_dir: Path, filtered_df_dir: Path, hop_length: int = 240,
                sample_rate: int = 24000, min_sec: float = 3.0,
                max_sec: float = 10.0):
    """Keep the eval utterances of ``min_sec`` to ``max_sec`` seconds."""
    df_dir, filtered_df_dir = Path(df_dir), Path(filtered_df_dir)
    rows = read_csv_rows(df_dir / "eval.csv")
    kept = [r for r in rows if min_sec <= sum(
        int(d) for d in r["durations"].split()) * hop_length / sample_rate
        <= max_sec]
    filtered_df_dir.mkdir(parents=True, exist_ok=True)
    write_csv(filtered_df_dir / "eval_filtered.csv", kept,
              _columns(df_dir / "eval.csv"))
    print(f"filter_eval: kept {len(kept)}/{len(rows)}")
