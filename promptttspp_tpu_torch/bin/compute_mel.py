"""Mel extraction and the global mel statistics with the port.

Counterpart of ``egs/proposed/bin/compute_mel.py``, with the command line
of ``bin/preprocess.py``. ``bin/preprocess.py`` writes the mels, their
statistics and ``<path.mel_dir>/finish``, so after it this stage does
nothing. Without the marker (the mel tree removed, or another transform)
it extracts the mel of every utterance of ``<path.df_dir>/data.csv`` on
the card, in 1-s sample buckets of ``batch_size`` utterances, and writes
``<path.mel_dir>/<spk>/<utt>.npy`` ([n_mels, T]), ``stats.yaml`` and the
marker. It runs on ``cuda``; ``device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.bin.synthesize import mel_transform
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.data.dataset import read_csv_rows
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.pipeline import MelStats, read_wav


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``)."""
    cfg = conf.compose("preprocess", sys.argv[1:] if argv is None else argv)
    dev = resolve_device(cfg["device"])
    conf.enter_run_dir(cfg)
    to_mel = mel_transform(cfg["transforms"])
    mel_dir = Path(cfg["path"]["mel_dir"])
    if (mel_dir / "finish").exists():
        print("compute_mel: already finished (marker present)")
        return

    records = read_csv_rows(Path(cfg["path"]["df_dir"]) / "data.csv")
    if cfg.get("debug", False):
        records = records[:50]
    stats = MelStats()
    bs = cfg.get("batch_size", 16)
    for start in range(0, len(records), bs):
        wavs, metas = [], []
        for r in records[start:start + bs]:
            spk, utt = r["spk_id"], r["item_name"]
            path = Path(cfg["path"]["data_root"]) / spk / "wav24k" \
                / f"{utt}.wav"
            if not path.exists():
                continue
            wav, sr = read_wav(path)
            if sr != cfg["sample_rate"]:
                raise ValueError(f"{path}: {sr} Hz, not {cfg['sample_rate']}")
            wavs.append(wav.astype(np.float32))
            metas.append((spk, utt))
        if not wavs:
            continue
        Ts = bucket_shape(max(len(w) for w in wavs), cfg["sample_rate"])
        padded = np.zeros((len(wavs), Ts), np.float32)
        for i, w in enumerate(wavs):
            padded[i, :len(w)] = w
        with torch.inference_mode():
            mels = to_mel(torch.from_numpy(padded).to(dev)).cpu().numpy()
        for i, (spk, utt) in enumerate(metas):
            n = (len(wavs[i]) + to_mel.n_fft // 2) // to_mel.hop_length
            mel = mels[i, :n]
            d = mel_dir / spk
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"{utt}.npy", np.ascontiguousarray(mel.T))
            stats.add(mel)
    mean = stats.write(mel_dir)
    print(f"compute_mel: wrote stats (mean={mean:.3f})")


if __name__ == "__main__":
    main()
