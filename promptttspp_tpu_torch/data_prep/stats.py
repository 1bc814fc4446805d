"""Per-utterance statistics and style pseudo-labeling.

Counterpart of ``promptttspp_tpu/data_prep/stats.py`` (the reference's
``data_prep/compute_utt_stats.py:32-212`` and
``add_style_prompt_tags.py:48-294``): per-utterance LUFS, per-frame
A-weighted loudness, F0 mean and spread (the port's YIN at a 5-ms hop, on
the card, in place of pyworld) and the syllable rate of the MFA words tier;
then gender-conditioned z-normalization, 5-level labels at the ±0.5 / ±1.3
thresholds and the ``{M,F}_p-X_s-Y_e-Z`` style keys.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from promptttspp_tpu_torch.data_prep.audio_metrics import (
    estimate_syllables, integrated_loudness, perceptual_loudness)
from promptttspp_tpu_torch.ops.f0 import extract_f0
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.textgrid import read_textgrid


def compute_speaking_rate(textgrid_path) -> float:
    """Syllables per second of speech (silence excluded)
    (`compute_utt_stats.py:32-61`)."""
    labels = read_textgrid(str(textgrid_path), "words")
    if len(labels) < 2:
        return -1
    start_time = None
    num_syllables = 0
    sil_dur = 0.0
    for label in labels:
        if start_time is None and len(label.name) > 0:
            start_time = label.start
        if len(label.name) > 0:
            num_syllables += estimate_syllables(label.name)
        else:
            sil_dur += label.stop - label.start
    end_time = labels[-1].stop
    denom = end_time - (start_time or 0.0) - sil_dur
    if denom <= 0:
        return -1
    return round(num_syllables / denom, 2)


def compute_utt_stats(wav: np.ndarray, sample_rate: int, textgrid_path,
                      f0_floor: float = 70.0, f0_ceil: float = 800.0,
                      device="cuda") -> Dict:
    """One utterance's raw stats dict (`compute_utt_stats.py:96-158`); the
    F0 (YIN at a 5-ms hop) on ``device`` (``cuda`` unless given
    ``"cpu"``)."""
    invalid = 0
    block_size = min(0.4, len(wav) / sample_rate - 0.01)
    loudness_lufs = round(
        integrated_loudness(wav, sample_rate, block_size=block_size), 2)
    frame_loud = perceptual_loudness(
        wav, sample_rate, n_fft=1024, hop_length=int(sample_rate * 0.010))

    hop5ms = int(sample_rate * 0.005)
    with torch.inference_mode():
        f0, _ = extract_f0(
            torch.from_numpy(np.asarray(wav, np.float32)[None]).to(
                resolve_device(device)),
            sample_rate=sample_rate, hop_length=hop5ms, f0_floor=f0_floor,
            f0_ceil=f0_ceil)
    f0 = f0[0].cpu().numpy()
    f0_v = f0[f0 > 0]
    if len(f0_v) == 0:
        f0_mean, f0_scale, lf0_mean, lf0_scale = 0.0, 1.0, 0.0, 1.0
        invalid = 1
    else:
        lf0_v = np.log(f0_v)
        f0_mean, f0_scale = np.mean(f0_v), np.std(f0_v)
        lf0_mean, lf0_scale = np.mean(lf0_v), np.std(lf0_v)

    speaking_rate = compute_speaking_rate(textgrid_path)
    if speaking_rate < 0:
        invalid = 1

    return {
        "raw_loudness_lufs": round(float(loudness_lufs), 2),
        "raw_loudness_mean": round(float(frame_loud.mean()), 2),
        "raw_loudness_scale": round(float(frame_loud.std()), 2),
        "raw_f0_mean": round(float(f0_mean), 2),
        "raw_f0_scale": round(float(f0_scale), 2),
        "raw_lf0_mean": round(float(lf0_mean), 2),
        "raw_lf0_scale": round(float(lf0_scale), 2),
        "raw_speaking_rate": round(float(speaking_rate), 2),
        "invalid": invalid,
    }


# ------------------------------------------------------- pseudo labeling
def norm2label(val: float, level: int = 3, labels=None) -> str:
    """(`add_style_prompt_tags.py:48-87`)."""
    if labels is None:
        labels = ["low", "normal", "high"]
    if level == 3:
        if val < -0.7:
            return labels[0]
        if val > 0.7:
            return labels[2]
        return labels[1]
    if level == 5:
        if val < -1.3:
            return f"very {labels[0]}"
        if val < -0.5:
            return labels[0]
        if val < 0.5:
            return labels[1]
        if val < 1.3:
            return labels[2]
        return f"very {labels[2]}"
    raise ValueError(level)


class GenderScaler:
    """Gender-conditioned z-normalizer (StandardScaler equivalent)."""

    def __init__(self):
        self.mean: Dict[str, float] = {}
        self.std: Dict[str, float] = {}

    def fit(self, values_by_gender: Dict[str, list]):
        for g, vals in values_by_gender.items():
            arr = np.asarray(vals, np.float64)
            self.mean[g] = float(arr.mean()) if len(arr) else 0.0
            self.std[g] = float(arr.std()) if len(arr) else 1.0
        return self

    def normalize(self, value: float, gender: str) -> float:
        return (value - self.mean[gender]) / max(self.std[gender], 1e-12)


def pseudo_label(value: float, gender: str, scaler: GenderScaler,
                 labels, level: int = 5) -> str:
    return norm2label(scaler.normalize(value, gender), level=level,
                      labels=labels)


def style_key(gender: str, pitch: str, speed: str, energy: str) -> str:
    """5-level labels -> 3-level style key (`add_style_prompt_tags.py:258`)."""
    p3 = pitch.replace("very", "").strip()
    s3 = speed.replace("very", "").strip()
    e3 = energy.replace("very", "").strip()
    return f"{gender}_p-{p3}_s-{s3}_e-{e3}"
