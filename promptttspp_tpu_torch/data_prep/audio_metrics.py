"""Audio metrics for style pseudo-labeling, without external libraries.

A copy of ``promptttspp_tpu/data_prep/audio_metrics.py`` (host scipy code
there too), which replaces the libraries of the reference's
``data_prep/compute_utt_stats.py``:

- ``perceptual_loudness``: per-frame A-weighted log-power loudness, the
  math of librosa's stft -> perceptual_weighting -> db_to_power ->
  log-mean chain, with the IEC 61672 A-weighting curve in closed form.
- ``integrated_loudness``: ITU-R BS.1770-4 LUFS (K-weighting biquads,
  400 ms blocks with 75% overlap, absolute -70 LUFS and relative -10 LU
  gates), in place of pyloudnorm.
- ``estimate_syllables``: a vowel-group heuristic in place of the
  ``syllables`` package.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sig


# ------------------------------------------------------------ A-weighting
def a_weighting_db(freqs: np.ndarray) -> np.ndarray:
    """IEC 61672 A-weighting in dB at given frequencies (0 dB at 1 kHz)."""
    f = np.asarray(freqs, np.float64)
    f2 = f ** 2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2.0
    num = const[0] * f2 ** 2
    den = (f2 + const[1]) * np.sqrt((f2 + const[2]) * (f2 + const[3])) \
        * (f2 + const[0])
    weights = 2.0 + 20.0 * (np.log10(num) - np.log10(den))
    return weights


def perceptual_loudness(wav: np.ndarray, sample_rate: int,
                        n_fft: int = 1024, hop_length: int = 240):
    """Per-frame A-weighted log loudness (librosa-equivalent chain)."""
    f, t, Z = sig.stft(wav, fs=sample_rate, nperseg=n_fft,
                       noverlap=n_fft - hop_length, boundary="zeros",
                       padded=True, window="hann")
    # scipy stft scales by win.sum(); librosa does not — undo
    win = sig.get_window("hann", n_fft)
    power = (np.abs(Z) * win.sum()) ** 2 + 1e-7
    f = f.copy()
    f[0] += 1e-5
    db = 10.0 * np.log10(power) + a_weighting_db(f)[:, None]
    lin = 10.0 ** (db / 10.0)
    return np.log(np.mean(lin, axis=0) + 1e-5)


# ------------------------------------------------------------------ LUFS
def _k_weighting_coeffs(fs: float):
    """BS.1770-4 pre-filter (shelving) + RLB high-pass, bilinear-matched
    to the target rate from the 48 kHz reference coefficients."""
    # stage 1: spherical-head shelving filter
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    K = np.tan(np.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array([
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0,
    ])
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                        (1.0 - K / Q + K * K) / a0])
    # stage 2: RLB high-pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / fs)
    a0 = 1.0 + K / Q + K * K
    b_hp = np.array([1.0, -2.0, 1.0]) / a0
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                     (1.0 - K / Q + K * K) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(wav: np.ndarray, sample_rate: int,
                        block_size: float = 0.4) -> float:
    """Gated integrated loudness in LUFS (mono input)."""
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sample_rate)
    y = sig.lfilter(bh, ah, sig.lfilter(bs, as_, np.asarray(wav, np.float64)))

    T = len(y) / sample_rate
    if T < block_size:
        block_size = max(T - 0.01, 0.01)
    step = block_size * 0.25  # 75% overlap
    n_blk = int(sample_rate * block_size)
    n_step = max(int(sample_rate * step), 1)
    if len(y) < n_blk:
        return -np.inf
    starts = np.arange(0, len(y) - n_blk + 1, n_step)
    power = np.array([np.mean(y[s:s + n_blk] ** 2) for s in starts])
    loud = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-12))

    keep = loud > -70.0  # absolute gate
    if not keep.any():
        return -np.inf
    ungated = -0.691 + 10.0 * np.log10(np.mean(power[keep]))
    keep2 = keep & (loud > ungated - 10.0)  # relative gate
    if not keep2.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(np.mean(power[keep2])))


# ------------------------------------------------------------- syllables
_VOWELS = set("aeiouy")


def estimate_syllables(word: str) -> int:
    """Heuristic syllable count (vowel groups, silent-e, -le endings)."""
    w = "".join(c for c in word.lower() if c.isalpha())
    if not w:
        return 0
    groups = 0
    prev_vowel = False
    for c in w:
        is_vowel = c in _VOWELS
        if is_vowel and not prev_vowel:
            groups += 1
        prev_vowel = is_vowel
    if w.endswith("e") and not w.endswith(("le", "ee", "ye")) and groups > 1:
        groups -= 1
    if w.endswith("ed") and len(w) > 2 and w[-3] not in _VOWELS \
            and w[-3] not in "td" and groups > 1:
        groups -= 1
    return max(groups, 1)
