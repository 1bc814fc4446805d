"""Mel filterbanks (Slaney or HTK scale) and the log-mel transform.

Counterpart of ``promptttspp_tpu/ops/mel.py``: torchaudio's MelSpectrogram
with ``mel_scale='slaney', norm='slaney'`` and ``clamp_min(1e-5).log()``,
the reference's transform (``conf/transforms/mel.yaml``). The filterbank is
built in numpy, in float64 then cast to float32, as the JAX package builds
it; the projection is one [T, n_freqs] x [n_freqs, n_mels] product.
Output is time-major, [..., T, n_mels].

``mel_scale="htk"`` with ``norm=None`` is torchaudio's default, the
features of Vocos and F5-TTS (``VOCOS_MEL``): mel = 2595 log10(1 + f /
700), triangles of peak 1 without area normalisation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from promptttspp_tpu_torch.ops import stft as stft_ops


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    15.0 + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    3.0 * f / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
                    200.0 * m / 3.0)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


_SCALES = {"slaney": (_hz_to_mel_slaney, _mel_to_hz_slaney),
           "htk": (_hz_to_mel_htk, _mel_to_hz_htk)}


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
                   f_max: float, mel_scale: str = "slaney",
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """[n_freqs, n_mels] triangles on ``mel_scale`` ("slaney" or "htk"),
    area-normalized when ``norm`` is "slaney", of peak 1 when None."""
    if mel_scale not in _SCALES or norm not in ("slaney", None):
        raise ValueError(f"mel_scale {mel_scale!r}, norm {norm!r}: "
                         "'slaney' or 'htk', 'slaney' or None")
    to_mel, to_hz = _SCALES[mel_scale]
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2)
    f_pts = to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm is None:
        return fb.astype(np.float32)
    enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])  # area-normalize
    return (fb * enorm[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_fbank(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm,
                  device):
    # copied to each device once: a copy from host memory waits for the
    # device's queue. A plain (not inference-mode) tensor, so a later
    # autograd use may read it.
    with torch.inference_mode(False):
        return torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels,
                                              f_min, f_max, mel_scale, norm),
                               device=device)


@dataclass(frozen=True)
class MelSpectrogramTransform:
    """Log-mel of a waveform with the reference's defaults."""

    sample_rate: int = 24000
    n_fft: int = 512
    win_length: int = 480
    hop_length: int = 240
    power: float = 1.0
    f_min: float = 63.0
    f_max: float = 12000.0
    n_mels: int = 80
    center: bool = True
    mel_scale: str = "slaney"
    norm: Optional[str] = "slaney"

    def to_spec(self, wav):
        """wav [..., Ts] -> spectrogram [..., T, n_freqs]."""
        return stft_ops.spectrogram(wav, self.n_fft, self.hop_length,
                                    self.win_length, self.power, self.center)

    def spec_to_mel(self, spec):
        """[..., T, n_freqs] -> log-mel [..., T, n_mels]."""
        fb = _device_fbank(self.sample_rate, self.n_fft, self.n_mels,
                           self.f_min, self.f_max, self.mel_scale, self.norm,
                           spec.device)
        return torch.log(torch.clamp(spec @ fb, min=1e-5))

    def to_mel(self, wav):
        return self.spec_to_mel(self.to_spec(wav))

    def __call__(self, wav):
        return self.to_mel(wav)


# the features of Vocos (charactr/vocos-mel-24khz) and F5-TTS:
# torchaudio's MelSpectrogram(24000, n_fft=1024, hop_length=256, n_mels=100,
# power=1), then clamp(1e-5).log()
VOCOS_MEL = MelSpectrogramTransform(
    sample_rate=24000, n_fft=1024, win_length=1024, hop_length=256,
    f_min=0.0, f_max=12000.0, n_mels=100, mel_scale="htk", norm=None)
