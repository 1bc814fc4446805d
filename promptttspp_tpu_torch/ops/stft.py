"""Short-time Fourier transform of a waveform.

Counterpart of ``promptttspp_tpu/ops/stft.py`` (torchaudio's semantics, as
the reference's mel transform uses them): a periodic Hann window of
``win_length`` zero-padded symmetrically to ``n_fft``, centered framing with
reflect padding of ``n_fft // 2`` on both ends, ``torch.fft.rfft`` of each
windowed frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


@functools.lru_cache(maxsize=None)
def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    out = np.zeros(n_fft, dtype=np.float32)
    left = (n_fft - win_length) // 2
    out[left:left + win_length] = hann_window(win_length)
    return out


@functools.lru_cache(maxsize=8)
def _device_window(win_length: int, n_fft: int, device: torch.device):
    # copied to each device once: a copy from host memory waits for the
    # device's queue. A plain (not inference-mode) tensor, so a later
    # autograd use may read it.
    with torch.inference_mode(False):
        return torch.as_tensor(padded_window(win_length, n_fft),
                               device=device)


def frame_signal(wav, n_fft: int, hop_length: int, center: bool = True):
    """[..., Ts] -> [..., n_frames, n_fft], reflect-padded when centered
    (which needs Ts > n_fft // 2)."""
    if center:
        pad = n_fft // 2
        shape = wav.shape
        wav = F.pad(wav.reshape(-1, 1, shape[-1]), (pad, pad),
                    mode="reflect").reshape(*shape[:-1], -1)
    return wav.unfold(-1, n_fft, hop_length)


def stft(wav, n_fft: int, hop_length: int, win_length: int,
         center: bool = True):
    """Complex STFT, [..., n_frames, n_fft // 2 + 1]."""
    frames = frame_signal(wav, n_fft, hop_length, center)
    window = _device_window(win_length, n_fft, wav.device)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1)


def spectrogram(wav, n_fft: int, hop_length: int, win_length: int,
                power: float = 1.0, center: bool = True):
    """Magnitude (power 1) or power spectrogram, [..., n_frames, n_freqs]."""
    s = torch.abs(stft(wav, n_fft, hop_length, win_length, center))
    return s if power == 1.0 else s ** power
