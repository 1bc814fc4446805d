"""Short-time Fourier transform of a waveform.

Counterpart of ``promptttspp_tpu/ops/stft.py`` (torchaudio's semantics, as
the reference's mel transform uses them): a periodic Hann window of
``win_length`` zero-padded symmetrically to ``n_fft``, centered framing with
reflect padding of ``n_fft // 2`` on both ends (reflected again as often as
needed, as ``jnp.pad(mode="reflect")`` does, so a signal of any length
``Ts >= 1`` frames), ``torch.fft.rfft`` of each windowed frame.

``istft`` inverts a spectrogram with Vocos's "same" padding: ``irfft`` of
each frame (the imaginary parts of its DC and Nyquist bins left out), the
periodic Hann window of ``n_fft``, overlap-add, a trim of
``(n_fft - hop) // 2`` samples at each end and a division by the window's
squared overlap-add, so T frames give T * hop samples.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices into a signal of ``n >= 1`` samples that pad it by ``pad``
    on both ends by repeated reflection, as ``jnp.pad(mode="reflect")``
    does: positions ``-pad .. n - 1 + pad`` folded with period
    ``2 (n - 1)`` (all 0 when ``n == 1``). Built on ``device`` from Python
    ints, so it reads nothing back from the device."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


def frame_signal(wav, n_fft: int, hop_length: int, center: bool = True):
    """[..., Ts] -> [..., n_frames, n_fft]. Centered, the signal is first
    padded by ``n_fft // 2`` on each end by repeated reflection, so any
    ``Ts >= 1`` frames."""
    if center:
        wav = wav.index_select(
            -1, reflect_index(wav.shape[-1], n_fft // 2, wav.device))
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


def _overlap_add(frames, hop_length: int):
    """[B, T, n] frames -> [B, (T - 1) * hop + n], summed where they
    overlap (``F.fold``, in a fixed order per sample)."""
    B, T, n = frames.shape
    out = torch.nn.functional.fold(
        frames.transpose(1, 2), output_size=(1, (T - 1) * hop_length + n),
        kernel_size=(1, n), stride=(1, hop_length))
    return out.reshape(B, -1)


def _hermitian(spec, n_fft: int):
    """``spec`` with the imaginary parts of its DC bin (and, for an even
    ``n_fft``, its Nyquist bin) set to 0. A real signal's spectrum has
    none there, and the inverse real FFT leaves them out by definition;
    cuFFT's C2R transforms read them as their algorithm happens to, which
    changes with the batch's shape, so they are cleared first."""
    keep = torch.ones(spec.shape[-1], dtype=torch.bool, device=spec.device)
    keep[0] = False
    if n_fft % 2 == 0:
        keep[-1] = False
    return torch.complex(spec.real, torch.where(keep, spec.imag, 0.0))


def istft(spec, n_fft: int, hop_length: int, frame_mask=None):
    """Complex [B, T, n_fft // 2 + 1] -> waveform [B, T * hop_length] with
    "same" padding (module docstring). ``frame_mask`` bool [B, T] leaves
    out the frames past each item's end, from the sum and from the
    window's envelope, so an item padded in a batch gets the samples it
    gets alone; past its end, its last frame's tail, then 0."""
    window = _device_window(n_fft, n_fft, spec.device)
    frames = torch.fft.irfft(_hermitian(spec, n_fft), n=n_fft, dim=-1) \
        * window
    square = (window * window).expand(frames.shape)
    if frame_mask is not None:
        keep = frame_mask[..., None]
        frames = torch.where(keep, frames, 0.0)
        square = torch.where(keep, square, 0.0)
    pad = (n_fft - hop_length) // 2
    y = _overlap_add(frames, hop_length)[:, pad:-pad]
    env = _overlap_add(square, hop_length)[:, pad:-pad]
    return torch.where(env > 1e-11, y / env.clamp(min=1e-11), 0.0)
