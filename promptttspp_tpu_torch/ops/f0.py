"""Batched F0 extraction (YIN) on the card.

Counterpart of ``promptttspp_tpu/ops/f0.py``: the cumulative-mean-normalized
difference function (CMND) of each frame from FFT correlations
(``torch.fft``, cuFFT on the card, as JAX computes its FFTs outside any
Pallas kernel), per-row F0 floor and ceiling masking (per-speaker bounds,
``metadata/libritts_r_f0_stats.yaml``), the first trough below the
threshold else the global minimum, the octave-high guard, and parabolic
refinement. Every shape is static, so one padded batch is one call.

Float32 FFTs round differently on the card and in XLA on the CPU, so a
CMND trough near ``trough_threshold`` or ``voicing_threshold``, or near the
octave guard's thresholds, can flip on a few frames: the port agrees with
JAX on the voicing of almost every frame, and on F0 within float32 rounding
where both voice a frame (``tests/test_torch_f0.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from promptttspp_tpu_torch.ops.interp import interp1d
from promptttspp_tpu_torch.ops.masks import to_log_scale


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _yin_frames(wav: torch.Tensor, hop_length: int, max_lag: int,
                win_length: int):
    """wav [B, Ts] -> CMND [B, n_frames, max_lag] and frame RMS
    [B, n_frames], n_frames = 1 + Ts // hop_length. The two complex
    spectra are the peak of memory (2 x B x n_frames x (nfft/2 + 1)
    complex64); each is freed as soon as it is consumed."""
    B, Ts = wav.shape
    seg = win_length + max_lag
    n_frames = 1 + Ts // hop_length
    # every frame has a full segment; a view, no copy
    wavp = F.pad(wav, (win_length // 2, seg))
    frames = wavp.unfold(-1, seg, hop_length)[:, :n_frames]

    # energy terms: e[tau] = sum_{j=tau}^{tau+W-1} x[j]^2
    csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    e_tau = csum[..., win_length:win_length + max_lag] - csum[..., :max_lag]
    del csum
    e0 = e_tau[..., :1]

    # the windowed correlation sum_{j<W} x[j] x[j+tau], exactly, as the
    # FFT correlation of (frame, frame[:W])
    nfft = _next_pow2(2 * seg)
    specw = torch.fft.rfft(frames[..., :win_length], n=nfft, dim=-1)
    specw.conj_physical_()
    specw.mul_(torch.fft.rfft(frames, n=nfft, dim=-1))
    corr = torch.fft.irfft(specw, n=nfft, dim=-1)[..., :max_lag]
    del specw
    d = torch.clamp(e0 + e_tau - 2.0 * corr, min=0.0)
    del corr

    # cumulative mean normalization; silence gives a 0 denominator
    denom = torch.cumsum(d[..., 1:], dim=-1) / torch.arange(
        1, max_lag, dtype=wav.dtype, device=wav.device)
    cmnd = torch.cat([torch.ones_like(d[..., :1]),
                      d[..., 1:] / torch.clamp(denom, min=1e-12)], dim=-1)
    rms = torch.sqrt(e0[..., 0] / win_length)
    return cmnd, rms


def _bounds(value, B: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] bound -> [B] in ``like``'s dtype, on its device."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).expand(B)


def _take(cmnd: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(cmnd, -1, idx[..., None])[..., 0]


def extract_f0(
    wav: torch.Tensor,
    sample_rate: int = 24000,
    hop_length: int = 240,
    f0_floor=60.0,
    f0_ceil=600.0,
    trough_threshold: float = 0.25,
    voicing_threshold: float = 0.35,
    rms_floor: float = 0.01,
    lag_search_floor: float = 40.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav [B, Ts] or [Ts] (float, ±1 range) -> (f0 [B, T], vuv [B, T]
    float32), T = 1 + Ts // hop_length, on the wav's device.
    ``f0_floor`` / ``f0_ceil`` are scalars or [B] (per-speaker bounds)."""
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    B = wav.shape[0]
    f0_floor = _bounds(f0_floor, B, wav)
    f0_ceil = _bounds(f0_ceil, B, wav)

    max_lag = int(round(sample_rate / lag_search_floor))
    win_length = max_lag
    cmnd, rms = _yin_frames(wav, hop_length, max_lag, win_length)

    # a true division: ``sample_rate / tensor`` multiplies by the
    # reciprocal, which moves a bound such as 24000 / 500 off its lag
    sr = torch.tensor(float(sample_rate), dtype=wav.dtype, device=wav.device)
    lags = torch.arange(max_lag, dtype=wav.dtype, device=wav.device)
    lag_min = (sr / f0_ceil)[:, None, None]  # [B, 1, 1]
    lag_max = (sr / f0_floor)[:, None, None]
    inf = torch.tensor(float("inf"), dtype=wav.dtype, device=wav.device)
    masked = torch.where((lags >= lag_min) & (lags <= lag_max), cmnd, inf)

    # YIN's rule: the first local minimum (trough) below the threshold,
    # else the global minimum
    left = F.pad(masked[..., :-1], (1, 0), value=float("inf"))
    right = F.pad(masked[..., 1:], (0, 1), value=float("inf"))
    is_trough = (masked <= left) & (masked <= right) & torch.isfinite(masked)
    del left, right
    below = is_trough & (masked < trough_threshold)
    idx = torch.arange(max_lag, device=wav.device)
    first_below = torch.where(below, idx, max_lag).amin(-1)
    # the first minimum, as jnp.argmin; an all-inf row gives 0
    global_min = torch.argmin(masked, dim=-1)
    del masked, below, is_trough
    tau = torch.where(first_below < max_lag, first_below, global_min)

    # the octave-high (half-period) guard: jump to 2 tau only where the
    # depths alternate (tau and 3 tau moderate, 2 tau decisively deeper)
    def _minw(t, w=4):
        tc = t.clamp(1 + w, max_lag - 1 - w)
        vals = torch.stack([_take(cmnd, tc + o) for o in range(-w, w + 1)],
                           dim=-1)
        m, off = torch.min(vals, dim=-1)
        return tc + off - w, m

    cm_tau = _take(cmnd, tau)
    tau2, cm_tau2 = _minw(2 * tau)
    _, cm_tau3 = _minw(3 * tau)
    in_lag = (2 * tau).to(wav.dtype) <= lag_max[..., 0]
    in_lag3 = 3 * tau <= max_lag - 5
    jump = (in_lag & in_lag3 & (cm_tau > 0.08)
            & (cm_tau2 < 0.5 * torch.minimum(cm_tau, cm_tau3)))
    tau = torch.where(jump, tau2, tau)

    # parabolic interpolation around tau
    tau_c = tau.clamp(1, max_lag - 2)
    d0, d1, d2 = (_take(cmnd, tau_c + o) for o in (-1, 0, 1))
    denom = d0 + d2 - 2.0 * d1
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (d0 - d2) / denom,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    refined = tau_c.to(wav.dtype) + shift

    f0 = sr / torch.clamp(refined, min=1.0)
    voiced = ((_take(cmnd, tau) < voicing_threshold)
              & (rms > rms_floor)
              & (f0 >= f0_floor[:, None] * 0.9)
              & (f0 <= f0_ceil[:, None] * 1.1))
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    vuv = voiced.to(torch.float32)
    if squeeze:
        return f0[0], vuv[0]
    return f0, vuv


def extract_pitch(wav, sample_rate: int, hop_length: int, f0_floor,
                  f0_ceil):
    """The reference's shape of result: (f0, cf0, vuv) with cf0 the log of
    the gap-interpolated f0."""
    f0, vuv = extract_f0(wav, sample_rate=sample_rate,
                         hop_length=hop_length, f0_floor=f0_floor,
                         f0_ceil=f0_ceil)
    return f0, to_log_scale(interp1d(f0)), vuv
