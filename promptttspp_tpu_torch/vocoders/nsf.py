"""Neural source-filter harmonic excitation.

Counterpart of ``promptttspp_tpu/vocoders/nsf.py``: per-harmonic sines from
the accumulated phase of the fundamental, uv gating, noise, and a
Linear + tanh merge. Harmonic k's phase is k times the fundamental's, so
only the fundamental's phase is accumulated. The accumulation keeps every
intermediate bounded, like ``_frac_cumsum`` there: time is viewed as
[rows, 128], the within-row cumsum runs in float32, and the carry between
rows is a float64 cumsum of the row totals taken mod 1.

Randomness (initial harmonic phases, additive noise) comes from an explicit
``torch.Generator``; ``deterministic=True`` zeroes both.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def frac_cumsum(rad: torch.Tensor) -> torch.Tensor:
    """rad [B, T] -> frac(inclusive cumsum(rad)), bounded intermediates."""
    NL = 128
    B, T = rad.shape
    L = -(-T // NL)
    r = F.pad(rad, (0, L * NL - T)).view(B, L, NL)
    within = torch.cumsum(r, dim=2)
    totals = (within[:, :, -1] % 1.0).double()
    carry = torch.cumsum(totals, dim=1) % 1.0
    carry = F.pad(carry[:, :-1], (1, 0)).to(rad.dtype)  # exclusive
    phi = (within % 1.0 + carry[:, :, None]) % 1.0
    return phi.reshape(B, L * NL)[:, :T]


class SineGen(nn.Module):
    def __init__(self, samp_rate: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.samp_rate = samp_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold

    def forward(self, f0, generator=None, deterministic: bool = False):
        """f0 [B, T, 1] -> (sine_waves [B, T, D], uv [B, T, 1], noise)."""
        B, T, _ = f0.shape
        D = self.harmonic_num + 1
        harmonics = torch.arange(1, D + 1, dtype=f0.dtype, device=f0.device)
        if deterministic:
            rand_ini = f0.new_zeros(B, D)
            noise_unit = f0.new_zeros(B, T, D)
        else:
            rand_ini = torch.rand(B, D, generator=generator, dtype=f0.dtype,
                                  device=f0.device)
            rand_ini[:, 0] = 0.0
            noise_unit = torch.randn(B, T, D, generator=generator,
                                     dtype=f0.dtype, device=f0.device)
        rad = (f0[:, :, 0] / self.samp_rate) % 1.0
        phi = frac_cumsum(rad)
        phases = phi[:, :, None] * harmonics + rand_ini[:, None, :]
        sine_waves = torch.sin(phases * (2 * math.pi)) * self.sine_amp
        uv = (f0 > self.voiced_threshold).to(f0.dtype)
        noise_amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
        noise = noise_amp * noise_unit
        return sine_waves * uv + noise, uv, noise


class SourceModuleHnNSF(nn.Module):
    """Harmonics -> one excitation channel."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshod: float = 0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.l_sin_gen = SineGen(sampling_rate, harmonic_num, sine_amp,
                                 add_noise_std, voiced_threshod)
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0, generator=None, deterministic: bool = False):
        """f0 [B, T, 1] -> (sine_merge [B,T,1], noise [B,T,1], uv [B,T,1])."""
        sine_wavs, uv, _ = self.l_sin_gen(f0, generator, deterministic)
        sine_merge = torch.tanh(self.l_linear(sine_wavs))
        if deterministic:
            noise = torch.zeros_like(uv)
        else:
            noise = torch.randn(uv.shape, generator=generator,
                                dtype=uv.dtype, device=uv.device) \
                * self.sine_amp / 3.0
        return sine_merge, noise, uv
