"""F0-aware BigVGAN (the shipped vocoder, ``conf/vocoder/bigvgan_f0.yaml``).

Counterpart of ``promptttspp_tpu/vocoders/bigvgan_f0.py``: F0 repeated x240
(nearest) -> harmonic-plus-noise NSF source -> a strided ``noise_convs``
conv injects the excitation after every transposed-conv upsample; the rest
is BigVGAN.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from perfbench.reference.ptts.nn.layers import Conv1d
from perfbench.reference.ptts.vocoders.bigvgan import BigVGAN
from perfbench.reference.ptts.vocoders.nsf import SourceModuleHnNSF


class F0AwareBigVGAN(BigVGAN):
    def __init__(self, sampling_rate: int = 24000, harmonic_num: int = 8,
                 in_channel: int = 80, upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (6, 5, 4, 2),
                 upsample_kernel_sizes: Sequence[int] = (12, 10, 8, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3,
                 conv_precision: str = "default"):
        super().__init__(in_channel, upsample_initial_channel,
                         upsample_rates, upsample_kernel_sizes,
                         resblock_kernel_sizes, resblock_dilations,
                         conv_precision)
        self.sampling_rate = sampling_rate
        self.m_source = SourceModuleHnNSF(sampling_rate, harmonic_num)
        self.noise_convs = torch.nn.ModuleList()
        n = len(upsample_rates)
        for i in range(n):
            ch = upsample_initial_channel // (2 ** (i + 1))
            if i + 1 < n:
                s = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(Conv1d(1, ch, 2 * s, stride=s,
                                               padding=s // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1, padding=0))

    def forward(self, mel, f0, generator=None, deterministic: bool = False,
                phase0=None):
        """mel [B, T, in_channel]; f0 [B, T, 1] (Hz, 0 = unvoiced)
        -> wav [B, 240*T, 1]. phase0 [B, 1]: initial source phase in
        revolutions (chunk-continuous synthesis, vocoders/streaming.py)."""
        total_up = int(np.prod(self.upsample_rates))
        f0_up = torch.repeat_interleave(f0, total_up, dim=1)
        har_source, _, _ = self.m_source(f0_up, generator, deterministic,
                                         phase0)
        x = self.conv_pre(mel)
        for up, noise_conv, mrf in zip(self.upsamples, self.noise_convs,
                                       self.mrfs):
            x = up(x) + noise_conv(har_source)
            x = mrf(x)
        x = self.act_post(x)
        return torch.tanh(self.conv_post(x))
