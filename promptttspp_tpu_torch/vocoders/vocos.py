"""Vocos (arXiv:2306.00814; the ``charactr/vocos-mel-24khz`` checkpoint that
F5-TTS uses): log-mel [B, T, n_mels] -> 24 kHz waveform [B, T * hop].

A 7-tap convolution to ``dim`` channels, the ConvNeXt backbone of
``nn/convnext.py`` with LayerNorms of eps 1e-6 and layer scale 1 /
num_layers, then ``Linear(dim, n_fft + 2)``: the first half the log
magnitude (exp, clipped at 100), the second the phase; the inverse STFT
with "same" padding (``ops/stft.py::istft``). Runs in float32.

``lengths`` [B] masks each item's frames: the input and every layer's
output are zeroed past them and the inverse STFT leaves those frames
out, so an item of a padded batch gets the samples it gets alone.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.convnext import ConvNeXt1d
from promptttspp_tpu_torch.nn.layers import Conv1d, Linear
from promptttspp_tpu_torch.ops.stft import istft


class Vocos(nn.Module):
    def __init__(self, n_mels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.embed = Conv1d(n_mels, dim, 7)
        self.backbone = ConvNeXt1d(dim, intermediate_dim, num_layers,
                                   eps=1e-6)
        self.head = Linear(dim, n_fft + 2)

    def forward(self, mel, lengths=None):
        """mel [B, T, n_mels] float32; lengths [B] or None -> [B, T *
        hop_length]."""
        B, T, _ = mel.shape
        if lengths is None:
            keep = torch.ones((B, T, 1), dtype=torch.bool, device=mel.device)
        else:
            keep = (torch.arange(T, device=mel.device)[None, :, None]
                    < lengths[:, None, None])
        bb = self.backbone
        x = torch.where(keep, bb.norm_pre(self.embed(
            torch.where(keep, mel, 0.0))), 0.0)
        fmask = keep.to(x.dtype)
        for layer in bb.layers:
            x = layer(x, fmask)
        h = self.head(bb.norm_post(x))
        half = self.n_fft // 2 + 1
        mag = torch.exp(h[..., :half]).clamp(max=100.0)
        phase = h[..., half:]
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft(spec, self.n_fft, self.hop_length, keep[..., 0])
