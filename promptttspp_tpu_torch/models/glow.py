"""The Glow normalizing flow over ``[B, T, C]`` (T = 1 for the style
vectors it was written for): invertible 1x1 convolutions alternating with
affine couplings.

Counterpart of ``promptttspp_tpu/models/glow.py``. The log-determinant
terms follow the reference, summed over the batch too. The 1x1
convolution takes ``slogdet`` and ``inv`` of its C x C weight. Both
directions run under ``models/diffusion.py::float32_math``, so that on the
card their products are float32 and not TF32, whatever the caller's flags.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.diffusion import float32_math
from promptttspp_tpu_torch.nn.layers import Linear


class ActNorm(nn.Module):
    """Per-channel scale and shift, zero-initialized (the reference's
    flow stack leaves it out)."""

    def __init__(self, channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, z, log_df_dz, reverse: bool = False, g=None):
        if reverse:
            return ((z - self.bias) * torch.exp(-self.log_scale),
                    log_df_dz - self.log_scale.sum())
        return (z * torch.exp(self.log_scale) + self.bias,
                log_df_dz + self.log_scale.sum())


class Invertible1x1Conv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(nn.init.orthogonal_(
            torch.empty(channels, channels)))

    def forward(self, z, log_df_dz, reverse: bool = False, g=None):
        logdet = torch.linalg.slogdet(self.weight)[1]
        if reverse:
            return (z @ torch.linalg.inv(self.weight).T,
                    log_df_dz - logdet)
        return z @ self.weight.T, log_df_dz + logdet


class ResBlockLinear(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.net = nn.Sequential(nn.ReLU(), Linear(in_channels, out_channels),
                                 nn.ReLU(), Linear(out_channels,
                                                   out_channels))
        self.bridge = (Linear(in_channels, out_channels)
                       if in_channels != out_channels else None)

    def forward(self, x):
        return (x if self.bridge is None else self.bridge(x)) + self.net(x)


class MLP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 base_filters: int = 256, n_blocks: int = 2,
                 gin_channels: int = 0):
        super().__init__()
        self.in_block = nn.Sequential(Linear(in_channels, base_filters))
        self.cond_layer = (Linear(gin_channels, base_filters)
                           if gin_channels > 0 else None)
        self.mid_block = nn.ModuleList(
            ResBlockLinear(base_filters, base_filters)
            for _ in range(n_blocks))
        self.out_block = nn.Sequential(nn.ReLU(),
                                       Linear(base_filters, out_channels))

    def forward(self, x, g=None):
        x = self.in_block(x)
        if g is not None and self.cond_layer is not None:
            x = x + self.cond_layer(g)
        for block in self.mid_block:
            x = block(x)
        return self.out_block(x)


class AffineCoupling(nn.Module):
    def __init__(self, in_channels: int, channels: int, n_blocks: int = 2,
                 gin_channels: int = 0):
        super().__init__()
        self.split = in_channels // 2
        self.start = Linear(in_channels - self.split, channels)
        self.net = MLP(channels, channels, n_blocks=n_blocks,
                       gin_channels=gin_channels)
        self.end = Linear(channels, in_channels)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)

    def forward(self, z, log_df_dz, reverse: bool = False, g=None):
        z0, z1 = z[..., :self.split], z[..., self.split:]
        params = self.end(self.net(self.start(z1), g=g))
        t, logs = params[..., :self.split], params[..., self.split:]
        if reverse:
            z0 = (z0 - t) * torch.exp(-logs)
            log_df_dz = log_df_dz - logs.sum()
        else:
            z0 = z0 * torch.exp(logs) + t
            log_df_dz = log_df_dz + logs.sum()
        return torch.cat([z0, z1], dim=-1), log_df_dz


class Glow(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_flows: int,
                 n_blocks: int, gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(num_flows):
            self.flows.append(Invertible1x1Conv(in_channels))
            self.flows.append(AffineCoupling(in_channels, channels, n_blocks,
                                             gin_channels))

    def forward(self, z, g=None):
        """z [B, T, C] -> (the flow's output, its log-determinant)."""
        log_df_dz = z.new_zeros(())
        with float32_math():
            for flow in self.flows:
                z, log_df_dz = flow(z, log_df_dz, reverse=False, g=g)
        return z, log_df_dz

    def reverse(self, y, g=None):
        log_df_dz = y.new_zeros(())
        with float32_math():
            for flow in reversed(self.flows):
                y, log_df_dz = flow(y, log_df_dz, reverse=True, g=g)
        return y, log_df_dz
