"""DDPM mel decoder: DiffNet denoiser + ancestral sampling.

Counterpart of ``promptttspp_tpu/models/diffusion.py`` (``DiffNet`` and
``GaussianDiffusion.inference``, ancestral path): K linear betas
(1e-4 -> 0.06), epsilon prediction, mel scaled by ``norm_scale``. The K
steps are a Python loop; the per-block conditioner projections depend only
on the conditioning and are computed once per request
(``precompute_cond``). Schedule tables are float32 numpy constants, as in
the JAX package, used as Python scalars per step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.layers import Conv1d


def sinusoidal_pos_emb(t: torch.Tensor, dim: int):
    """Diffusion-step embedding: t [B] -> [B, dim]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -emb)
    arg = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


class ResidualBlock(nn.Module):
    """Dilated conv + gated tanh/sigmoid + conditioner."""

    def __init__(self, encoder_hidden: int, residual_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.diffusion_projection = nn.Linear(residual_channels,
                                              residual_channels)
        self.conditioner_projection = Conv1d(encoder_hidden,
                                             2 * residual_channels, 1)
        self.dilated_conv = Conv1d(residual_channels, 2 * residual_channels,
                                   kernel_size, dilation=dilation)
        self.output_projection = Conv1d(residual_channels,
                                        2 * residual_channels, 1)

    def forward(self, x, cond_proj, diffusion_step):
        """x [B,T,R]; cond_proj [B,T,2R]; diffusion_step [B,R]."""
        y = x + self.diffusion_projection(diffusion_step)[:, None, :]
        gate, filt = (self.dilated_conv(y) + cond_proj).chunk(2, dim=-1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffNet(nn.Module):
    """WaveNet-style epsilon predictor: [B,T,in_dim] noisy mel, [B] step,
    [B,T,H] cond -> [B,T,in_dim]."""

    def __init__(self, in_dim: int = 80, encoder_hidden_dim: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 kernel_size: int = 3, dilation_cycle_length: int = 4):
        super().__init__()
        self.residual_channels = residual_channels
        self.input_projection = Conv1d(in_dim, residual_channels, 1)
        self.mlp = nn.Sequential(
            nn.Linear(residual_channels, residual_channels * 4), nn.Mish(),
            nn.Linear(residual_channels * 4, residual_channels))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(encoder_hidden_dim, residual_channels, kernel_size,
                          2 ** (i % dilation_cycle_length))
            for i in range(residual_layers))
        self.skip_projection = Conv1d(residual_channels, residual_channels, 1)
        self.output_projection = Conv1d(residual_channels, in_dim, 1)

    def precompute_cond(self, cond):
        return [b.conditioner_projection(cond) for b in self.residual_layers]

    def forward(self, x, diffusion_step, cond_projs):
        """cond_projs: ``precompute_cond(cond)``."""
        x = torch.relu(self.input_projection(x))
        t_emb = self.mlp(sinusoidal_pos_emb(diffusion_step,
                                            self.residual_channels))
        skip_sum = 0.0
        for block, cp in zip(self.residual_layers, cond_projs):
            x, skip = block(x, cp, t_emb)
            skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        return self.output_projection(torch.relu(self.skip_projection(x)))


def linear_beta_schedule(timesteps: int, min_beta=1e-4, max_beta=0.06):
    return np.linspace(min_beta, max_beta, timesteps)


class GaussianDiffusion(nn.Module):
    def __init__(self, denoise_fn: DiffNet, out_dim: int, norm_scale: float,
                 K_step: int = 100):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.out_dim = out_dim
        self.K_step = K_step
        self.norm_scale = norm_scale
        betas = linear_beta_schedule(K_step)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        f32 = lambda a: [float(v) for v in np.asarray(a, np.float32)]
        self.sqrt_recip_alphas_cumprod = f32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1_alphas_cumprod = f32(np.sqrt(1.0 / ac - 1.0))
        self.posterior_log_variance_clipped = f32(
            np.log(np.maximum(post_var, 1e-20)))
        self.posterior_mean_coef1 = f32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self.posterior_mean_coef2 = f32(
            (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))

    def p_sample(self, x, t: int, cond_projs, noise):
        """One reverse step at integer step t (same for the whole batch)."""
        steps = torch.full((x.shape[0],), t, dtype=torch.int32,
                           device=x.device)
        eps = self.denoise_fn(x, steps, cond_projs)
        x_recon = (self.sqrt_recip_alphas_cumprod[t] * x
                   - self.sqrt_recipm1_alphas_cumprod[t] * eps)
        x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean = (self.posterior_mean_coef1[t] * x_recon
                + self.posterior_mean_coef2[t] * x)
        if t == 0 or noise is None:
            return mean
        sigma = float(np.float32(np.exp(
            0.5 * np.float32(self.posterior_log_variance_clipped[t]))))
        return mean + sigma * noise

    def inference(self, cond, x_T=None, zero_noise: bool = False,
                  generator=None):
        """cond [B,T,H] -> mel [B,T,out_dim] (denormalized). ``x_T`` and
        ``zero_noise`` give a deterministic decode; otherwise the initial
        state and per-step noise come from ``generator``."""
        B, T = cond.shape[0], cond.shape[1]
        shape = (B, T, self.out_dim)
        if x_T is None:
            x = torch.randn(shape, generator=generator, device=cond.device)
        else:
            x = x_T.to(device=cond.device, dtype=torch.float32)
        cond_projs = self.denoise_fn.precompute_cond(cond)
        for t in range(self.K_step - 1, -1, -1):
            noise = None
            if t > 0 and not zero_noise:
                noise = torch.randn(shape, generator=generator,
                                    device=cond.device)
            x = self.p_sample(x, t, cond_projs, noise)
        return x * self.norm_scale
