"""The nnsvs-style diffusion decoder with classifier-free guidance, over
``[B, T, C]``.

Counterpart of ``promptttspp_tpu/models/nnsvs_diffusion.py``:

- ``DiffNetG``: the WaveNet-like denoiser with a speaker or style
  embedding ``g``, l2-normalized, swapped for a learned null embedding
  where ``g`` is a zero row (the unconditional half of a guided batch), or
  where training drops it (one draw for the batch, probability
  ``g_dropout``); projected and either concatenated to the step embedding
  or, with ``cond_norm``, fed to a FiLM LayerNorm in every block
  (``CondLayerNorm``); ``scaled_tanh`` bounds the output to +-0.5 log 2
  (the residual-F0 mode);
- ``GaussianDiffusionCFG``: ``pred_noise`` or ``pred_x0`` training, and
  ancestral or PLMS sampling, guided by ``eps_uncond + s * (eps_cond -
  eps_uncond)`` over a doubled batch.

As in ``models/diffusion.py`` the schedule tables are float32 constants
used as Python scalars per step, the K steps are a Python loop, the
blocks' conditioner projections are computed once per decode
(``DiffNetG.precompute_cond``), and the sampler runs in full float32
(``float32_math``). PLMS calls the denoiser twice at its first step and
once at every later one, as JAX's scan does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.diffusion import (
    _SCHEDULES, _device_table, float32_math, schedule_tables,
    sinusoidal_pos_emb)
from promptttspp_tpu_torch.nn.layers import Conv1d, Linear, Mish


def _l2norm(x, eps: float = 1e-12):
    return x / torch.clamp(x.square().sum(-1, keepdim=True).sqrt(), min=eps)


class CondLayerNorm(nn.Module):
    """Parameter-free LayerNorm over the channels, then FiLM from the
    conditioning embedding; gamma and beta start at zero."""

    def __init__(self, in_dim: int, cond_dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = Linear(cond_dim, in_dim)
        self.beta = Linear(cond_dim, in_dim)
        for layer in (self.gamma, self.beta):
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x, g):
        """x [B, T, C]; g [B, cond_dim] or [B, T, cond_dim]."""
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        normalized = (x - mean) / torch.sqrt(var + self.eps)
        gamma, beta = self.gamma(g), self.beta(g)
        if gamma.ndim == 2:
            gamma, beta = gamma[:, None], beta[:, None]
        return normalized * (1.0 + gamma) + beta


class ResidualBlockG(nn.Module):
    def __init__(self, encoder_hidden: int, residual_channels: int,
                 dilation: int, step_dim: int, gin_channels: int = 0,
                 g_proj_dim: int = 128, cond_norm: bool = False):
        super().__init__()
        R = residual_channels
        self.diffusion_projection = Linear(step_dim, R)
        self.conditioner_projection = Conv1d(encoder_hidden, 2 * R, 1)
        self.norm = (CondLayerNorm(R, g_proj_dim)
                     if cond_norm and gin_channels > 0 else None)
        self.dilated_conv = Conv1d(R, 2 * R, 3, dilation=dilation)
        self.output_projection = Conv1d(R, 2 * R, 1)

    def forward(self, x, cond_proj, diffusion_step, g=None):
        """cond_proj: ``conditioner_projection`` of the conditioning."""
        step = self.diffusion_projection(diffusion_step)
        y = x if self.norm is None else self.norm(x, g)
        y = self.dilated_conv(y + step[:, None, :]) + cond_proj
        gate, filt = y.chunk(2, dim=-1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffNetG(nn.Module):
    def __init__(self, in_dim: int = 80, encoder_hidden_dim: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 4, scaled_tanh: bool = False,
                 gin_channels: int = 0, g_proj_dim: int = 128,
                 g_dropout: float = 0.0, cond_norm: bool = False,
                 time_varying_emb: bool = False):
        super().__init__()
        R = residual_channels
        self.residual_channels = R
        self.scaled_tanh = scaled_tanh
        self.gin_channels, self.g_dropout = gin_channels, g_dropout
        self.cond_norm, self.time_varying_emb = cond_norm, time_varying_emb
        self.input_projection = Conv1d(in_dim, R, 1)
        self.mlp = nn.Sequential(Linear(R, R * 4), Mish(),
                                 Linear(R * 4, R))
        step_dim = R
        if gin_channels > 0:
            self.null_embedding = nn.Parameter(torch.randn(gin_channels))
            self.g_projection = Linear(gin_channels, g_proj_dim)
            if not cond_norm:
                step_dim += g_proj_dim
        self.residual_layers = nn.ModuleList(
            ResidualBlockG(encoder_hidden_dim, R,
                           2 ** (i % dilation_cycle_length), step_dim,
                           gin_channels, g_proj_dim, cond_norm)
            for i in range(residual_layers))
        self.skip_projection = Conv1d(R, R, 1)
        self.output_projection = Conv1d(R, in_dim, 1)

    def _g_input(self, g, generator=None):
        """The embedding the projection reads: ``g`` l2-normalized, the
        null embedding for a dropped batch (training) and for zero rows
        (inference)."""
        if not self.time_varying_emb and g.ndim == 3:
            g = g[:, 0, :]
        null = _l2norm(self.null_embedding).expand(g.shape)
        if self.g_dropout >= 1.0:
            return null
        g_inp = _l2norm(g)
        if self.training:
            if self.g_dropout > 0.0 and bool(torch.rand(
                    (), generator=generator, device=g.device)
                    < self.g_dropout):
                return null
            return g_inp
        is_null = g.abs().sum(-1, keepdim=True) == 0
        return torch.where(is_null, null, g_inp)

    def precompute_cond(self, cond):
        """The blocks' conditioner projections [B, T, 2R]: they depend on
        the conditioning alone, so a decode computes them once."""
        return [b.conditioner_projection(cond) for b in self.residual_layers]

    def forward(self, x, diffusion_step, cond, g=None, generator=None,
                cond_projs=None):
        """x [B, T, in_dim]; diffusion_step [B]; cond [B, T, H] (or None
        with ``cond_projs``, its ``precompute_cond``); g [B, 1, gin] or
        [B, T, gin] -> [B, T, in_dim]. In train mode the classifier-free
        drop of ``g`` draws from ``generator``."""
        if cond_projs is None:
            cond_projs = self.precompute_cond(cond)
        x = torch.relu(self.input_projection(x))
        t_emb = self.mlp(sinusoidal_pos_emb(diffusion_step,
                                            self.residual_channels))
        g_proj = None
        if self.gin_channels > 0:
            g_proj = self.g_projection(self._g_input(g, generator))
            if not self.cond_norm:
                t_emb = torch.cat([t_emb, g_proj], dim=-1)
        skip_sum = 0.0
        for block, cond_proj in zip(self.residual_layers, cond_projs):
            x, skip = block(x, cond_proj, t_emb, g=g_proj)
            skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = self.output_projection(torch.relu(self.skip_projection(x)))
        if self.scaled_tanh:
            x = (600 * np.log(2) / 1200) * torch.tanh(x)
        return x


class GaussianDiffusionCFG(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, denoise_fn: DiffNetG,
                 K_step: int = 100, schedule_type: str = "linear",
                 norm_scale: float = 1.0, pndm_speedup: Optional[int] = None,
                 objective: str = "pred_noise",
                 do_classifier_free_guidance: bool = False,
                 guidance_scale: float = 1.0, clip_denoised: bool = True,
                 a_min: Optional[float] = None,
                 a_max: Optional[float] = None):
        super().__init__()
        if schedule_type not in _SCHEDULES:
            raise ValueError(f"schedule_type {schedule_type!r}: one of "
                             f"{sorted(_SCHEDULES)}")
        if objective not in ("pred_noise", "pred_x0"):
            raise ValueError(f"objective {objective!r}: 'pred_noise' or "
                             "'pred_x0'")
        if do_classifier_free_guidance and objective != "pred_noise":
            raise ValueError("CFG requires pred_noise objective")
        self.denoise_fn = denoise_fn
        self.out_dim, self.K_step = out_dim, K_step
        self.schedule_type = schedule_type
        self.norm_scale = norm_scale
        self.pndm_speedup = int(pndm_speedup) if pndm_speedup else None
        self.objective = objective
        self.cfg = do_classifier_free_guidance
        self.guidance_scale = guidance_scale
        self.clip_denoised = clip_denoised
        self.a_min, self.a_max = a_min, a_max
        tables = schedule_tables(K_step, schedule_type)
        for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod",
                     "sqrt_recipm1_alphas_cumprod",
                     "posterior_log_variance_clipped", "posterior_mean_coef1",
                     "posterior_mean_coef2"):
            setattr(self, name, np.asarray(tables[name], np.float32))

    def _norm(self, x):
        if self.a_min is not None:
            return (x - self.a_min) / (self.a_max - self.a_min) * 2 - 1
        return x / self.norm_scale

    def _denorm(self, x):
        if self.a_min is not None:
            return (x + 1) / 2 * (self.a_max - self.a_min) + self.a_min
        return x * self.norm_scale

    def q_sample(self, x_start, t, noise):
        """x_start, noise [B, T, C]; t int [B] -> the noisy x_t."""
        c1, c2 = (_device_table(name, self.K_step, self.schedule_type,
                                x_start.device)[t][:, None, None]
                  for name in ("sqrt_alphas_cumprod",
                               "sqrt_one_minus_alphas_cumprod"))
        return c1 * x_start + c2 * noise

    def forward(self, cond, y, g=None, mask=None, t=None, noise=None,
                generator=None):
        """Training: cond [B, T, H]; y [B, T, out_dim] -> (target,
        model_out): the noise or the normalized y, as ``objective`` says.
        ``t`` [B] and ``noise`` are drawn from ``generator`` when not
        given, t first; ``mask`` is not read, as in JAX."""
        B = cond.shape[0]
        if t is None:
            t = torch.randint(0, self.K_step, (B,), generator=generator,
                              device=cond.device)
        x_start = self._norm(y)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                dtype=x_start.dtype, device=x_start.device)
        model_out = self.denoise_fn(self.q_sample(x_start, t, noise), t,
                                    cond, g=g, generator=generator)
        return (noise if self.objective == "pred_noise" else x_start,
                model_out)

    def _cond_input(self, cond, g):
        """What every denoiser call of a decode reads: the conditioner
        projections and ``g``, for the doubled batch under guidance (its
        first half with zero ``g``)."""
        projs = self.denoise_fn.precompute_cond(cond)
        if not self.cfg:
            return projs, g
        return ([torch.cat([p, p]) for p in projs],
                torch.cat([torch.zeros_like(g), g]))

    def _net(self, x, t: int, cond_input):
        """The denoiser at integer step ``t`` on ``_cond_input``'s batch."""
        steps = torch.full((x.shape[0],), t, dtype=torch.int32,
                           device=x.device)
        projs, g = cond_input
        return self.denoise_fn(x, steps, None, g=g, cond_projs=projs)

    def _pred_noise(self, x, t: int, cond_input):
        """The (guided) epsilon at integer step ``t``: one denoiser call,
        on the doubled batch under guidance."""
        if not self.cfg:
            return self._net(x, t, cond_input)
        eps_uncond, eps_cond = self._net(torch.cat([x, x]), t,
                                         cond_input).chunk(2, dim=0)
        return eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)

    def _p_mean(self, x, t: int, cond_input):
        """The posterior mean at integer step ``t``."""
        if self.objective == "pred_noise":
            eps = self._pred_noise(x, t, cond_input)
            x0 = (float(self.sqrt_recip_alphas_cumprod[t]) * x
                  - float(self.sqrt_recipm1_alphas_cumprod[t]) * eps)
        else:
            x0 = self._net(x, t, cond_input)
        if self.clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return (float(self.posterior_mean_coef1[t]) * x0
                + float(self.posterior_mean_coef2[t]) * x)

    def _x_pred(self, x, eps, t: int, interval: int):
        """The PNDM transfer step, its coefficients in float32 in JAX's
        order."""
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[max(t - interval, 0)]
        a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
        one = np.float32(1.0)
        c_x = one / (a_t_sq * (a_t_sq + a_prev_sq))
        c_eps = one / (a_t_sq * (np.sqrt((one - a_prev) * a_t)
                                 + np.sqrt((one - a_t) * a_prev)))
        return x + float(a_prev - a_t) * (float(c_x) * x
                                          - float(c_eps) * eps)

    def _plms_loop(self, x, cond_input):
        """Adams-Bashforth multistep over t = K - interval, ..., 0."""
        interval = self.pndm_speedup
        hist = []  # the latest epsilons, newest first
        for t in range(self.K_step - interval, -1, -interval):
            eps = self._pred_noise(x, t, cond_input)
            if not hist:
                x_pred = self._x_pred(x, eps, t, interval)
                eps_prime = (eps + self._pred_noise(
                    x_pred, max(t - interval, 0), cond_input)) / 2.0
            elif len(hist) == 1:
                eps_prime = (3.0 * eps - hist[0]) / 2.0
            elif len(hist) == 2:
                eps_prime = (23.0 * eps - 16.0 * hist[0]
                             + 5.0 * hist[1]) / 12.0
            else:
                eps_prime = (55.0 * eps - 59.0 * hist[0] + 37.0 * hist[1]
                             - 9.0 * hist[2]) / 24.0
            x = self._x_pred(x, eps_prime, t, interval)
            hist = [eps] + hist[:2]
        return x

    def inference(self, cond, g=None, x_T=None, zero_noise: bool = False,
                  generator=None):
        """cond [B, T, H]; g as ``DiffNetG`` takes it -> [B, T, out_dim]
        (denormalized): PLMS with ``pndm_speedup``, else K ancestral
        steps. ``x_T`` and ``zero_noise`` give a deterministic decode;
        otherwise the initial state and every step's noise are drawn from
        ``generator``, before the loop."""
        B, T = cond.shape[0], cond.shape[1]
        shape = (B, T, self.out_dim)
        with torch.no_grad(), float32_math():
            x = (torch.randn(shape, generator=generator, device=cond.device)
                 if x_T is None else x_T.to(cond.device, torch.float32))
            cond_input = self._cond_input(cond, g)
            if self.pndm_speedup:
                return self._denorm(self._plms_loop(x, cond_input))
            noises = None if zero_noise else torch.randn(
                (self.K_step,) + shape, generator=generator,
                device=cond.device)
            for t in range(self.K_step - 1, -1, -1):
                x = self._p_mean(x, t, cond_input)
                if t > 0 and noises is not None:
                    lv = self.posterior_log_variance_clipped[t]
                    x = x + float(np.exp(np.float32(0.5) * lv)) * noises[t]
            return self._denorm(x)
