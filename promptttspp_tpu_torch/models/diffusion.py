"""DDPM mel decoder: DiffNet denoiser, the training loss's inputs,
ancestral and PLMS sampling.

Counterpart of ``promptttspp_tpu/models/diffusion.py`` (``DiffNet``,
``SinusoidalPosEmb``, ``GaussianDiffusion.__call__``, ``q_sample`` and
``inference``): K betas on the
linear (1e-4 -> 0.06) or cosine schedule, epsilon prediction, the mel
scaled by ``norm_scale`` or, when it is None, mapped from [a_min, a_max]
to [-1, 1].

The decode's random inputs (the initial state and every step's noise) are
drawn before the loop into one tensor, as JAX draws them before its
``lax.scan`` (``fill_draws``); ``sample`` is then a function of the
conditioning and that tensor alone, the body that ``models/decode_graph.py``
captures as a CUDA graph. The K steps are a Python loop over Python ints
(the PLMS order switch depends only on the step count), and the per-block
conditioner projections depend only on the conditioning, so they are
computed once per decode (``precompute_cond``). Schedule tables are float32
numpy constants, as in the JAX package, used as Python scalars per step;
training indexes them by a step per row, from one device copy of each.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.layers import Conv1d, conv1d_btc


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1.0):
    """Diffusion-step embedding: t [B] -> [B, dim]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -emb)
    arg = scale * t.to(torch.float32)[:, None] * freqs[None, :]
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

    def forward(self, x, cond_proj, diffusion_step, mask=None):
        """x [B,T,R]; cond_proj [B,T,2R] (float32, or bf16 storage that
        the add promotes); diffusion_step [B,R]; mask [B,T,1] or None
        (training multiplies the output projection by the frame mask)."""
        y = x + self.diffusion_projection(diffusion_step)[:, None, :]
        gate, filt = (self.dilated_conv(y) + cond_proj).chunk(2, dim=-1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        if mask is not None:
            y = y * mask
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffNet(nn.Module):
    """WaveNet-style epsilon predictor: [B,T,in_dim] noisy mel, [B] step,
    [B,T,H] cond -> [B,T,in_dim]. ``scale`` multiplies the step before its
    sinusoidal embedding (JAX's ``SinusoidalPosEmb.scale``)."""

    def __init__(self, in_dim: int = 80, encoder_hidden_dim: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 kernel_size: int = 3, dilation_cycle_length: int = 4,
                 scale: float = 1.0):
        super().__init__()
        self.residual_channels = residual_channels
        self.scale = float(scale)
        # the dtype whose values the floating parameters hold, when they
        # were rounded to one (Synthesizer(decode_param_dtype=...))
        self.param_dtype: Optional[torch.dtype] = None
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

    def precompute_cond(self, cond, io_dtype: Optional[torch.dtype] = None):
        """The blocks' conditioner projections [B,T,2R], hoisted out of the
        decode loop. With ``io_dtype`` (JAX's ``infer_io_dtype``) cond is
        rounded to it and the projections are stored in it, computed as
        flax promotes: in float32, or, when the parameters hold values of
        ``io_dtype`` too (``param_dtype``), in ``io_dtype``: the product
        rounded to it, then its bias added in it."""
        layers = [b.conditioner_projection for b in self.residual_layers]
        if io_dtype is None:
            return [proj(cond) for proj in layers]
        cond = cond.to(io_dtype).to(torch.float32)
        if self.param_dtype != io_dtype:
            return [proj(cond).to(io_dtype) for proj in layers]
        return [conv1d_btc(cond, proj.weight).to(io_dtype)
                + proj.bias.to(io_dtype) for proj in layers]

    def forward(self, x, diffusion_step, cond_projs, mask=None):
        """cond_projs: ``precompute_cond(cond)``; mask [B,T,1] or None (see
        ``ResidualBlock``)."""
        x = torch.relu(self.input_projection(x))
        t_emb = self.mlp(sinusoidal_pos_emb(
            diffusion_step, self.residual_channels, self.scale))
        skip_sum = 0.0
        for block, cp in zip(self.residual_layers, cond_projs):
            x, skip = block(x, cp, t_emb, mask)
            skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        return self.output_projection(torch.relu(self.skip_projection(x)))


def linear_beta_schedule(timesteps: int, min_beta=1e-4, max_beta=0.06):
    return np.linspace(min_beta, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s=0.008):
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


@contextlib.contextmanager
def float32_math():
    """Convolutions and matrix products in full float32, not TF32, whatever
    the process-wide flags say; the caller's flags are restored after. The
    decode runs under it, so its numerics do not depend on the flags and a
    captured graph does not freeze whichever setting was on."""
    conv = torch.backends.cudnn.conv
    matmul = torch.backends.cuda.matmul
    saved = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved


_SCHEDULES = {"linear": linear_beta_schedule, "cosine": cosine_beta_schedule}


@functools.lru_cache(maxsize=32)
def _device_table(name: str, K_step: int, schedule_type: str,
                  device: torch.device):
    """One float32 copy of a schedule table per device; a plain (not
    inference-mode) tensor, so autograd may read it."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            schedule_tables(K_step, schedule_type)[name].astype(np.float32),
            device=device)


def schedule_tables(K_step: int, schedule_type: str = "linear"):
    """The sampler's tables in float64, by the names of the reference's
    buffers (its checkpoints store them, rounded to float32)."""
    betas = _SCHEDULES[schedule_type](K_step)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return dict(
        betas=betas, alphas_cumprod=ac, alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        log_one_minus_alphas_cumprod=np.log(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
        posterior_variance=post_var,
        posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))


class GaussianDiffusion(nn.Module):
    """The decoder's sampler around ``denoise_fn``.

    pndm_speedup: PLMS with one denoiser step per ``pndm_speedup`` of the K
    (two at the first), instead of K ancestral steps. infer_io_dtype
    (e.g. "bfloat16"): the conditioning and the hoisted
    conditioner projections are rounded to it (``DiffNet.precompute_cond``);
    the x carry and the epsilon math stay float32, as in JAX."""

    def __init__(self, denoise_fn: DiffNet, out_dim: int,
                 norm_scale: Optional[float] = None, K_step: int = 100,
                 schedule_type: str = "linear", a_min: float = 0.0,
                 a_max: float = 20.0, pndm_speedup: Optional[int] = None,
                 infer_io_dtype: Optional[str] = None):
        super().__init__()
        if schedule_type not in _SCHEDULES:
            raise ValueError(f"schedule_type {schedule_type!r}: one of "
                             f"{sorted(_SCHEDULES)}")
        self.options = dict(
            out_dim=out_dim, norm_scale=norm_scale, K_step=K_step,
            schedule_type=schedule_type, a_min=a_min, a_max=a_max,
            pndm_speedup=pndm_speedup, infer_io_dtype=infer_io_dtype)
        self.denoise_fn = denoise_fn
        self.out_dim = out_dim
        self.K_step = K_step
        self.norm_scale = norm_scale
        self.a_min, self.a_max = a_min, a_max
        self.pndm_speedup = int(pndm_speedup) if pndm_speedup else None
        self.io_dtype = (getattr(torch, infer_io_dtype) if infer_io_dtype
                         else None)
        tables = schedule_tables(K_step, schedule_type)
        f32 = lambda a: [float(v) for v in np.asarray(a, np.float32)]
        for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod",
                     "sqrt_recipm1_alphas_cumprod",
                     "posterior_log_variance_clipped", "posterior_mean_coef1",
                     "posterior_mean_coef2"):
            setattr(self, name, f32(tables[name]))

    def clone(self, denoise_fn: Optional[DiffNet] = None, **options):
        """A new sampler with these options, ``options`` changed, around
        ``denoise_fn`` (default: this one's, shared)."""
        return GaussianDiffusion(denoise_fn or self.denoise_fn,
                                 **{**self.options, **options})

    def _norm(self, x):
        if self.norm_scale is not None:
            return x / self.norm_scale
        return (x - self.a_min) / (self.a_max - self.a_min) * 2 - 1

    def _denorm(self, x):
        if self.norm_scale is not None:
            return x * self.norm_scale
        return (x + 1) / 2 * (self.a_max - self.a_min) + self.a_min

    def q_sample(self, x_start, t, noise):
        """x_start, noise [B,T,C]; t int [B] -> the noisy x_t."""
        tables = [_device_table(name, self.K_step,
                                self.options["schedule_type"], x_start.device)
                  for name in ("sqrt_alphas_cumprod",
                               "sqrt_one_minus_alphas_cumprod")]
        c1, c2 = (tab[t][:, None, None] for tab in tables)
        return c1 * x_start + c2 * noise

    def forward(self, cond, y, mask=None, t=None, noise=None,
                generator=None):
        """Training: cond [B,T,H]; y mel [B,T,out_dim]; mask [B,T,1] ->
        (noise, eps_pred), both [B,T,out_dim] and unmasked. ``t`` [B] and
        ``noise`` are drawn from ``generator`` when not given, t first."""
        B = cond.shape[0]
        if t is None:
            t = torch.randint(0, self.K_step, (B,), generator=generator,
                              device=cond.device)
        x = self._norm(y)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                dtype=x.dtype, device=x.device)
        x_noisy = self.q_sample(x, t, noise)
        eps = self.denoise_fn(x_noisy, t, self.denoise_fn.precompute_cond(
            cond), mask)
        return noise, eps

    def _eps(self, x, t: int, cond_projs):
        steps = torch.full((x.shape[0],), t, dtype=torch.int32,
                           device=x.device)
        return self.denoise_fn(x, steps, cond_projs)

    def p_sample(self, x, t: int, cond_projs, noise):
        """One reverse step at integer step t (same for the whole batch);
        ``noise`` None (or t == 0) gives the posterior mean."""
        eps = self._eps(x, t, cond_projs)
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

    # ------------------------------------------------------------ PLMS
    def _x_pred(self, x, eps, t: int, interval: int):
        """PNDM transfer step (JAX ``_x_pred``), its coefficients computed
        in float32 in JAX's order."""
        a_t = np.float32(self.alphas_cumprod[t])
        a_prev = np.float32(self.alphas_cumprod[max(t - interval, 0)])
        a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
        one = np.float32(1.0)
        c_x = one / (a_t_sq * (a_t_sq + a_prev_sq))
        c_eps = one / (a_t_sq * (np.sqrt((one - a_prev) * a_t)
                                 + np.sqrt((one - a_t) * a_prev)))
        return x + float(a_prev - a_t) * (float(c_x) * x
                                          - float(c_eps) * eps)

    def _plms_loop(self, x, cond_projs):
        """Adams-Bashforth multistep over t = K - interval, ..., 0, the
        order rising with the steps taken (JAX ``_plms_loop``)."""
        interval = self.pndm_speedup
        hist = []  # the latest epsilons, newest first
        for t in range(self.K_step - interval, -1, -interval):
            eps = self._eps(x, t, cond_projs)
            if not hist:
                x_pred = self._x_pred(x, eps, t, interval)
                eps_prev = self._eps(x_pred, max(t - interval, 0),
                                     cond_projs)
                eps_prime = (eps + eps_prev) / 2.0
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

    # -------------------------------------------------------- sampling
    def n_draws(self) -> int:
        """Slots of the decode's random input: the initial state, then
        (ancestral) the noise of steps 1 .. K-1."""
        return 1 if self.pndm_speedup else self.K_step

    def fill_draws(self, draws, x_T=None, zero_noise: bool = False,
                   generator=None):
        """Write the decode's random inputs into ``draws`` [n_draws, B, T,
        out_dim]: slot 0 the initial state (``x_T`` when given), slot t
        the noise of ancestral step t (zero with ``zero_noise``). Draws
        from ``generator`` unless ``x_T`` and ``zero_noise`` are both
        given."""
        if x_T is None or not zero_noise:
            torch.randn(draws.shape, generator=generator, out=draws)
        if x_T is not None:
            draws[0].copy_(x_T)
        if zero_noise:
            draws[1:].zero_()
        return draws

    def sample(self, cond, draws):
        """The decode loop: cond [B,T,H] and ``fill_draws``' draws -> mel
        [B,T,out_dim] (denormalized), in full float32 (``float32_math``)."""
        with float32_math():
            cond_projs = self.denoise_fn.precompute_cond(cond,
                                                         self.io_dtype)
            if self.pndm_speedup:
                return self._denorm(self._plms_loop(draws[0], cond_projs))
            x = draws[0]
            for t in range(self.K_step - 1, -1, -1):
                x = self.p_sample(x, t, cond_projs,
                                  draws[t] if t else None)
            return self._denorm(x)

    def inference(self, cond, x_T=None, zero_noise: bool = False,
                  generator=None):
        """cond [B,T,H] -> mel [B,T,out_dim] (denormalized), eager. ``x_T``
        and ``zero_noise`` give a deterministic decode; otherwise the
        initial state and the per-step noise come from ``generator``."""
        B, T = cond.shape[0], cond.shape[1]
        draws = torch.empty((self.n_draws(), B, T, self.out_dim),
                            device=cond.device)
        x_T = None if x_T is None else x_T.to(device=cond.device,
                                              dtype=torch.float32)
        return self.sample(cond, self.fill_draws(draws, x_T, zero_noise,
                                                 generator))
