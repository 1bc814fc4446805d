"""The VP-SDE score model (Grad-TTS's mean-reverting SDE) over
``[B, T, C]``: score matching in training, and the probability-flow ODE
from t = 1 to ``eps`` in fixed RK4 steps at inference.

Counterpart of ``promptttspp_tpu/models/score_sde.py`` (the reference
solves the ODE with scipy's ``solve_ivp`` on the host; JAX and the port
take fixed steps on the device, over the float32 grid of
``models/cnf.py::time_grid``, under ``models/diffusion.py::float32_math``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.cnf import integrate, time_grid
from promptttspp_tpu_torch.models.diffusion import float32_math


class SDE:
    def __init__(self, beta_min: float = 0.05, beta_max: float = 20.0):
        self.beta_0, self.beta_1 = beta_min, beta_max

    def _beta(self, t):
        return self.beta_0 + (self.beta_1 - self.beta_0) * t

    def marginal_prob(self, x0, mu, t):
        """-> (mean, std) of x_t given x0, for t [B]."""
        beta_int = (self.beta_0 * t
                    + 0.5 * (self.beta_1 - self.beta_0) * t ** 2)
        c = torch.exp(-0.5 * beta_int)[:, None, None]
        std = torch.sqrt(1.0 - torch.exp(-beta_int))[:, None, None]
        return c * x0 + (1 - c) * mu, std

    def probability_flow(self, score, x_t, mu, t):
        return 0.5 * (mu - x_t - score) * self._beta(t)[:, None, None]


class ScoreSDE(nn.Module):
    def __init__(self, mel_dim: int, denoise_fn: nn.Module,
                 eps: float = 1e-5, norm_scale: float = 10.0):
        super().__init__()
        self.mel_dim, self.denoise_fn = mel_dim, denoise_fn
        self.eps, self.norm_scale = eps, norm_scale

    def compute_loss(self, x0, mu, mask, t=None, z=None, generator=None):
        """The score-matching loss; x0, mu [B, T, C]; mask [B, T, 1].
        ``t`` [B] in [eps, 1) and ``z`` are drawn from ``generator`` when
        not given, t first."""
        B = x0.shape[0]
        if t is None:
            t = self.eps + (1.0 - self.eps) * torch.rand(
                (B,), generator=generator, device=x0.device)
        sde = SDE()
        mean, std = sde.marginal_prob(x0, mu, t)
        if z is None:
            z = torch.randn(x0.shape, generator=generator,
                            dtype=x0.dtype, device=x0.device)
        z = z * mask
        x_t = (mean + std * z) * mask
        score = self.denoise_fn(x_t, t, mu, mask)
        return ((score * std + z).square() * mask).sum() / self.mel_dim \
            / mask.sum()

    def forward(self, x, mu, mask, n_steps: int = 50):
        """The probability-flow ODE from ``x`` at t = 1 to ``eps`` in
        ``n_steps`` grid points of RK4, in full float32; mu is divided by
        ``norm_scale``."""
        B = x.shape[0]
        mu = mu / self.norm_scale
        sde = SDE()

        def f(t, y):
            t = torch.full((B,), float(t), device=y.device)
            score = self.denoise_fn(y, t, mu, mask)
            return sde.probability_flow(score, y, mu, t) * mask

        with float32_math():
            return integrate(f, x, time_grid(1.0, self.eps, n_steps), "rk4")
