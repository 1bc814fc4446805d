"""Mixture density network head, its negative log-likelihood, and the
most-probable selection and sampling.

Counterpart of ``promptttspp_tpu/nn/mdn.py``. The flagship's two heads are
dim-wise 1-D GMMs: log_pi, log_sigma and mu are [B, T, G, D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


class MDNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_gaussians: int):
        super().__init__()
        self.G, self.D = num_gaussians, out_dim
        self.log_pi = nn.Linear(in_dim, num_gaussians * out_dim)
        self.log_sigma = nn.Linear(in_dim, num_gaussians * out_dim)
        self.mu = nn.Linear(in_dim, num_gaussians * out_dim)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        log_pi = torch.log_softmax(
            self.log_pi(x).reshape(B, T, self.G, self.D), dim=2)
        log_sigma = self.log_sigma(x).reshape(B, T, self.G, self.D)
        mu = self.mu(x).reshape(B, T, self.G, self.D)
        return log_pi, log_sigma, mu


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def mdn_loss(log_pi, log_sigma, mu, target, log_pi_min: float = -7.0,
             log_sigma_min: float = -7.0, reduce: bool = True,
             mask: Optional[torch.Tensor] = None):
    """Negative log-likelihood of ``target`` [B, T, D] with the reference's
    stability tricks: log_pi and log_sigma clamped at -7, the target
    clamped to mu +/- 5 sigma, invalid entries filled with -inf before the
    logsumexp over the G components. log_pi is [B, T, G, D] (dim-wise) or
    [B, T, G]; mask bool [B, T, 1], True = valid. Returns [B] (the mean
    over T) if ``reduce``, else [B, T] ([B, T, D] dim-wise); dim-wise
    ``reduce`` gives [B, D]. Callers pass float32 (the reference's
    ``mdn_disable_amp`` island)."""
    dim_wise = log_pi.ndim == 4
    log_sigma = torch.clamp(log_sigma, min=log_sigma_min)
    log_pi = torch.clamp(log_pi, min=log_pi_min)
    scale = torch.exp(log_sigma)
    edge = 5.0 * scale
    centered = torch.clamp(target[:, :, None, :] - mu, -edge, edge)
    log_prob = (-0.5 * torch.square(centered / scale) - log_sigma
                - _LOG_SQRT_2PI)
    ll = log_prob + log_pi if dim_wise else log_prob.sum(dim=3) + log_pi
    if mask is not None:
        m = mask[:, :, None, :] if dim_wise else mask
        ll = torch.where(m, ll, -torch.inf)
    loss = -torch.logsumexp(ll, dim=2)
    return loss.mean(dim=1) if reduce else loss


def _take(x, idx):
    """x [B,T,G,D], idx [B,T,D] -> x[b, t, idx[b,t,d], d]."""
    return torch.gather(x, 2, idx[:, :, None, :])[:, :, 0, :]


def mdn_get_most_probable_sigma_and_mu(log_pi, log_sigma, mu):
    """argmax-pi component -> (sigma, mu), each [B, T, D]."""
    idx = torch.argmax(log_pi, dim=2)
    return torch.exp(_take(log_sigma, idx)), _take(mu, idx)


def mdn_sample_sigma_and_mu(log_pi, log_sigma, mu, generator=None):
    """Categorical draw of the component per (B, T, D) -> (sigma, mu)."""
    probs = torch.softmax(log_pi.movedim(2, -1), dim=-1)
    idx = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=generator).reshape(probs.shape[:-1])
    return torch.exp(_take(log_sigma, idx)), _take(mu, idx)
