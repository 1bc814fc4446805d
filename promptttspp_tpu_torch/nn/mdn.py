"""Mixture density network head, most-probable selection and sampling.

Counterpart of ``promptttspp_tpu/nn/mdn.py`` (inference parts) for the
dim-wise 1-D GMMs both flagship heads use: log_pi, log_sigma and mu are
[B, T, G, D].
"""

from __future__ import annotations

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
