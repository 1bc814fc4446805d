"""Flow-matching CNF over ``[B, T, C]``: conditional flow matching on the
straight path from noise to data, sampled by fixed-step Euler or RK4 from
t = 1 to 1e-5, with classifier-free guidance.

Counterpart of ``promptttspp_tpu/models/cnf.py`` (the reference
integrates with ``torchdiffeq.odeint``; JAX and the port take fixed
steps). The time grid is numpy's float64 ``linspace`` cast to float32,
and each step's size and midpoints are float32, as JAX computes them.
The sampler runs under ``models/diffusion.py::float32_math``, so its
numerics do not depend on the caller's TF32 flags.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.diffusion import float32_math


def time_grid(start: float, stop: float, n: int) -> np.ndarray:
    """``n`` float32 times from ``start`` to ``stop``."""
    return np.linspace(start, stop, n).astype(np.float32)


def integrate(f, y, ts: np.ndarray, method: str):
    """y after the fixed steps of ``method`` ("euler" or "rk4") over the
    float32 grid ``ts``; f(t, y) with t a float32 number."""
    if method not in ("euler", "rk4"):
        raise ValueError(f"method {method!r}: 'euler' or 'rk4'")
    for t, t_next in zip(ts[:-1], ts[1:]):
        h = t_next - t
        if method == "euler":
            y = y + float(h) * f(t, y)
            continue
        half = h / np.float32(2)
        k1 = f(t, y)
        k2 = f(t + half, y + float(half) * k1)
        k3 = f(t + half, y + float(half) * k2)
        k4 = f(t + h, y + float(h) * k3)
        y = y + float(h / np.float32(6)) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


class CNF(nn.Module):
    def __init__(self, net: nn.Module, out_channels: int, cfg: float = 5.0):
        super().__init__()
        self.net = net
        self.out_channels, self.cfg = out_channels, cfg

    def forward(self, x1, cond, mask=None, t=None, x0=None, generator=None):
        """Training: x1 [B, T, C] data; cond [B, T, H] -> (ut, vt), the
        target velocity and the net's. ``t`` [B] in [0, 1) and ``x0`` are
        drawn from ``generator`` when not given, t first."""
        B = x1.shape[0]
        if t is None:
            t = torch.rand((B,), generator=generator, device=x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator,
                             dtype=x1.dtype, device=x1.device)
        tt = t[:, None, None]
        xt = tt * x1 + (1 - tt) * x0
        return x1 - x0, self.net(xt, t, cond, mask)

    def sample(self, cond, sample_step: int, method: str = "euler",
               do_cfg: bool = False, generator=None, x0=None):
        """cond [B, T, H] -> [B, T, out_channels]: ``sample_step`` grid
        points from t = 1 to 1e-5 (one step fewer), from ``x0`` or a draw
        of ``generator``. The net runs without a mask, as in JAX; under
        guidance its two calls (on the condition and on zeros) run as one
        call on the doubled batch."""
        B, T = cond.shape[0], cond.shape[1]
        if x0 is None:
            x0 = torch.randn((B, T, self.out_channels), generator=generator,
                             device=cond.device)
        # guidance: the net on the condition and on zeros, as one batch
        cond2 = torch.cat([cond, torch.zeros_like(cond)]) if do_cfg else cond

        def f(t, y):
            if do_cfg:
                y = torch.cat([y, y])
            t = torch.full((y.shape[0],), float(t), device=y.device)
            v = self.net(y, t, cond2)
            if not do_cfg:
                return v
            v_cond, v_zero = v.chunk(2, dim=0)
            return (1 + self.cfg) * v_cond - self.cfg * v_zero

        with float32_math():
            return integrate(f, x0, time_grid(1.0, 1e-5, sample_step),
                             method)
