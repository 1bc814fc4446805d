"""sin^2 by range reduction and an even polynomial.

Plain PyTorch version of ``promptttspp_tpu/ops/pallas/polyops.py::sin2``.
The CUDA kernels use the same coefficients in ``csrc/polyops.cuh``
(``ptts::sin2``); this version is what the tests hold that function to.
sin^2 is pi-periodic and even: t = z/pi - round(z/pi) lies in [-1/2, 1/2]
and a degree-7 fit in t^2 gives sin(z)^2 to 2.0e-10.
"""

from __future__ import annotations

import math

import torch

SIN2_COEF = (
    0.7304793718262736, -3.903308433149872, 13.203381813096923,
    -30.121232542884073, 42.72834270494695, -32.46969505718645,
    9.869604379110031, 4.0317083005447785e-11,
)
INV_PI = 1.0 / math.pi


def sin2(z: torch.Tensor) -> torch.Tensor:
    t = z * INV_PI
    t = t - torch.round(t)
    u = t * t
    p = torch.full_like(u, SIN2_COEF[0])
    for c in SIN2_COEF[1:]:
        p = p * u + c
    return p
