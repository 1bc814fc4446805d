"""Convolutional 2-D subsampling front-ends of the ESPnet transformer suite.

Counterpart of ``promptttspp_tpu/nn/subsampling.py``: strided VALID
``Conv2d`` + ReLU layers over [B, T, F] as a one-channel image (``conv``,
convolutions at 0, 2, 4 between the ReLUs), flattened channel-major into a
Linear and the absolute positional encoding (``out``); the mask is cut as
the convolutions cut time. 1/4 (``Conv2dSubsampling``), 1/6 and 1/8 of the
frames. [B, T, idim] in, ([B, T', odim], mask [B, 1, T'] or None) out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn

from promptttspp_tpu_torch.nn.embedding import PositionalEncoding
from promptttspp_tpu_torch.nn.layers import Linear


class _ConvSubsampling(nn.Module):
    conv_specs: Sequence[Tuple[int, int]] = ()  # (kernel, stride) per layer

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.0):
        super().__init__()
        layers, chans, feats = [], 1, idim
        for k, s in self.conv_specs:
            layers += [nn.Conv2d(chans, odim, k, s), nn.ReLU()]
            chans, feats = odim, (feats - k) // s + 1
        self.conv = nn.Sequential(*layers)
        self.out = nn.Sequential(Linear(odim * feats, odim),
                                 PositionalEncoding(odim, dropout_rate))

    def forward(self, x, x_mask):
        h = self.conv(x[:, None])  # [B, odim, T', F']
        B, C, T, Fo = h.shape
        h = self.out(h.transpose(1, 2).reshape(B, T, C * Fo))
        if x_mask is None:
            return h, None
        for k, s in self.conv_specs:
            x_mask = x_mask[:, :, : -(k - 1): s]
        return h, x_mask


class Conv2dSubsampling(_ConvSubsampling):
    """1/4 of the frames."""

    conv_specs = ((3, 2), (3, 2))


class Conv2dSubsampling6(_ConvSubsampling):
    """1/6 of the frames."""

    conv_specs = ((3, 2), (5, 3))


class Conv2dSubsampling8(_ConvSubsampling):
    """1/8 of the frames."""

    conv_specs = ((3, 2), (3, 2), (3, 2))
