"""GRU that returns the hidden state at each row's last valid step.

Counterpart of ``promptttspp_tpu/nn/gru.py::GRU``: torch gate order (r, z,
n) and separate input and hidden biases, and the packed-sequence semantics
of the reference (``pack_padded_sequence`` + ``torch.nn.GRU``, keeping the
final hidden state per row). A GRU is causal, so the top layer's output at
step ``length - 1`` of the padded sequence is that row's final packed
hidden state; it is gathered on the device, with no host round trip for
the lengths. Parameter names are ``torch.nn.GRU``'s (``weight_ih_l0``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class GRU(nn.GRU):
    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers,
                         batch_first=True)

    def forward(self, xs, lengths=None):
        """xs [B, T, I]; lengths [B] (or None: all T) -> [B, H], the top
        layer's hidden state at each row's last valid step."""
        ys, _ = super().forward(xs)
        B, T = xs.shape[0], xs.shape[1]
        if lengths is None:
            return ys[:, -1]
        last = torch.clamp(lengths.to(torch.long), 1, T) - 1
        return ys[torch.arange(B, device=ys.device), last]
