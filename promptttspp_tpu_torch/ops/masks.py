"""Mask and duration-alignment primitives.

Counterpart of ``promptttspp_tpu/ops/masks.py`` (the parts the serving path
uses): boolean [B, T] masks, the duration -> frame band matrix, and the
expansion of phone features to frames as one batched product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> bool [B, max_length]; True inside the sequence."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def generate_path(durations, phone_mask, num_frames: int):
    """int durations [B, Tp], bool phone_mask [B, Tp] -> float
    [B, Tp, num_frames], 1 where frame f belongs to phone p."""
    durations = durations * phone_mask.to(durations.dtype)
    cum = torch.cumsum(durations, dim=1)
    frame_pos = torch.arange(num_frames, device=cum.device)
    below = frame_pos[None, None, :] < cum[:, :, None]
    prev = F.pad(below[:, :-1, :], (0, 0, 1, 0))
    path = below & ~prev & phone_mask[:, :, None]
    return path.to(torch.float32)


def expand_by_durations(x, durations, phone_mask, num_frames: int):
    """x [B, Tp, C] -> [B, num_frames, C]: frame f gets its phone's row."""
    path = generate_path(durations, phone_mask, num_frames)
    return torch.einsum("bpf,bpc->bfc", path, x.to(torch.float32)).to(
        x.dtype)


def to_log_scale(x):
    """log of nonzero entries; zeros stay zero."""
    nz = x != 0
    return torch.where(nz, torch.log(torch.where(nz, x, torch.ones_like(x))),
                       x)
