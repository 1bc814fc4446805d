"""Mask and duration-alignment primitives.

Counterpart of ``promptttspp_tpu/ops/masks.py``: boolean [B, T] masks, the
duration -> frame band matrix, the expansion of phone features to frames
as one batched product, and the ESPnet decoder's causal masks and
<sos>/<eos> framing.
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


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Causal bool [size, size]: True at (t, s) iff s <= t."""
    idx = torch.arange(size, device=device)
    return idx[None, :] <= idx[:, None]


def target_mask(ys_in_pad, ignore_id: int) -> torch.Tensor:
    """The decoder's self-attention mask [B, L, L]: the key is not padding
    and not in the future."""
    ys_mask = ys_in_pad != ignore_id
    return ys_mask[:, None, :] & subsequent_mask(ys_in_pad.shape[-1],
                                                 ys_in_pad.device)[None]


def add_sos_eos(ys_pad, sos: int, eos: int, ignore_id: int):
    """Targets padded with ``ignore_id`` at the end, int [B, L] ->
    (ys_in [B, L+1]: <sos> + ys, padded with <eos>; ys_out [B, L+1]: ys +
    <eos>, padded with ``ignore_id``), at static shapes."""
    B, L = ys_pad.shape
    lengths = (ys_pad != ignore_id).sum(dim=1)[:, None]
    pos = torch.arange(L + 1, device=ys_pad.device)[None, :]
    ys_ext = F.pad(ys_pad, (0, 1), value=ignore_id)
    ys_in = torch.cat([torch.full((B, 1), sos, dtype=ys_pad.dtype,
                                  device=ys_pad.device), ys_pad], dim=1)
    ys_in = torch.where(pos <= lengths, ys_in, eos)
    ys_out = torch.where(pos == lengths, eos, ys_ext)
    ys_out = torch.where(pos > lengths, ignore_id, ys_out)
    return ys_in, ys_out
