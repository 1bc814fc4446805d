"""The pieces of F5-TTS's diffusion transformer (DiT), over ``[B, T, C]``.

- ``rope_table`` / ``apply_rope``: rotary positions on interleaved pairs
  (x_transformers' ``RotaryEmbedding``: base 10000, positions 0..T-1,
  each angle on channels 2i and 2i + 1): the table in float32, the
  rotation x cos + swap(x) sin in the input's dtype (the published code
  rotates in float32 and casts back);
- ``RoPEAttention``: self-attention with RoPE on every head, on
  ``F.scaled_dot_product_attention`` with a key-padding mask; q, k and v
  rotated and attended in the [B, T, H, d] layout their products leave
  (the sampler gives the tables at that whole shape, so the rotation's
  passes run without broadcasting);
- ``AdaLayerNormZero``: the six modulations (shift, scale and gate of the
  attention and of the feed-forward) of a block from the step embedding;
- ``DiTBlock``: LayerNorm (no affine, eps 1e-6) modulated, attention
  gated on a residual; LayerNorm modulated, a tanh-GELU feed-forward gated
  on a residual;
- ``AdaLayerNormFinal``: the closing LayerNorm's scale and shift;
- ``TimestepEmbedding``: sin and cos of 1000 t over 128 frequencies, then
  Linear, SiLU, Linear (the sinusoid in float32);
- ``ConvPositionEmbedding``: two grouped convolutions (k 31, 16 groups),
  each followed by Mish, with padded frames zeroed before each and after.

Masks are bool ``[B, T, 1]`` (True on an item's frames). Attention skips
padded keys and the convolutions' inputs are zeroed at padded frames with
``torch.where``, so whatever padded frames hold never reaches an item's
frames; with masks, an item of a batch gets the values it gets alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.nn.layers import Conv1d


def rope_table(T: int, head_dim: int, device, dtype=torch.float32,
               shape=None):
    """-> (cos, signed sin), [T, 1, head_dim] in ``dtype``, each angle of
    base 10000 repeated on a pair of channels, the sine negated on the
    first of each pair (computed in float32); with ``shape`` (B, H), made
    whole at [B, T, H, head_dim]."""
    inv = 1.0 / 10000.0 ** (torch.arange(0, head_dim, 2, device=device,
                                         dtype=torch.float32) / head_dim)
    angles = torch.arange(T, device=device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    angles = angles.repeat_interleave(2, dim=-1)
    # -1 on the first of each pair, +1 on the second (made on the device:
    # nothing is copied from the host inside a graph's capture)
    sign = (torch.arange(head_dim, device=device) % 2) * 2.0 - 1.0
    tables = (angles.cos()[:, None, :].to(dtype),
              (angles.sin() * sign)[:, None, :].to(dtype))
    if shape is None:
        return tables
    B, H = shape
    return tuple(t.expand(B, T, H, head_dim).contiguous() for t in tables)


def apply_rope(x, cos, sin):
    """x [..., T, H, d]: each pair (x1, x2) -> (x1 cos - x2 sin, x2 cos +
    x1 sin), as x cos + swap(x) sin with the signed sine."""
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(x * cos, swapped, sin)


class RoPEAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, rope, mask=None):
        """x [B, T, C]; rope ``rope_table``'s; mask bool [B, T, 1] or None.
        Padded frames' outputs are left as they come: no frame reads
        them."""
        B, T, _ = x.shape
        q, k, v = (f(x).view(B, T, self.heads, self.dim_head)
                   for f in (self.to_q, self.to_k, self.to_v))
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        keys = None if mask is None else mask[:, None, None, :, 0]
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=keys)
        return self.to_out(o.transpose(1, 2).reshape(B, T, -1))


class AdaLayerNormZero(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)

    def forward(self, t):
        """t [B, C] -> six [B, 1, C]: shift, scale, gate of the attention,
        then of the feed-forward."""
        return self.linear(F.silu(t))[:, None, :].chunk(6, dim=-1)


def _norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int):
        super().__init__()
        self.attn_norm = AdaLayerNormZero(dim)
        self.attn = RoPEAttention(dim, heads, dim_head)
        self.ff_in = nn.Linear(dim, dim * ff_mult)
        self.ff_out = nn.Linear(dim * ff_mult, dim)

    def forward(self, x, t, rope, mask=None):
        shift1, scale1, gate1, shift2, scale2, gate2 = self.attn_norm(t)
        h = torch.addcmul(shift1, _norm(x), 1 + scale1)
        x = torch.addcmul(x, gate1, self.attn(h, rope, mask))
        h = torch.addcmul(shift2, _norm(x), 1 + scale2)
        return torch.addcmul(x, gate2, self.ff_out(
            F.gelu(self.ff_in(h), approximate="tanh")))


class AdaLayerNormFinal(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, t):
        scale, shift = self.linear(F.silu(t))[:, None, :].chunk(2, dim=-1)
        return torch.addcmul(shift, _norm(x), 1 + scale)


def sinusoid(t, dim: int, scale: float = 1000.0):
    """t [B] -> float32 [B, dim]: sin, then cos, of scale t times
    exp(-i log(10000) / (dim / 2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                      * -(math.log(10000.0) / (half - 1)))
    angles = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat((angles.sin(), angles.cos()), dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = nn.Linear(freq_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        """t [B] -> [B, dim] in the parameters' dtype."""
        h = sinusoid(t, self.freq_dim).to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(h)))


class ConvPositionEmbedding(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.conv1 = Conv1d(dim, dim, kernel_size, groups=groups)
        self.conv2 = Conv1d(dim, dim, kernel_size, groups=groups)

    def forward(self, x, mask=None):
        for conv in (self.conv1, self.conv2):
            if mask is not None:
                x = torch.where(mask, x, 0.0)
            x = F.mish(conv(x))
        return x if mask is None else torch.where(mask, x, 0.0)
