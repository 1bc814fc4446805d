"""The 1-D U-Net denoiser (Grad-TTS's estimator) over ``[B, T, C]``;
mask float ``[B, T, 1]``.

Counterpart of ``promptttspp_tpu/models/unet.py``: weight-standardized
convolutions with GroupNorm and FiLM time conditioning, linear attention
at every resolution, the conditioning added at each level through a
strided convolution, skip connections across ``len(dim_mults)`` levels.
The input is reflect-padded on the left to a multiple of
2^(levels - 1), as in the reference, and cut back at the end. Inside,
the net runs on ``[B, C, T]``, the reference's layout, in which torch's
convolutions and GroupNorm take their inputs without a copy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.models.diffusion import sinusoidal_pos_emb
from promptttspp_tpu_torch.nn.layers import Linear, swish


class SinusoidalPositionEmbeddings(nn.Module):
    def __init__(self, dim: int, scale: float = 1000.0):
        super().__init__()
        self.dim, self.scale = dim, scale

    def forward(self, time):
        return sinusoidal_pos_emb(time, self.dim, self.scale)


def standardize(w):
    """w [out, in, k] standardized per output channel over (in, k):
    torch's unbiased variance, eps added to the standard deviation."""
    var, mean = torch.var_mean(w, dim=(1, 2), keepdim=True, unbiased=True)
    return (w - mean) / (var.sqrt() + 1e-5)


class WeightStandardizedConv1d(nn.Conv1d):
    """A stride-1 convolution with a standardized weight (``standardize``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2)

    def forward(self, x):
        return F.conv1d(x, standardize(self.weight), self.bias,
                        padding=self.padding)


class Block(nn.Module):
    """WS-conv -> GroupNorm -> (FiLM) -> SiLU, masked; [B, C, T]."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = WeightStandardizedConv1d(dim, dim_out, 3)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, mask, scale_shift=None):
        x = self.norm(self.proj(x * mask))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return swish(x) * mask


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int,
                 time_emb_dim: Optional[int] = None, groups: int = 8):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(time_emb_dim,
                                                    dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv1d(dim, dim_out, 1) if dim != dim_out \
            else None

    def forward(self, x, mask, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            scale_shift = self.mlp(time_emb)[:, :, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, mask, scale_shift), mask)
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """Softmax over the head dim for q and over time for k; unmasked."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv1d(hidden, dim, 1),
                                    nn.GroupNorm(1, dim, eps=1e-5))

    def forward(self, x):
        B, _, T = x.shape
        q, k, v = (a.reshape(B, self.heads, self.dim_head, T)
                   for a in self.to_qkv(x).chunk(3, dim=1))
        q = torch.softmax(q, dim=-2) * self.dim_head ** -0.5
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhct,bhdt->bhcd", k, v)
        out = torch.einsum("bhcd,bhct->bhdt", context, q)
        return self.to_out(out.reshape(B, -1, T))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = nn.GroupNorm(1, dim, eps=1e-5)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def _attention(dim: int) -> Residual:
    return Residual(PreNorm(dim, LinearAttention(dim)))


class _Upsample(nn.Sequential):
    """Nearest x2 along time, then a 3-tap convolution."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv1d(dim, dim_out, 3, padding=1))


class Unet1d(nn.Module):
    def __init__(self, in_channels: int, encoder_channels: int,
                 out_channels: int, dim: int,
                 dim_mults: Sequence[int] = (1, 2, 4), scale: float = 1000.0):
        super().__init__()
        self.levels = len(dim_mults)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        self.init_conv = nn.Conv1d(in_channels, dim, 1)
        self.time_mlp = nn.Sequential(
            SinusoidalPositionEmbeddings(dim, scale), Linear(dim, time_dim),
            nn.GELU(), Linear(time_dim, time_dim))
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                nn.Conv1d(encoder_channels, dim_in, 3, stride=2 ** ind,
                          padding=1),
                ResnetBlock(dim_in, dim_in, time_dim),
                ResnetBlock(dim_in, dim_in, time_dim),
                _attention(dim_in),
                nn.Conv1d(dim_in, dim_out, 3, stride=1 if last else 2,
                          padding=1)]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim)
        self.mid_attn = _attention(mid)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim)
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, time_dim),
                ResnetBlock(dim_out + dim_in, dim_out, time_dim),
                _attention(dim_out),
                nn.Conv1d(dim_out, dim_in, 3, padding=1) if last
                else _Upsample(dim_out, dim_in)]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim)
        self.final_conv = nn.Conv1d(dim, out_channels, 1)

    def forward(self, x, time, cond, mask=None):
        """x [B, T, in]; time [B] (a step or a time in [0, 1]); cond
        [B, T, enc]; mask [B, T, 1] or None -> [B, T, out]."""
        B, T, _ = x.shape
        x, cond = x.transpose(1, 2), cond.transpose(1, 2)
        mask = x.new_ones((B, 1, T)) if mask is None else mask.transpose(1, 2)
        pad = (-T) % 2 ** (self.levels - 1)
        if pad:
            x = F.pad(x, (pad, 0), mode="reflect")
            cond = F.pad(cond, (pad, 0), mode="reflect")
            mask = F.pad(mask, (pad, 0), value=1.0)
        x = self.init_conv(x)
        residual = x
        t = self.time_mlp(time)
        h, masks = [], [mask]
        for cond_conv, block1, block2, attn, down in self.downs:
            mask_down = masks[-1]
            x = x + cond_conv(cond) * mask_down
            x = block1(x, mask_down, t)
            h.append(x)
            x = attn(block2(x, mask_down, t))
            h.append(x)
            x = down(x * mask_down)
            masks.append(mask_down[:, :, ::2])
        masks = masks[:-1]
        mask_mid = masks[-1]
        x = self.mid_block1(x, mask_mid, t)
        x = self.mid_block2(self.mid_attn(x), mask_mid, t)
        for block1, block2, attn, up in self.ups:
            mask_up = masks.pop()
            x = block1(torch.cat([x, h.pop()], dim=1), mask_up, t)
            x = block2(torch.cat([x, h.pop()], dim=1), mask_up, t)
            x = up(attn(x))
        x = self.final_res_block(torch.cat([x, residual], dim=1), mask, t)
        return (self.final_conv(x) * mask)[:, :, -T:].transpose(1, 2)
