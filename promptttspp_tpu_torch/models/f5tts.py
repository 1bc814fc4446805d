"""F5-TTS v1 (arXiv:2410.06885, github.com/SWivid/F5-TTS): a diffusion
transformer over mel frames, sampled by guided Euler flow matching on a
"sway" time grid, with a reference recording's frames as its condition.

- ``TextEmbedding``: character ids shifted by +1 (0 the filler) and padded
  or cut to the frame count; an embedding plus the sinusoidal table
  cat(cos(p f), sin(p f)), f = 10000^(-2i / text_dim); ConvNeXt-V2 blocks
  (``nn/convnext.py``), filler positions zeroed before and after each. The
  filler mask is taken from the ids before the text is dropped, so the
  dropped text's embedding is the filler's at the text's positions, as
  the published code computes it.
- ``InputEmbedding``: Linear(cat(x, cond, text)) plus a residual
  ``ConvPositionEmbedding``.
- ``DiT``: the time embedding, ``depth`` ``DiTBlock`` and the final
  AdaLN-zero layer and projection (``nn/dit.py``). It runs in the dtype of
  its parameters (float16 for serving, as F5-TTS's inference casts it) and
  returns float32.
- ``F5TTS``: the sampler. y0 is drawn per request; the grid t =
  linspace(0, 1, nfe + 1) is warped to t + s (cos(pi t / 2) - 1 + t), in
  float64, then float32; each Euler step is y += dt (p + cfg (p - p_null)),
  p_null with both the audio condition and the text dropped, the two
  passes as one doubled batch; the state stays float32. The reference
  frames are pasted back after the last step.

The sampler keeps ``models/decode_graph.py``'s contract, so it is
captured as one CUDA graph per (batch, frame bucket): ``sample(cond,
draws)`` with ``cond`` the tuple (reference mel [B, T, mel] float32, ids
[B, T] int64 already shifted, frame counts [B], reference frame counts
[B]) and ``draws`` [1, B, T, mel] the y0 of each request, zero past its
frames (``fill_draws`` copies a given ``x_T``). A request of a batch gets
the frames it gets alone: the attention masks padded keys, the
convolutions and GRN see only an item's frames, each y0 is drawn alone.
Departures from the published code are listed in PERF.md.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from promptttspp_tpu_torch.nn.convnext import ConvNeXtV2Block
from promptttspp_tpu_torch.nn.dit import (AdaLayerNormFinal,
                                          ConvPositionEmbedding, DiTBlock,
                                          TimestepEmbedding, rope_table)


def text_table(max_pos: int, dim: int) -> torch.Tensor:
    """[max_pos, dim]: cat(cos(p f), sin(p f)), f = 10000^(-2i / dim)."""
    freqs = 1.0 / 10000.0 ** (torch.arange(0, dim, 2)[: dim // 2].float()
                              / dim)
    angles = torch.outer(torch.arange(max_pos).float(), freqs)
    return torch.cat([angles.cos(), angles.sin()], dim=-1)


class TextEmbedding(nn.Module):
    def __init__(self, num_vocab: int, dim: int, conv_layers: int,
                 conv_mult: int = 2, max_pos: int = 4096):
        super().__init__()
        self.embed = nn.Embedding(num_vocab + 1, dim)  # 0: the filler
        self.register_buffer("table", text_table(max_pos, dim),
                             persistent=False)
        self.blocks = nn.ModuleList(ConvNeXtV2Block(dim, dim * conv_mult)
                                    for _ in range(conv_layers))

    def forward(self, ids, mask=None, drop: bool = False):
        """ids [B, T] shifted (0 the filler); mask bool [B, T, 1] or None
        -> [B, T, dim]."""
        text = (~(ids == 0))[..., None]
        x = self.embed(torch.zeros_like(ids) if drop else ids)
        x = torch.where(text, x + self.table[: ids.shape[1]].to(x.dtype), 0.0)
        for block in self.blocks:
            x = torch.where(text, block(x, mask), 0.0)
        return x


class InputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, text_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(2 * mel_dim + text_dim, dim)
        self.conv_pos = ConvPositionEmbedding(dim)

    def forward(self, x, cond, text, mask=None):
        h = self.proj(torch.cat([x, cond, text], dim=-1))
        return self.conv_pos(h, mask) + h


class DiT(nn.Module):
    def __init__(self, dim: int = 1024, depth: int = 22, heads: int = 16,
                 dim_head: int = 64, ff_mult: int = 2, mel_dim: int = 100,
                 text_num_embeds: int = 2546, text_dim: int = 512,
                 conv_layers: int = 4):
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = (dim, depth, heads,
                                                           dim_head)
        self.mel_dim = mel_dim
        self.time_embed = TimestepEmbedding(dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        conv_layers)
        self.input_embed = InputEmbedding(mel_dim, text_dim, dim)
        self.blocks = nn.ModuleList(DiTBlock(dim, heads, dim_head, ff_mult)
                                    for _ in range(depth))
        self.norm_out = AdaLayerNormFinal(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    def rope(self, T: int, device, batch=None):
        """The rotary tables at T frames; with ``batch``, whole at [batch,
        T, heads, dim_head]."""
        return rope_table(T, self.dim_head, device, self.dtype,
                          None if batch is None else (batch, self.heads))

    def forward(self, x, cond, text, t, mask=None, rope=None):
        """x, cond [B, T, mel] (any float dtype); text [B, T, text_dim]
        (``text_embed``'s); t [B] float32; mask bool [B, T, 1] or None
        -> float32 [B, T, mel]."""
        dt = self.dtype
        if rope is None:
            rope = self.rope(x.shape[1], x.device)
        h = self.input_embed(x.to(dt), cond.to(dt), text.to(dt), mask)
        temb = self.time_embed(t)
        for block in self.blocks:
            h = block(h, temb, rope, mask)
        return self.proj_out(self.norm_out(h, temb)).float()


def sway_grid(nfe: int, coef: float) -> np.ndarray:
    """float32 [nfe + 1]: linspace(0, 1) warped by the sway coefficient,
    computed in float64."""
    t = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float64)
    t = t + coef * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    return t.float().numpy()


def duration(ref_frames: int, ref_text_len: int, gen_text_len: int) -> int:
    """F5-TTS's frame count of a request: the reference's frames plus its
    frames per character times the characters to speak."""
    return ref_frames + int(ref_frames / ref_text_len * gen_text_len)


class F5TTS(nn.Module):
    def __init__(self, dit: DiT, nfe: int = 32, cfg_strength: float = 2.0,
                 sway_coef: float = -1.0):
        super().__init__()
        self.dit = dit
        self.nfe, self.cfg_strength, self.sway_coef = (nfe, cfg_strength,
                                                       sway_coef)
        self.out_dim = dit.mel_dim

    # ---------------------------------------------- the graph's contract
    def n_draws(self) -> int:
        return 1

    def fill_draws(self, draws, x_T, zero_noise: bool = False,
                   generator=None):
        """The sampler's y0 is drawn per request by its caller
        (``draw_y0``): ``x_T`` [B, T, mel] is required."""
        if x_T is None:
            raise ValueError("F5TTS samples from a given x_T (draw_y0)")
        draws[0].copy_(x_T)

    def replay_counts(self, cond) -> Dict[str, int]:
        """The counters a replay of ``sample`` at cond's shape records:
        DiT passes (two per step, the doubled batch), DiT blocks, and the
        attention FLOPs 4 B' H T^2 d over every block of every step."""
        B, T = cond[0].shape[0], cond[0].shape[1]
        d = self.dit
        passes = 2 * self.nfe
        return {"decode.passes_run": passes,
                "decode.blocks_run": passes * d.depth,
                "f5.attn_flops": 4 * (2 * B) * d.heads * T * T * d.dim_head
                * d.depth * self.nfe}

    @staticmethod
    def draw_y0(lengths: Sequence[int], seeds: Sequence[int], T: int,
                mel_dim: int, device) -> torch.Tensor:
        """[B, T, mel_dim] float32: request i's randn(lengths[i], mel_dim)
        from a generator on ``device`` seeded with seeds[i], zero after."""
        y0 = torch.zeros((len(lengths), T, mel_dim), device=device)
        for i, (n, s) in enumerate(zip(lengths, seeds)):
            g = torch.Generator(device=device).manual_seed(int(s))
            y0[i, :n] = torch.randn((n, mel_dim), generator=g, device=device)
        return y0

    def sample(self, cond, draws):
        """cond (ref mel [B, T, mel] float32, ids [B, T], lengths [B],
        reference lengths [B]); draws [1, B, T, mel] -> [B, T, mel]
        float32: the sampled frames, the reference's pasted back."""
        mel, ids, lengths, ref_lengths = cond
        B, T, _ = mel.shape
        frames = torch.arange(T, device=mel.device)[None, :, None]
        mask = frames < lengths[:, None, None]
        ref = frames < ref_lengths[:, None, None]
        step_cond = torch.where(ref, mel, 0.0)
        dit = self.dit
        text = torch.cat([dit.text_embed(ids, mask),
                          dit.text_embed(ids, mask, drop=True)])
        cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)])
        mask2 = torch.cat([mask, mask])
        rope = dit.rope(T, mel.device, 2 * B)
        grid = sway_grid(self.nfe, self.sway_coef)
        y = draws[0]
        for k in range(self.nfe):
            t = torch.full((2 * B,), float(grid[k]), device=mel.device)
            v = dit(torch.cat([y, y]), cond2, text, t, mask2, rope)
            p, p_null = v.chunk(2)
            y = y + float(grid[k + 1] - grid[k]) * (
                p + (p - p_null) * self.cfg_strength)
            y = torch.where(mask, y, 0.0)
        return torch.where(ref, mel, y)

    def inference(self, cond, x_T=None, zero_noise: bool = False,
                  generator=None):
        """The eager decode: ``sample`` from ``x_T``."""
        if x_T is None:
            raise ValueError("F5TTS samples from a given x_T (draw_y0)")
        return self.sample(cond, x_T[None])
