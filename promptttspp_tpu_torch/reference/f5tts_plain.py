"""A plain F5-TTS v1 with Vocos: the equations the port's
``models/f5tts.py`` and ``vocoders/vocos.py`` compute, written out
straightforwardly, one request at a time, for the comparisons that hold
the port to them.

It imports only ``torch``, ``numpy`` and ``math``: nothing of the port.
It runs in float32 with TF32 off (``synthesize`` switches it off for its
call, through ``fp32_precision = "ieee"``, the form of
``allow_tf32 = False`` that does not clash with callers that set the
same); the DiT runs in the dtype of its parameters, so a copy cast to
bfloat16 is the control a limit is set against. There are no graphs, no
batches, no masks and no fused attention: softmax(Q K^T / sqrt(d)) V
written out, the Euler loop in Python, the two guided passes one after
the other.

The modules' parameters have the port's names and shapes, so a seeded
fill of both gives both the same weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _flags():
    return (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


def layer_norm(x, weight=None, bias=None, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


class LayerNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv1d(nn.Module):
    """A stride-1 convolution over [T, C] with (k - 1) / 2 zeros on each
    side."""

    def __init__(self, c_in, c_out, k, groups=1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.groups = groups

    def forward(self, x):
        k = self.weight.shape[-1]
        y = F.conv1d(x.t()[None], self.weight, self.bias,
                     padding=(k - 1) // 2, groups=self.groups)
        return y[0].t()


class Linear(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return x @ self.weight.t() + self.bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x):
    return x * torch.sigmoid(x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


# ------------------------------------------------------------------ DiT
class GRN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        g = torch.sqrt((x.float() ** 2).sum(dim=0, keepdim=True))
        n = (g / (g.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma * (x * n) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.dw_conv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.pw_conv1 = Linear(dim, hidden)
        self.grn = GRN(hidden)
        self.pw_conv2 = Linear(hidden, dim)

    def forward(self, x):
        y = self.norm(self.dw_conv(x))
        return x + self.pw_conv2(self.grn(gelu(self.pw_conv1(y))))


class TextEmbedding(nn.Module):
    def __init__(self, num_vocab, dim, layers):
        super().__init__()
        self.embed = nn.Embedding(num_vocab + 1, dim)
        self.blocks = nn.ModuleList(ConvNeXtV2Block(dim, 2 * dim)
                                    for _ in range(layers))
        self.dim = dim

    def forward(self, ids, drop):
        """ids [T] shifted (0 the filler)."""
        T = ids.shape[0]
        text = (ids != 0)[:, None]
        x = self.embed.weight[torch.zeros_like(ids) if drop else ids]
        i = torch.arange(0, self.dim, 2, device=ids.device)[: self.dim // 2]
        freqs = 1.0 / 10000.0 ** (i.float() / self.dim)
        angles = torch.arange(T, device=ids.device).float()[:, None] \
            * freqs[None, :]
        x = x + torch.cat([angles.cos(), angles.sin()], dim=-1).to(x.dtype)
        x = x * text
        for block in self.blocks:
            x = block(x) * text
        return x


class ConvPosition(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = Conv1d(dim, dim, 31, groups=16)
        self.conv2 = Conv1d(dim, dim, 31, groups=16)

    def forward(self, x):
        return mish(self.conv2(mish(self.conv1(x))))


class InputEmbedding(nn.Module):
    def __init__(self, mel, text_dim, dim):
        super().__init__()
        self.proj = Linear(2 * mel + text_dim, dim)
        self.conv_pos = ConvPosition(dim)

    def forward(self, x, cond, text):
        h = self.proj(torch.cat([x, cond, text], dim=-1))
        return self.conv_pos(h) + h


class TimestepEmbedding(nn.Module):
    def __init__(self, dim, freq_dim=256):
        super().__init__()
        self.linear_1 = Linear(freq_dim, dim)
        self.linear_2 = Linear(dim, dim)
        self.freq_dim = freq_dim

    def forward(self, t, dtype):
        half = self.freq_dim // 2
        freqs = torch.exp(torch.arange(half).float()
                          * -(math.log(10000.0) / (half - 1)))
        angles = 1000.0 * t * freqs
        h = torch.cat([angles.sin(), angles.cos()]).to(dtype)
        h = h.to(self.linear_1.weight.device)
        return self.linear_2(silu(self.linear_1(h)))


class AdaLN(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.linear = Linear(dim, n * dim)
        self.n = n

    def forward(self, t):
        return self.linear(silu(t)).chunk(self.n)


def rotate(x, T):
    """Interleaved-pair rotary positions on x [H, T, d], base 10000, in
    float32."""
    d = x.shape[-1]
    inv = 1.0 / 10000.0 ** (torch.arange(0, d, 2, device=x.device).float()
                            / d)
    angles = (torch.arange(T, device=x.device).float()[:, None]
              * inv[None, :]).repeat_interleave(2, dim=-1)
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rot = torch.stack((-x2, x1), dim=-1).flatten(-2)
    return (xf * angles.cos() + rot * angles.sin()).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        inner = heads * dim_head
        self.to_q = Linear(dim, inner)
        self.to_k = Linear(dim, inner)
        self.to_v = Linear(dim, inner)
        self.to_out = Linear(inner, dim)
        self.heads, self.dim_head = heads, dim_head

    def forward(self, x):
        T = x.shape[0]

        def split(y):
            return y.view(T, self.heads, self.dim_head).transpose(0, 1)

        q = rotate(split(self.to_q(x)), T)
        k = rotate(split(self.to_k(x)), T)
        v = split(self.to_v(x))
        scores = q @ k.transpose(1, 2) / math.sqrt(self.dim_head)
        w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        o = (w @ v).transpose(0, 1).reshape(T, -1)
        return self.to_out(o)


class Block(nn.Module):
    def __init__(self, dim, heads, dim_head, ff_mult):
        super().__init__()
        self.attn_norm = AdaLN(dim, 6)
        self.attn = Attention(dim, heads, dim_head)
        self.ff_in = Linear(dim, dim * ff_mult)
        self.ff_out = Linear(dim * ff_mult, dim)

    def forward(self, x, t):
        shift1, scale1, gate1, shift2, scale2, gate2 = self.attn_norm(t)
        x = x + gate1 * self.attn(layer_norm(x) * (1 + scale1) + shift1)
        h = layer_norm(x) * (1 + scale2) + shift2
        return x + gate2 * self.ff_out(gelu_tanh(self.ff_in(h)))


class DiT(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, ff_mult, mel_dim,
                 text_num_embeds, text_dim, conv_layers):
        super().__init__()
        self.time_embed = TimestepEmbedding(dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        conv_layers)
        self.input_embed = InputEmbedding(mel_dim, text_dim, dim)
        self.blocks = nn.ModuleList(Block(dim, heads, dim_head, ff_mult)
                                    for _ in range(depth))
        self.norm_out = AdaLN(dim, 2)
        self.proj_out = Linear(dim, mel_dim)

    def forward(self, x, cond, text, t):
        dtype = self.proj_out.weight.dtype
        h = self.input_embed(x.to(dtype), cond.to(dtype), text.to(dtype))
        temb = self.time_embed(t, dtype)
        for block in self.blocks:
            h = block(h, temb)
        scale, shift = self.norm_out(temb)
        return self.proj_out(layer_norm(h) * (1 + scale) + shift).float()


class F5TTS(nn.Module):
    def __init__(self, dim=1024, depth=22, heads=16, dim_head=64, ff_mult=2,
                 mel_dim=100, text_num_embeds=2546, text_dim=512,
                 conv_layers=4):
        super().__init__()
        self.dit = DiT(dim, depth, heads, dim_head, ff_mult, mel_dim,
                       text_num_embeds, text_dim, conv_layers)
        self.mel_dim = mel_dim


# ---------------------------------------------------------------- Vocos
class VocosLayer(nn.Module):
    def __init__(self, dim, hidden, scale):
        super().__init__()
        self.dw_conv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.pw_conv1 = Linear(dim, hidden)
        self.pw_conv2 = Linear(hidden, dim)
        self.scale = nn.Parameter(torch.full((dim,), scale))

    def forward(self, x):
        y = self.pw_conv2(gelu(self.pw_conv1(self.norm(self.dw_conv(x)))))
        return x + self.scale * y


class Backbone(nn.Module):
    def __init__(self, dim, hidden, layers):
        super().__init__()
        self.norm_pre = LayerNorm(dim, 1e-6)
        self.layers = nn.ModuleList(VocosLayer(dim, hidden, 1.0 / layers)
                                    for _ in range(layers))
        self.norm_post = LayerNorm(dim, 1e-6)


class Vocos(nn.Module):
    def __init__(self, n_mels=100, dim=512, intermediate_dim=1536,
                 num_layers=8, n_fft=1024, hop_length=256):
        super().__init__()
        self.embed = Conv1d(n_mels, dim, 7)
        self.backbone = Backbone(dim, intermediate_dim, num_layers)
        self.head = Linear(dim, n_fft + 2)
        self.n_fft, self.hop = n_fft, hop_length

    def forward(self, mel):
        """mel [T, n_mels] -> waveform [T * hop]."""
        x = self.backbone.norm_pre(self.embed(mel))
        for layer in self.backbone.layers:
            x = layer(x)
        h = self.head(self.backbone.norm_post(x))
        half = self.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(h[:, :half]), max=100.0)
        spec = torch.complex(mag * torch.cos(h[:, half:]),
                             mag * torch.sin(h[:, half:]))
        return istft(spec, self.n_fft, self.hop)


def hann(n, device):
    i = torch.arange(n, device=device, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)).float()


def istft(spec, n_fft, hop):
    """[T, n_fft / 2 + 1] -> [T * hop]: irfft (the DC and Nyquist bins
    real), the periodic Hann window, overlap-add, a trim of (n_fft - hop)
    / 2 at each end, over the window's squared overlap-add."""
    T = spec.shape[0]
    w = hann(n_fft, spec.device)
    # a real signal's DC and Nyquist bins are real: their imaginary parts
    # are left out, as the inverse real FFT defines
    imag = spec.imag.clone()
    imag[:, 0] = 0.0
    imag[:, -1] = 0.0
    frames = torch.fft.irfft(torch.complex(spec.real, imag), n=n_fft,
                             dim=-1) * w
    n = (T - 1) * hop + n_fft
    y = torch.zeros(n, device=spec.device)
    env = torch.zeros(n, device=spec.device)
    for f in range(T):
        y[f * hop: f * hop + n_fft] += frames[f]
        env[f * hop: f * hop + n_fft] += w * w
    pad = (n_fft - hop) // 2
    return y[pad:n - pad] / env[pad:n - pad]


# ------------------------------------------------------------ features
def htk_mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max):
    """[n_fft / 2 + 1, n_mels] HTK-scale triangles of peak 1."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    f_pts = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, mid, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return fb.astype(np.float32)


def log_mel(wav, sample_rate=24000, n_fft=1024, hop=256, n_mels=100):
    """wav [L] -> log-mel [L // hop + 1, n_mels]: centered frames
    (reflect padding), the periodic Hann window, |rfft|, HTK mel, log of
    the clamp at 1e-5."""
    pad = n_fft // 2
    x = F.pad(wav[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop) * hann(n_fft, wav.device)
    spec = torch.abs(torch.fft.rfft(frames, dim=-1))
    fb = torch.as_tensor(htk_mel_filterbank(sample_rate, n_fft, n_mels, 0.0,
                                            sample_rate / 2.0),
                         device=wav.device)
    return torch.log(torch.clamp(spec @ fb, min=1e-5))


# -------------------------------------------------------------- sampler
def sway_grid(nfe, coef):
    t = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float64)
    return (t + coef * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)).float()


@torch.no_grad()
def synthesize(model, vocoder, ref_mel, ref_ids, gen_ids, seed, nfe=32,
               cfg_strength=2.0, sway_coef=-1.0):
    """One request: ref_mel [T_ref, mel] float32, the reference
    transcript's ids and the ids to speak (lists), the seed of its y0 ->
    (the generated mel [T - T_ref, mel], its waveform), with TF32 off."""
    saved = [f.fp32_precision for f in _flags()]
    for f in _flags():
        f.fp32_precision = "ieee"
    try:
        return _synthesize(model, vocoder, ref_mel, ref_ids, gen_ids, seed,
                           nfe, cfg_strength, sway_coef)
    finally:
        for f, value in zip(_flags(), saved):
            f.fp32_precision = value


def _synthesize(model, vocoder, ref_mel, ref_ids, gen_ids, seed, nfe,
            cfg_strength, sway_coef):
    dit = model.dit
    device = ref_mel.device
    T_ref = ref_mel.shape[0]
    T = T_ref + int(T_ref / len(ref_ids) * len(gen_ids))
    ids = torch.zeros(T, dtype=torch.long, device=device)
    text = (torch.as_tensor(list(ref_ids) + list(gen_ids),
                            device=device) + 1)[:T]
    ids[: len(text)] = text
    text_c = dit.text_embed(ids, drop=False)
    text_n = dit.text_embed(ids, drop=True)
    cond = torch.zeros((T, model.mel_dim), device=device)
    cond[:T_ref] = ref_mel
    zero = torch.zeros_like(cond)
    g = torch.Generator(device=device).manual_seed(int(seed))
    y = torch.randn((T, model.mel_dim), generator=g, device=device)
    grid = sway_grid(nfe, sway_coef)
    for k in range(nfe):
        t = grid[k]
        p = dit(y, cond, text_c, t)
        p_null = dit(y, zero, text_n, t)
        y = y + float(grid[k + 1] - grid[k]) * (
            p + (p - p_null) * cfg_strength)
    mel = y[T_ref:]
    return mel, vocoder(mel)
