"""Variance adaptor: MDN durations, length expansion, frame prior, pitch
and, where the config has one, energy.

Counterpart of ``promptttspp_tpu/models/variance_adaptor.py``. Training
(``forward``) expands the phone features by the given durations and embeds
the given log-F0 (and energy), with the predictors' input detached where
``detach`` is set (the flagship's duration predictor). Inference
(``infer``) takes the durations from the most-probable mixture component
as exp(mu + sigma^2 / 2), rounded, clamped to >= 1, expands the phone
features through ``generate_path`` and embeds the predicted log-F0 (and
energy); ``max_frames`` is the padded frame count and a frame mask comes
back with the frame lengths.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from perfbench.reference.ptts.nn.layers import ChannelLayerNorm, Conv1d, Dropout
from perfbench.reference.ptts.nn.mdn import (
    MDNLayer, mdn_get_most_probable_sigma_and_mu)
from perfbench.reference.ptts.ops.masks import expand_by_durations, sequence_mask


class PredictorLayer(nn.Module):
    """conv k -> ReLU -> ChannelLayerNorm -> dropout."""

    def __init__(self, channels: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.conv = Conv1d(channels, channels, kernel_size)
        self.norm = ChannelLayerNorm(channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask):
        return self.dropout(self.norm(torch.relu(self.conv(x)))) * mask


class Predictor(nn.Module):
    """Conv stack -> 1x1 conv (pitch: 5 layers k5, out 2). ``detach``:
    no gradient flows back into the input."""

    def __init__(self, channels: int, out_channels: int, kernel_size: int,
                 num_layers: int, dropout: float = 0.0,
                 detach: bool = False):
        super().__init__()
        self.detach = detach
        self.layers = nn.ModuleList(
            PredictorLayer(channels, kernel_size, dropout)
            for _ in range(num_layers))
        self.out_layer = Conv1d(channels, out_channels, 1)

    def forward(self, x, mask):
        if self.detach:
            x = x.detach()
        for layer in self.layers:
            x = layer(x, mask)
        return self.out_layer(x) * mask


class MDNPredictor(nn.Module):
    """Conv trunk + MDN head (duration: 2 layers k3, G=4; dim-wise by
    default, as in JAX). ``disable_amp``: the head's input is cast to
    float32 (the reference's ``mdn_disable_amp`` island), so under bf16
    training it computes in float32; otherwise in the trunk's dtype.
    ``detach`` as in ``Predictor``."""

    def __init__(self, channels: int, out_channels: int, kernel_size: int,
                 num_layers: int, num_gaussians: int = 4,
                 dropout: float = 0.0, detach: bool = False,
                 dim_wise: bool = True, disable_amp: bool = False):
        super().__init__()
        self.detach, self.disable_amp = detach, disable_amp
        self.layers = nn.ModuleList(
            PredictorLayer(channels, kernel_size, dropout)
            for _ in range(num_layers))
        self.out_layer = MDNLayer(channels, out_channels, num_gaussians,
                                  dim_wise)

    def forward(self, x, mask):
        if self.detach:
            x = x.detach()
        for layer in self.layers:
            x = layer(x, mask)
        return self.out_layer(x.float() if self.disable_amp else x)

    def infer_log_duration(self, x, mask):
        """Most-probable log-duration [B, Tp, 1]."""
        log_pi, log_sigma, mu = self(x, mask)
        sigma, mu = mdn_get_most_probable_sigma_and_mu(log_pi, log_sigma, mu)
        return mu + torch.clamp(torch.square(sigma), min=1e-14) / 2.0


def durations_from_log(log_duration, phone_mask):
    """[B, Tp, 1] log-durations -> int [B, Tp] frames (>= 1 on phones)."""
    duration = torch.clamp(torch.round(torch.exp(log_duration)), min=1)
    return (duration[..., 0] * phone_mask).to(torch.int32)


class VarianceAdaptor(nn.Module):
    """``energy_predictor`` and ``energy_emb`` (both or neither): the
    energy branch, predicted from the expanded features beside the pitch
    and embedded into them as the pitch is."""

    def __init__(self, duration_predictor: MDNPredictor,
                 pitch_predictor: Predictor, pitch_emb: nn.Module,
                 frame_prior_network: Optional[nn.Module] = None,
                 energy_predictor: Optional[Predictor] = None,
                 energy_emb: Optional[nn.Module] = None):
        super().__init__()
        if (energy_predictor is None) != (energy_emb is None):
            raise ValueError("energy_predictor and energy_emb go together")
        self.duration_predictor = duration_predictor
        self.pitch_predictor = pitch_predictor
        self.pitch_emb = pitch_emb
        self.energy_predictor = energy_predictor
        self.energy_emb = energy_emb
        self.frame_prior_network = frame_prior_network

    def _frames(self, x, fmask):
        if self.frame_prior_network is None:
            return x
        return self.frame_prior_network(x, fmask)

    def _embed(self, x, log_cf0, energy, fmask):
        """x plus the embedded log-F0 and, with the branch, energy."""
        x = x + self.pitch_emb(log_cf0) * fmask
        if self.energy_emb is None:
            return x
        return x + self.energy_emb(energy) * fmask

    def forward(self, x, phone_mask, frame_mask, duration, log_cf0,
                energy=None):
        """Training, teacher-forced: x [B,Tp,C]; phone_mask bool [B,Tp];
        frame_mask bool [B,Tf]; duration int [B,Tp]; log_cf0 and energy
        [B,Tf,1] -> (x [B,Tf,C], the duration MDN's (log_pi, log_sigma,
        mu), log_cf0 and vuv predictions [B,Tf,1] each, the energy
        prediction [B,Tf,1] or None)."""
        pmask = phone_mask[:, :, None].to(x.dtype)
        fmask = frame_mask[:, :, None].to(x.dtype)
        mdn_out = self.duration_predictor(x, pmask)
        x = expand_by_durations(x, duration, phone_mask, fmask.shape[1])
        x = self._frames(x, fmask)
        log_cf0_pred, vuv_pred = self.pitch_predictor(x, fmask).chunk(2,
                                                                      dim=-1)
        energy_pred = (None if self.energy_predictor is None
                       else self.energy_predictor(x, fmask))
        return (self._embed(x, log_cf0, energy, fmask), mdn_out,
                log_cf0_pred, vuv_pred, energy_pred)

    def infer(self, x, phone_mask, max_frames: int):
        """x [B,Tp,C]; phone_mask bool [B,Tp] -> (x [B,max_frames,C],
        frame_lengths [B], frame_mask bool [B,max_frames], log_cf0
        [B,max_frames,1], vuv [B,max_frames,1], raw_frame_lengths [B])."""
        pmask = phone_mask[:, :, None].to(x.dtype)
        duration = durations_from_log(
            self.duration_predictor.infer_log_duration(x, pmask), phone_mask)
        raw_frame_lengths = duration.sum(dim=-1)
        frame_lengths = torch.clamp(raw_frame_lengths, max=max_frames)
        frame_mask = sequence_mask(frame_lengths, max_frames)
        fmask = frame_mask[:, :, None].to(x.dtype)

        x = expand_by_durations(x, duration, phone_mask, max_frames)
        x = self._frames(x, fmask)
        log_cf0, vuv = self.pitch_predictor(x, fmask).chunk(2, dim=-1)
        energy = (None if self.energy_predictor is None
                  else self.energy_predictor(x, fmask))
        x = self._embed(x, log_cf0, energy, fmask)
        return x, frame_lengths, frame_mask, log_cf0, vuv, raw_frame_lengths
