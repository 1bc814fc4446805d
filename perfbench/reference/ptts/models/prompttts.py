"""PromptTTS++ top model: the training losses and inference.

Counterpart of ``promptttspp_tpu/models/prompttts.py::PromptTTSMDNDurCFG``
(``__call__``, ``infer``, ``infer_cond``, ``infer_frame_lengths``,
``generate_style_emb``, ``_style_from_prompt_dist``): phoneme embedding ->
conformer; a style vector from exactly one of two branches -> variance
adaptor -> diffusion decoder.

- Prompt branch: BERT prompt encoder -> [L2 normalize] -> style MDN (where
  the config has one) -> style vector (most probable or sampled component,
  plus ``noise_scale`` x sigma x eps) -> [L2 normalize].
- Reference branch: reference mel [B, Tf, 80] + lengths -> GST style
  encoder (``models/style_encoder.py``) -> [L2 normalize].

The bracketed normalizations are ``norm_style_emb`` (the flagship's true;
JAX's default false). ``mdn_disable_amp`` casts the style MDN's input to
float32 (the flagship's true); otherwise the head computes in the
prompt embedding's dtype, bf16 under bf16 training, as JAX casts it.
With an energy branch in the variance adaptor the losses gain ``energy``,
the L1 distance of the predicted energy on the valid frames.

``forward(batch)`` is the training loss, in the mode the module is in:
``model.train()`` turns on the BatchNorm batch statistics and dropout
together, ``model.eval()`` (validation) runs on the running statistics
without dropout. The inference methods are meant for a model in eval mode,
as ``Synthesizer`` keeps it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from perfbench.reference.ptts.models.variance_adaptor import durations_from_log
from perfbench.reference.ptts.nn.layers import data_parallel, dropout_generator
from perfbench.reference.ptts.nn.mdn import (
    mdn_get_most_probable_sigma_and_mu, mdn_loss, mdn_sample_sigma_and_mu)
from perfbench.reference.ptts.ops.masks import sequence_mask, to_log_scale


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class PromptTTSMDNDurCFG(nn.Module):
    """The switches are JAX's fields: ``style_mdn`` (None: the prompt
    embedding is the style vector and learns the GST embedding by mean
    squared error), ``norm_style_emb`` and ``mdn_disable_amp``, each
    false by default; the flagship sets all three."""

    # the reference divides the decoder's L1 loss by 8 (``loss_dec_scale``)
    loss_dec_scale = 8.0

    def __init__(self, phoneme_emb: nn.Module, encoder: nn.Module,
                 variance_adaptor: nn.Module, reference_encoder: nn.Module,
                 prompt_encoder: nn.Module, decoder: nn.Module,
                 style_mdn: Optional[nn.Module] = None,
                 norm_style_emb: bool = False,
                 mdn_disable_amp: bool = False):
        super().__init__()
        self.phoneme_emb = phoneme_emb
        self.encoder = encoder
        self.variance_adaptor = variance_adaptor
        self.reference_encoder = reference_encoder
        self.prompt_encoder = prompt_encoder
        self.decoder = decoder
        self.style_mdn = style_mdn
        self.norm_style_emb = norm_style_emb
        self.mdn_disable_amp = mdn_disable_amp

    def _norm(self, x):
        """``l2_normalize`` where ``norm_style_emb`` says so."""
        return l2_normalize(x) if self.norm_style_emb else x

    def _style_mdn(self, prompt_emb):
        """The style MDN's (log_pi, log_sigma, mu) of ``prompt_emb``."""
        return self.style_mdn(prompt_emb.float() if self.mdn_disable_amp
                              else prompt_emb)

    def _encode_phones(self, phoneme, phone_lengths, row_weight=None):
        phone_mask = sequence_mask(phone_lengths, phoneme.shape[1])
        x = self.phoneme_emb(phoneme, phone_mask[:, :, None].to(
            torch.float32))
        return self.encoder(x, phone_lengths, row_weight), phone_mask

    def forward(self, batch, generator=None, data=None):
        """The training losses of one batch -> {"loss", "dec", "dur", "cf0",
        "vuv", "style"} (and "energy" with an energy branch), scalars.
        ``batch``: phoneme, duration (int [B, Tp]), phone_lengths, mel
        [B, Tf, 80], log_cf0 and vuv [B, Tf, 1] (and energy [B, Tf, 1]
        with an energy branch), frame_lengths, prompt_ids and prompt_mask
        [B, L];
        optionally batch_weight [B] (rows of weight 0 count in no
        reduction and in no BatchNorm statistic), diffusion_t [B] and
        diffusion_noise [B, Tf, 80] (else drawn from ``generator``, which
        dropout draws from too).

        ``data`` (a ``parallel/distributed.py::DataGroup``): ``batch`` is
        this rank's block of a global batch. The losses' normalizers and
        the BatchNorm statistics are then the global batch's, and every
        draw is made at its shape and cut to these rows, so the losses
        are this rank's rows' share of the global losses: their sum over
        the ranks, and its gradient, are one process's on the global
        batch."""
        with dropout_generator(self, generator), data_parallel(self, data):
            return self._losses(batch, generator, data)

    def _losses(self, batch, generator, data=None):
        duration, mel = batch["duration"], batch["mel"]
        log_cf0, vuv = batch["log_cf0"], batch["vuv"]
        w = batch.get("batch_weight")
        if w is None:
            w = torch.ones(duration.shape[0], device=mel.device)
        w = w.to(torch.float32)
        w_b11 = w[:, None, None]

        x, phone_mask = self._encode_phones(
            batch["phoneme"], batch["phone_lengths"], row_weight=w)
        frame_mask = sequence_mask(batch["frame_lengths"], mel.shape[1])
        fmask = frame_mask[:, :, None].to(torch.float32) * w_b11

        style_emb = self._norm(self.reference_encoder(
            mel, batch["frame_lengths"], row_weight=w))
        prompt_emb = self._norm(self.prompt_encoder(batch["prompt_ids"],
                                                    batch["prompt_mask"]))
        style_mdn_out = (None if self.style_mdn is None
                         else self._style_mdn(prompt_emb))

        x, mdn_out, log_cf0_pred, vuv_pred, energy_pred = \
            self.variance_adaptor(x + style_emb, phone_mask, frame_mask,
                                  duration, log_cf0, batch.get("energy"))

        noise, eps_pred = self.decoder(
            x, mel, fmask, t=batch.get("diffusion_t"),
            noise=batch.get("diffusion_noise"), generator=generator,
            data=data)
        pmask = phone_mask[:, :, None]
        pweight = pmask.to(torch.float32) * w_b11
        n_frames, n_phones, n_rows = fmask.sum(), pweight.sum(), w.sum()
        if data is not None:  # the global batch's counts
            n_frames, n_phones, n_rows = data.total(
                torch.stack([n_frames, n_phones, n_rows]))
        loss_dec = (torch.abs(noise * fmask - eps_pred * fmask).sum()
                    / n_frames / self.loss_dec_scale)

        log_duration = to_log_scale(duration.to(torch.float32))[:, :, None]
        dur_nll = mdn_loss(*mdn_out, log_duration, reduce=False, mask=pmask)
        loss_dur = ((torch.where(pmask, dur_nll, 0.0) * pweight).sum()
                    / n_phones)

        loss_cf0 = (torch.abs(log_cf0_pred - log_cf0) * fmask).sum() \
            / n_frames
        loss_vuv = (torch.abs(vuv_pred - vuv) * fmask).sum() / n_frames

        # the style MDN (or the prompt embedding) learns the GST
        # embedding; no gradient flows back into the reference encoder
        # through it
        target = style_emb.detach()
        if style_mdn_out is not None:
            style_nll = mdn_loss(*style_mdn_out,
                                 target.to(style_mdn_out[0].dtype))
            w_rows = w.reshape((-1,) + (1,) * (style_nll.ndim - 1))
            loss_style = ((style_nll * w_rows).sum()
                          / (n_rows * (style_nll.numel()
                                       // style_nll.shape[0])))
        else:
            sq = torch.square(target - prompt_emb)
            loss_style = ((sq * w_b11).sum()
                          / (n_rows * sq.shape[1] * sq.shape[2]))

        loss = loss_dec + loss_dur + loss_cf0 + loss_vuv + loss_style
        losses = dict(loss=loss, dec=loss_dec, dur=loss_dur, cf0=loss_cf0,
                      vuv=loss_vuv, style=loss_style)
        if energy_pred is not None:
            losses["energy"] = (torch.abs(energy_pred - batch["energy"])
                                * fmask).sum() / n_frames
            losses["loss"] = loss + losses["energy"]
        return losses

    def _style_from_prompt_dist(self, log_pi, log_sigma, mu, use_max: bool,
                                noise_scale: float, generator=None):
        """-> [B, 1, C] style vector from the style MDN's outputs."""
        if use_max:
            sigma, mu_sel = mdn_get_most_probable_sigma_and_mu(
                log_pi, log_sigma, mu)
        else:
            sigma, mu_sel = mdn_sample_sigma_and_mu(log_pi, log_sigma, mu,
                                                    generator)
        style = mu_sel
        if noise_scale != 0.0:
            eps = torch.randn(sigma.shape, generator=generator,
                              dtype=sigma.dtype, device=sigma.device)
            style = mu_sel + sigma * eps * noise_scale
        return self._norm(style)

    def _style(self, prompt_ids, prompt_mask, reference_mel, ref_lengths,
               use_max, noise_scale, generator):
        """-> [B, 1, C] style vector from exactly one of the prompt (ids +
        mask) and the reference mel (+ lengths)."""
        if (prompt_ids is None) == (reference_mel is None):
            raise ValueError("exactly one of prompt_ids / reference_mel "
                             "must be given")
        if reference_mel is not None:
            return self._norm(self.reference_encoder(reference_mel,
                                                     ref_lengths))
        style = self._norm(self.prompt_encoder(prompt_ids, prompt_mask))
        if self.style_mdn is None:
            return style
        return self._style_from_prompt_dist(*self._style_mdn(style), use_max,
                                            noise_scale, generator)

    def generate_style_emb(self, prompt_ids, prompt_mask, reference_mel,
                           ref_lengths, use_max: bool = True,
                           noise_scale: float = 1.0, generator=None):
        """Both branches' style vectors -> (prompt_emb, ref_emb), each
        [B, 1, C]. The prompt's is drawn from the style MDN with
        ``generator`` and, under ``norm_style_emb``, normalized once more
        after the draw, as JAX does."""
        prompt_emb = self._style(prompt_ids, prompt_mask, None, None,
                                 use_max, noise_scale, generator)
        prompt_emb = self._norm(prompt_emb)
        ref_emb = self._style(None, None, reference_mel, ref_lengths,
                              use_max, noise_scale, generator)
        return prompt_emb, ref_emb

    def infer_cond(self, phoneme, phone_lengths, max_frames: int,
                   prompt_ids=None, prompt_mask=None, reference_mel=None,
                   ref_lengths=None, use_max: bool = True,
                   noise_scale: float = 1.0, style_generator=None):
        """Everything before the diffusion decoder -> (cond [B,Tf,C],
        frame_lengths, frame_mask, log_cf0, vuv, raw_frame_lengths)."""
        x, phone_mask = self._encode_phones(phoneme, phone_lengths)
        x = x + self._style(prompt_ids, prompt_mask, reference_mel,
                            ref_lengths, use_max, noise_scale,
                            style_generator)
        return self.variance_adaptor.infer(x, phone_mask, max_frames)

    def infer(self, phoneme, phone_lengths, max_frames: int, prompt_ids=None,
              prompt_mask=None, reference_mel=None, ref_lengths=None,
              use_max: bool = True, noise_scale: float = 1.0,
              style_generator=None, diffusion_generator=None, x_T=None,
              zero_noise: bool = False):
        """-> (mel [B,max_frames,80], frame_lengths [B], log_cf0
        [B,max_frames,1], vuv [B,max_frames,1], raw_frame_lengths [B]).
        The raw lengths are the unclipped duration sums: speculative serving
        reads them to detect a frame-bucket overflow (infer.py)."""
        x, frame_lengths, frame_mask, log_cf0, vuv, raw = self.infer_cond(
            phoneme, phone_lengths, max_frames, prompt_ids, prompt_mask,
            reference_mel, ref_lengths, use_max, noise_scale,
            style_generator)
        mel = self.decoder.inference(x, x_T=x_T, zero_noise=zero_noise,
                                     generator=diffusion_generator)
        mel = mel * frame_mask[:, :, None].to(mel.dtype)
        return mel, frame_lengths, log_cf0, vuv, raw

    def infer_frame_lengths(self, phoneme, phone_lengths, prompt_ids=None,
                            prompt_mask=None, reference_mel=None,
                            ref_lengths=None, use_max: bool = True,
                            noise_scale: float = 0.0, style_generator=None):
        """Duration-only pre-pass -> total frames per item [B]."""
        x, phone_mask = self._encode_phones(phoneme, phone_lengths)
        x = x + self._style(prompt_ids, prompt_mask, reference_mel,
                            ref_lengths, use_max, noise_scale,
                            style_generator)
        pmask = phone_mask[:, :, None].to(x.dtype)
        log_duration = self.variance_adaptor.duration_predictor \
            .infer_log_duration(x, pmask)
        return durations_from_log(log_duration, phone_mask).sum(dim=-1)
