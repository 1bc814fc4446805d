"""PromptTTS++ top model: the training losses and inference.

Counterpart of ``promptttspp_tpu/models/prompttts.py::PromptTTSMDNDurCFG``
(``__call__``, ``infer``, ``infer_cond``, ``infer_frame_lengths``,
``_style_from_prompt_dist``): phoneme embedding -> conformer; a style vector
from exactly one of two branches -> variance adaptor -> diffusion decoder.

- Prompt branch: BERT prompt encoder -> L2 normalize -> style MDN -> style
  vector (most probable or sampled component, plus ``noise_scale`` x sigma
  x eps) -> L2 normalize.
- Reference branch: reference mel [B, Tf, 80] + lengths -> GST style
  encoder (``models/style_encoder.py``) -> L2 normalize.

``forward(batch)`` is the training loss, in the mode the module is in:
``model.train()`` turns on the BatchNorm batch statistics and dropout
together, ``model.eval()`` (validation) runs on the running statistics
without dropout. The inference methods are meant for a model in eval mode,
as ``Synthesizer`` keeps it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.variance_adaptor import durations_from_log
from promptttspp_tpu_torch.nn.layers import dropout_generator
from promptttspp_tpu_torch.nn.mdn import (
    mdn_get_most_probable_sigma_and_mu, mdn_loss, mdn_sample_sigma_and_mu)
from promptttspp_tpu_torch.ops.masks import sequence_mask, to_log_scale


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class PromptTTSMDNDurCFG(nn.Module):
    """The flagship's switches are fixed: style MDN present,
    ``norm_style_emb: true``, MDN heads in float32, no energy predictor."""

    # the reference divides the decoder's L1 loss by 8 (``loss_dec_scale``)
    loss_dec_scale = 8.0

    def __init__(self, phoneme_emb: nn.Module, encoder: nn.Module,
                 variance_adaptor: nn.Module, reference_encoder: nn.Module,
                 prompt_encoder: nn.Module, decoder: nn.Module,
                 style_mdn: nn.Module):
        super().__init__()
        self.phoneme_emb = phoneme_emb
        self.encoder = encoder
        self.variance_adaptor = variance_adaptor
        self.reference_encoder = reference_encoder
        self.prompt_encoder = prompt_encoder
        self.decoder = decoder
        self.style_mdn = style_mdn

    def _encode_phones(self, phoneme, phone_lengths, row_weight=None):
        phone_mask = sequence_mask(phone_lengths, phoneme.shape[1])
        x = self.phoneme_emb(phoneme, phone_mask[:, :, None].to(
            torch.float32))
        return self.encoder(x, phone_lengths, row_weight), phone_mask

    def forward(self, batch, generator=None):
        """The training losses of one batch -> {"loss", "dec", "dur", "cf0",
        "vuv", "style"}, scalars. ``batch``: phoneme, duration (int
        [B, Tp]), phone_lengths, mel [B, Tf, 80], log_cf0 and vuv
        [B, Tf, 1], frame_lengths, prompt_ids and prompt_mask [B, L];
        optionally batch_weight [B] (rows of weight 0 count in no
        reduction and in no BatchNorm statistic), diffusion_t [B] and
        diffusion_noise [B, Tf, 80] (else drawn from ``generator``, which
        dropout draws from too)."""
        with dropout_generator(self, generator):
            return self._losses(batch, generator)

    def _losses(self, batch, generator):
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

        style_emb = l2_normalize(self.reference_encoder(
            mel, batch["frame_lengths"], row_weight=w))
        prompt_emb = l2_normalize(self.prompt_encoder(batch["prompt_ids"],
                                                      batch["prompt_mask"]))
        style_mdn_out = self.style_mdn(prompt_emb.float())

        x, mdn_out, log_cf0_pred, vuv_pred = self.variance_adaptor(
            x + style_emb, phone_mask, frame_mask, duration, log_cf0)

        noise, eps_pred = self.decoder(
            x, mel, fmask, t=batch.get("diffusion_t"),
            noise=batch.get("diffusion_noise"), generator=generator)
        n_frames = fmask.sum()
        loss_dec = (torch.abs(noise * fmask - eps_pred * fmask).sum()
                    / n_frames / self.loss_dec_scale)

        log_duration = to_log_scale(duration.to(torch.float32))[:, :, None]
        pmask = phone_mask[:, :, None]
        dur_nll = mdn_loss(*mdn_out, log_duration, reduce=False, mask=pmask)
        pweight = pmask.to(torch.float32) * w_b11
        loss_dur = ((torch.where(pmask, dur_nll, 0.0) * pweight).sum()
                    / pweight.sum())

        loss_cf0 = (torch.abs(log_cf0_pred - log_cf0) * fmask).sum() \
            / n_frames
        loss_vuv = (torch.abs(vuv_pred - vuv) * fmask).sum() / n_frames

        # the style MDN learns the GST embedding; no gradient flows back
        # into the reference encoder through it
        style_nll = mdn_loss(*style_mdn_out, style_emb.detach().float())
        loss_style = ((style_nll * w[:, None]).sum()
                      / (w.sum() * style_nll.shape[1]))

        loss = loss_dec + loss_dur + loss_cf0 + loss_vuv + loss_style
        return dict(loss=loss, dec=loss_dec, dur=loss_dur, cf0=loss_cf0,
                    vuv=loss_vuv, style=loss_style)

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
        return l2_normalize(style)

    def _style(self, prompt_ids, prompt_mask, reference_mel, ref_lengths,
               use_max, noise_scale, generator):
        """-> [B, 1, C] style vector from exactly one of the prompt (ids +
        mask) and the reference mel (+ lengths)."""
        if (prompt_ids is None) == (reference_mel is None):
            raise ValueError("exactly one of prompt_ids / reference_mel "
                             "must be given")
        if reference_mel is not None:
            return l2_normalize(self.reference_encoder(reference_mel,
                                                       ref_lengths))
        style = l2_normalize(self.prompt_encoder(prompt_ids, prompt_mask))
        log_pi, log_sigma, mu = self.style_mdn(style.float())
        return self._style_from_prompt_dist(log_pi, log_sigma, mu, use_max,
                                            noise_scale, generator)

    def generate_style_emb(self, prompt_ids, prompt_mask, reference_mel,
                           ref_lengths, use_max: bool = True,
                           noise_scale: float = 1.0, generator=None):
        """Both branches' style vectors -> (prompt_emb, ref_emb), each
        [B, 1, C]. The prompt's is drawn from the style MDN with
        ``generator`` and normalized once more after the draw, as JAX
        does."""
        prompt_emb = l2_normalize(self.prompt_encoder(prompt_ids,
                                                      prompt_mask))
        log_pi, log_sigma, mu = self.style_mdn(prompt_emb.float())
        prompt_emb = l2_normalize(self._style_from_prompt_dist(
            log_pi, log_sigma, mu, use_max, noise_scale, generator))
        ref_emb = l2_normalize(self.reference_encoder(reference_mel,
                                                      ref_lengths))
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
