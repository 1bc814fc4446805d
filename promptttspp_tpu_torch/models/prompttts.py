"""PromptTTS++ top model, inference.

Counterpart of ``promptttspp_tpu/models/prompttts.py::PromptTTSMDNDurCFG``
(``infer``, ``infer_cond``, ``infer_frame_lengths``,
``_style_from_prompt_dist``): phoneme embedding -> conformer; a style vector
from exactly one of two branches -> variance adaptor -> diffusion decoder.

- Prompt branch: BERT prompt encoder -> L2 normalize -> style MDN -> style
  vector (most probable or sampled component, plus ``noise_scale`` x sigma
  x eps) -> L2 normalize.
- Reference branch: reference mel [B, Tf, 80] + lengths -> GST style
  encoder (``models/style_encoder.py``) -> L2 normalize.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from promptttspp_tpu_torch.models.variance_adaptor import durations_from_log
from promptttspp_tpu_torch.nn.mdn import (
    mdn_get_most_probable_sigma_and_mu, mdn_sample_sigma_and_mu)
from promptttspp_tpu_torch.ops.masks import sequence_mask


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class PromptTTSMDNDurCFG(nn.Module):
    """The flagship's switches are fixed: style MDN present,
    ``norm_style_emb: true``, MDN heads in float32."""

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

    def _encode_phones(self, phoneme, phone_lengths):
        phone_mask = sequence_mask(phone_lengths, phoneme.shape[1])
        x = self.phoneme_emb(phoneme, phone_mask[:, :, None].to(
            torch.float32))
        return self.encoder(x, phone_lengths), phone_mask

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
