"""Synthesis: phoneme ids + style prompt -> waveform, two-phase batched path.

Counterpart of ``promptttspp_tpu/infer.py::Synthesizer.synthesize`` on its
two-phase path (duration pre-pass, then the full pass): phones padded to a
phone bucket (quantum 16), prompts to a token bucket (16); the pre-pass
picks the frame bucket (quantum 128, capped at 2048); ``model.infer`` ->
F0 zero-phase lowpass (fs 100, 20 Hz) over the whole padded bucket and vuv
gating -> mel denormalization -> F0-aware BigVGAN (deterministic source)
-> optional PCM16.

Speculative and asynchronous serving, streaming, chunked/sharded vocoding
and the reference-audio branch are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.ops.filters import lowpass_filter
from promptttspp_tpu_torch.platform import resolve_device


class Synthesizer:
    def __init__(self, model, vocoder=None,
                 mel_stats: Optional[Dict] = None, tokenizer=None,
                 phone_quantum: int = 16, frame_quantum: int = 128,
                 max_frames_cap: int = 2048, upsample: int = 240,
                 return_int16: bool = False, device="cuda"):
        """model / vocoder: the port's modules; they are moved to
        ``device`` and put in eval mode. ``device`` defaults to ``cuda`` and
        raises if no GPU is present."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = (None if vocoder is None
                        else vocoder.to(self.device).eval())
        self.mel_stats = mel_stats or {"mean": 0.0, "std": 1.0}
        self.tokenizer = tokenizer
        self.phone_quantum = phone_quantum
        self.frame_quantum = frame_quantum
        self.max_frames_cap = max_frames_cap
        self.upsample = upsample
        self.return_int16 = return_int16

    def _pad_phonemes(self, seqs: Sequence[Sequence[int]]):
        Tp = bucket_shape(max(len(s) for s in seqs), self.phone_quantum)
        phoneme = np.zeros((len(seqs), Tp), np.int64)
        lens = np.zeros((len(seqs),), np.int64)
        for i, s in enumerate(seqs):
            phoneme[i, : len(s)] = s
            lens[i] = len(s)
        return self._to(phoneme), self._to(lens)

    def _encode_prompts(self, prompts: Sequence[str]):
        if self.tokenizer is None:
            raise ValueError("a tokenizer is required for prompts")
        ids, mask = self.tokenizer.batch_encode(prompts)
        L = bucket_shape(ids.shape[1], 16)
        ids_p = np.full((ids.shape[0], L), self.tokenizer.pad_id, np.int64)
        mask_p = np.zeros((ids.shape[0], L), np.int64)
        ids_p[:, : ids.shape[1]] = ids
        mask_p[:, : ids.shape[1]] = mask
        return self._to(ids_p), self._to(mask_p)

    def _to(self, arr):
        return torch.as_tensor(arr).to(self.device, non_blocking=True)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _postprocess(self, mel, log_cf0, vuv):
        """F0 smoothing + vuv gating and mel denormalization."""
        log_cf0 = lowpass_filter(log_cf0[..., 0], fs=100, cutoff=20)
        f0 = torch.where(vuv[..., 0] > 0.5, torch.exp(log_cf0),
                         torch.zeros_like(log_cf0))[..., None]
        mel_denorm = mel * self.mel_stats["std"] + self.mel_stats["mean"]
        return f0, mel_denorm

    @torch.inference_mode()
    def synthesize(self, phoneme_seqs: Sequence[Sequence[int]],
                   prompts: Sequence[str], use_max: bool = True,
                   noise_scale: float = 0.5, seed: int = 0,
                   return_mels: bool = True, x_T=None,
                   zero_noise: bool = False
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """-> (list of wav arrays, list of mel [T, 80] arrays). ``x_T``
        [B, frame_bucket, 80] and ``zero_noise`` make the decode
        deterministic (parity checks)."""
        phoneme, plens = self._pad_phonemes(phoneme_seqs)
        prompt_ids, prompt_mask = self._encode_prompts(prompts)

        frame_lens = self.model.infer_frame_lengths(
            phoneme, plens, prompt_ids, prompt_mask, use_max=use_max,
            noise_scale=0.0, style_generator=self._generator(seed))
        max_frames = min(bucket_shape(int(frame_lens.max()),
                                      self.frame_quantum),
                         self.max_frames_cap)

        if x_T is not None:
            x_T = torch.as_tensor(x_T, dtype=torch.float32,
                                  device=self.device)
        mel, flens, log_cf0, vuv = self.model.infer(
            phoneme, plens, max_frames, prompt_ids, prompt_mask,
            use_max=use_max, noise_scale=noise_scale,
            style_generator=self._generator(seed),
            diffusion_generator=self._generator(seed + 1), x_T=x_T,
            zero_noise=zero_noise)
        f0, mel_denorm = self._postprocess(mel, log_cf0, vuv)

        wav_np = None
        if self.vocoder is not None:
            wav = self.vocoder(mel_denorm, f0, deterministic=True)
            if self.return_int16:
                wav = torch.clamp(torch.round(wav * 32767.0), -32768.0,
                                  32767.0).to(torch.int16)
            wav_np = wav.cpu().numpy()
        mel_np = mel_denorm.cpu().numpy() if return_mels else None
        flens_np = flens.cpu().numpy()
        wavs, mels = [], []
        for i in range(len(phoneme_seqs)):
            n = int(flens_np[i])
            if return_mels:
                mels.append(mel_np[i, :n])
            if wav_np is not None:
                wavs.append(wav_np[i, : n * self.upsample, 0])
        return wavs, mels
