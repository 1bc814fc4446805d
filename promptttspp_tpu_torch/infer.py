"""Synthesis: phoneme ids + a style prompt or a reference recording ->
waveform.

Counterpart of ``promptttspp_tpu/infer.py::Synthesizer``. A request pads
its phones to a phone bucket (quantum 16), its prompts to a token bucket
(16) or its reference mels to a frame bucket; then ``model.infer`` at a
frame bucket (quantum 128, capped at 2048) -> F0 zero-phase lowpass (fs 100,
20 Hz) over the whole padded bucket and vuv gating -> mel denormalization ->
F0-aware BigVGAN (deterministic source) -> optional PCM16.

How the frame bucket is chosen:

- two-phase (default): a duration pre-pass and one readback of its frame
  counts pick the bucket, then the full pass runs;
- speculative (``speculative=True``): the bucket is predicted on the host
  from the phone count (``spec_frames_per_phone``, or a per-phone duration
  table) and the full pass is queued at once. Nothing on the dispatch path
  reads a device tensor back: the launches queue on the device's current
  stream and ``synthesize_async`` returns a handle. Its ``result()`` makes
  the one readback of the audio together with the unclipped duration sums,
  and re-dispatches at the true bucket when they overflow the prediction.

Vocoding is batched (one call over the utterance batch), chunked
(``vocoder_mode="chunked"``: fixed-size chunks with halo context folded into
the batch axis) or sharded (``vocoder_mode="sharded"``: the chunk batch
split over a mesh's devices); ``synthesize_streaming`` yields the waveform
chunk by chunk (``vocoders/streaming.py``). ``frame_sharded_decode`` spreads
the diffusion decode's frames over the mesh's devices
(``parallel/sp.py``), eagerly; ``decode_pipelined`` runs every denoiser
call of the decode as a GPipe pipeline over the devices of the mesh's
model axis (``parallel/pp.py``), eagerly too.

On the GPU every other path's diffusion decode runs as the CUDA graph of its
(batch, frame bucket) (``models/decode_graph.py``), the counterpart of
JAX's jitted decode: captured at the first request of a shape, or ahead of
it by ``prewarm``, as JAX compiles at first use or in its prewarm. The rest
of the pass (BERT, the conformers, the variance adaptor, the vocoder with
its kernels) runs eagerly.

Each call of ``synthesize``, ``synthesize_async`` or
``synthesize_streaming`` gets a request id (a sequence number of the
``Synthesizer``), which its spans carry (``utils/trace.py``; recorded only
while a profiler runs or inside ``trace.recording()``): ``synth.request``
around the dispatch, inside it ``synth.inputs`` (padding and host-to-device
staging), ``synth.acoustic`` (``infer_cond``, and the duration pre-pass on
the two-phase path), ``synth.decode`` and ``synth.vocoder`` (the frame
mask, the F0 post-processing and the vocoder); ``synth.readback`` around
the readback and the split, in ``result()`` for an async request. A
mispredict's second pass records its own acoustic, decode and vocoder
spans. At resolve the counters ``synth.frames_decoded`` (the batch times
the frame bucket of every pass) and ``synth.frames_useful`` (the frame
lengths) are recorded.

F5-TTS (``models/f5tts.py``, with Vocos) is a second acoustic front
behind the same bucketing, graph decode, vocoder stage, readback and
spans: a request is the ids of the text to speak (``phoneme_seqs``), a
reference (``reference_mels`` or ``reference_wavs``) and the ids of its
transcript (``reference_texts``). Its frame count is F5-TTS's duration
rule, known on the host, so there is no pre-pass and no prediction:
``synthesize_async`` queues the whole pass at once, its copies to the
host included, and ``result()`` waits for that request alone, so the
next one queued keeps the device busy. ``synth.acoustic``
covers the reference's mel, the ids and the rule, ``synth.decode`` the
sampler's graph, ``synth.vocoder`` the generated frames' gather and
Vocos; a request returns only its generated frames (the mel and
generated frames x ``upsample`` samples), and its useful frames are all
the frames it decoded, the reference's included.
"""

from __future__ import annotations

import copy
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.models import decode_graph
from promptttspp_tpu_torch.models.f5tts import F5TTS, duration
from promptttspp_tpu_torch.ops.filters import lowpass_filter
from promptttspp_tpu_torch.parallel.mesh import make_mesh, replicas
from promptttspp_tpu_torch.parallel.pp import StageDevices
from promptttspp_tpu_torch.parallel.sp import (
    FrameShardedDenoiser, decode_frames_sharded)
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.utils import trace
from promptttspp_tpu_torch.vocoders.streaming import (
    vocode_chunked, vocode_sharded, vocode_streaming)

# F5-TTS decodes a request batch in groups of this many requests, sorted by
# frame count, each group padded to its own frame bucket and replayed as
# its own graph: a batch pays the quadratic attention of its groups'
# buckets, not of its longest request's (frame use 70% -> 94% at batch 16
# on the H100, PERF.md)
F5_DECODE_GROUP = 2


def _rounded_decoder(decoder, dtype: str):
    """A sampler with ``decoder``'s options around a copy of its denoiser
    whose floating parameters hold values rounded to ``dtype``."""
    denoise_fn = copy.deepcopy(decoder.denoise_fn)
    denoise_fn.param_dtype = getattr(torch, dtype)
    with torch.no_grad():
        for p in denoise_fn.parameters():
            if p.is_floating_point():
                p.copy_(p.to(denoise_fn.param_dtype))
    return decoder.clone(denoise_fn=denoise_fn)


class _PendingRequest:
    """Handle of a dispatched speculative request (``synthesize_async``):
    its launches are queued; ``result()`` makes the one readback, checks
    the bucket prediction and re-dispatches on overflow."""

    def __init__(self, synth, n_items, request_id, resolve):
        self._synth = synth
        self._n = n_items
        self._id = request_id
        self._resolve = resolve

    @torch.inference_mode()
    def result(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """-> (wavs, mels) exactly like ``synthesize``."""
        _, host = self._resolve()
        with trace.span("synth.readback", self._id):
            return self._synth._split(self._n, *host)


class Synthesizer:
    def __init__(self, model, vocoder=None,
                 mel_stats: Optional[Dict] = None, tokenizer=None,
                 to_mel=None, phone_quantum: int = 16,
                 frame_quantum: int = 128, max_frames_cap: int = 2048,
                 vocoder_mode: str = "batched", chunk_frames: int = 256,
                 halo_frames: int = 16,
                 first_chunk_frames: Optional[int] = None,
                 upsample: int = 240, speculative: bool = False,
                 spec_frames_per_phone: float = 10.0,
                 spec_duration_table: Optional[np.ndarray] = None,
                 spec_duration_std: Optional[np.ndarray] = None,
                 spec_margin: float = 3.0, spec_rate_margin: float = 0.2,
                 return_int16: bool = False,
                 decode_param_dtype: Optional[str] = None,
                 mesh=None, frame_sharded_decode: bool = False,
                 decode_pipelined: bool = False,
                 pipeline_microbatches: int = 1, device="cuda"):
        """model / vocoder: the port's modules; they are moved to
        ``device`` and put in eval mode. ``device`` defaults to ``cuda`` and
        raises if no GPU is present. ``to_mel``: a
        ``ops/mel.py::MelSpectrogramTransform`` for reference wavs.

        vocoder_mode: "batched", "chunked" (``chunk_frames`` with
        ``halo_frames`` of context; ``first_chunk_frames`` shrinks the first
        streamed chunk) or "sharded" (chunked, the chunk batch split over
        ``mesh``'s data axis, one vocoder replica per distinct device).

        frame_sharded_decode: the diffusion decode with every denoiser call
        split over ``mesh``'s data axis by frames, with halos
        (``parallel/sp.py``); eager, also on the GPU. The frame bucket must
        divide by the axis. ``mesh``: a ``parallel/mesh.py::Mesh``
        (default, for these three: ``make_mesh()``, every visible GPU on
        the data axis).

        decode_pipelined: every denoiser call of the decode runs the
        DiffNet's residual stack as a GPipe pipeline of one stage per
        device of ``mesh``'s model axis (its first data row; a device may
        repeat), in ``pipeline_microbatches`` microbatches
        (``parallel/pp.py``); eager, also on the GPU. The batch must divide
        into the microbatches, the DiffNet's layers into the stages.

        speculative: predict the frame bucket on the host instead of running
        the duration pre-pass (see the module docstring); counters
        ``spec_requests`` and ``spec_mispredicts``. With
        ``spec_duration_table`` / ``spec_duration_std`` (expected frames and
        std per phone id) the prediction is sum(mean) * (1 +
        ``spec_rate_margin``) + ``spec_margin`` * sqrt(sum(std^2)); without,
        ``spec_frames_per_phone`` times the longest phone count. The
        diffusion noise is drawn at the bucket shape, so a larger predicted
        bucket gives another (equally valid) sample than the exact one.

        return_int16: quantize the waveform to PCM16 on the device, where
        the JAX ``Synthesizer`` does: with ``vocoder_mode="batched"``
        (two-phase requests, those with ``x_T`` or ``zero_noise`` included,
        speculative and ``synthesize_async``). Chunked vocoding returns
        float32, and ``synthesize_streaming`` yields float32 chunks.

        decode_param_dtype: round the diffusion denoiser's floating
        parameters to this dtype ("bfloat16"), as JAX's bf16-stored decode
        weights; the math stays float32, as flax promotes bf16 parameters
        against float32 activations. The rounded values are kept in float32
        storage, because the decode's float32 convolutions and products
        read float32: the model passed in is not changed."""
        if vocoder_mode not in ("batched", "chunked", "sharded"):
            raise ValueError(f"vocoder_mode {vocoder_mode!r}: 'batched', "
                             "'chunked' or 'sharded'")
        if decode_pipelined and frame_sharded_decode:
            raise ValueError("decode_pipelined and frame_sharded_decode "
                             "exclude each other")
        self._f5 = isinstance(model, F5TTS)
        if self._f5 and (decode_param_dtype or decode_pipelined
                         or frame_sharded_decode or speculative
                         or vocoder_mode != "batched" or return_int16):
            raise ValueError("F5TTS is served batched, with its decode as "
                             "a graph, in float samples")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if self._f5:
            self._decoder = model
        else:
            self._decoder = (model.decoder if decode_param_dtype is None
                             else _rounded_decoder(model.decoder,
                                                   decode_param_dtype))
        self.vocoder = (None if vocoder is None
                        else vocoder.to(self.device).eval())
        self.mel_stats = mel_stats or {"mean": 0.0, "std": 1.0}
        self.tokenizer = tokenizer
        self.to_mel = to_mel
        self.phone_quantum = phone_quantum
        self.frame_quantum = frame_quantum
        self.max_frames_cap = max_frames_cap
        self.vocoder_mode = vocoder_mode
        self.chunk_frames = chunk_frames
        self.halo_frames = halo_frames
        self.first_chunk_frames = first_chunk_frames
        self.upsample = upsample
        self.speculative = speculative
        self.spec_frames_per_phone = float(spec_frames_per_phone)
        self.spec_duration_table = self.spec_duration_std = None
        if spec_duration_table is not None:
            tbl = np.asarray(spec_duration_table, np.float64).copy()
            tbl[0] = 0.0  # the pad id contributes no frames
            std = (np.zeros_like(tbl) if spec_duration_std is None
                   else np.asarray(spec_duration_std, np.float64).copy())
            std[0] = 0.0
            self.spec_duration_table, self.spec_duration_std = tbl, std
        self.spec_margin = float(spec_margin)
        self.spec_rate_margin = float(spec_rate_margin)
        self.return_int16 = return_int16
        self.spec_requests = 0
        self.spec_mispredicts = 0
        self._request_ids = itertools.count()  # the id of each API call
        self.frame_sharded_decode = frame_sharded_decode
        self.decode_pipelined = decode_pipelined
        if (vocoder_mode == "sharded" or frame_sharded_decode
                or decode_pipelined) and mesh is None:
            mesh = make_mesh()
        self.mesh = mesh
        if decode_pipelined:
            self._decoder = self._decoder.clone(
                pipeline=StageDevices(mesh.model_devices(0)),
                pipeline_microbatches=pipeline_microbatches)
        self._sharded_denoiser = None if not frame_sharded_decode else \
            FrameShardedDenoiser(self._decoder.denoise_fn, mesh.data_devices)
        self._voc_replicas = None
        if vocoder_mode == "sharded" and self.vocoder is not None:
            self._voc_replicas = replicas(self.vocoder, mesh.data_devices)

    # ------------------------------------------------------------ inputs
    def _to(self, arr):
        """Host array -> device tensor. A GPU copy is staged in pinned
        memory, so it is queued without waiting for the device."""
        t = torch.as_tensor(arr)
        if t.device.type == "cpu" and self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _pad_phonemes_host(self, seqs: Sequence[Sequence[int]]):
        Tp = bucket_shape(max(len(s) for s in seqs), self.phone_quantum)
        phoneme = np.zeros((len(seqs), Tp), np.int64)
        lens = np.zeros((len(seqs),), np.int64)
        for i, s in enumerate(seqs):
            phoneme[i, : len(s)] = s
            lens[i] = len(s)
        return phoneme, lens

    def _pad_phonemes(self, seqs: Sequence[Sequence[int]]):
        phoneme, lens = self._pad_phonemes_host(seqs)
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

    def _pad_ref_mels(self, mels):
        """Raw log-mels [T, n_mels] (host arrays, or tensors on the device)
        -> normalized with the global stats and zero-padded to a frame
        bucket, on the device: ([B, Tf, n_mels], lengths [B]). Host mels
        are padded on the host and copied at once."""
        lens = [int(m.shape[0]) for m in mels]
        shape = (len(mels), bucket_shape(max(lens), self.frame_quantum),
                 int(mels[0].shape[1]))
        if all(isinstance(m, torch.Tensor) and m.device == self.device
               for m in mels):
            raw = torch.zeros(shape, device=self.device)
            for i, m in enumerate(mels):
                raw[i, : lens[i]] = m
        else:
            host = np.zeros(shape, np.float32)
            for i, m in enumerate(mels):
                host[i, : lens[i]] = np.asarray(m, np.float32)
            raw = self._to(host)
        lens_t = self._to(np.asarray(lens, np.int64))
        valid = torch.arange(shape[1], device=self.device)[None, :, None] \
            < lens_t[:, None, None]
        mean, std = self.mel_stats["mean"], self.mel_stats["std"]
        return torch.where(valid, (raw - mean) / std, 0.0), lens_t

    def _wav_mels(self, wavs) -> List[torch.Tensor]:
        if self.to_mel is None:
            raise ValueError("a to_mel transform is required for wavs")
        return [self.to_mel.to_mel(self._to(np.asarray(w, np.float32)))
                for w in wavs]

    @torch.inference_mode()
    def wav_to_mel(self, wav: np.ndarray) -> np.ndarray:
        """24 kHz wav [Ts] -> raw log-mel [T, n_mels]."""
        return self._wav_mels([wav])[0].cpu().numpy()

    def _request(self, phoneme_seqs, prompts, reference_mels,
                 reference_wavs, use_max, noise_scale, seed,
                 request_id=None):
        """-> (host phonemes, host lengths, request dict of device inputs)
        for exactly one of prompts / reference_mels / reference_wavs; the
        dict's ``id`` is ``request_id``, which the passes' spans carry."""
        n_cond = sum(c is not None
                     for c in (prompts, reference_mels, reference_wavs))
        if n_cond != 1:
            raise ValueError("exactly one of prompts / reference_mels / "
                             "reference_wavs must be given")
        with trace.span("synth.inputs", request_id):
            phoneme, plens = self._pad_phonemes_host(phoneme_seqs)
            req = dict(phoneme=self._to(phoneme), plens=self._to(plens),
                       prompt_ids=None, prompt_mask=None, ref_mel=None,
                       ref_lens=None, use_max=use_max,
                       noise_scale=noise_scale, seed=seed, id=request_id)
            if prompts is not None:
                req["prompt_ids"], req["prompt_mask"] = \
                    self._encode_prompts(prompts)
            else:
                if reference_wavs is not None:
                    reference_mels = self._wav_mels(reference_wavs)
                req["ref_mel"], req["ref_lens"] = \
                    self._pad_ref_mels(reference_mels)
        return phoneme, plens, req

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------ passes
    def _frame_bucket(self, req) -> int:
        """Two-phase: duration pre-pass, one readback, frame bucket."""
        with trace.span("synth.acoustic", req["id"]):
            frame_lens = self.model.infer_frame_lengths(
                req["phoneme"], req["plens"], req["prompt_ids"],
                req["prompt_mask"], req["ref_mel"], req["ref_lens"],
                use_max=req["use_max"], noise_scale=0.0,
                style_generator=self._generator(req["seed"]))
            return min(bucket_shape(int(frame_lens.max()),
                                    self.frame_quantum), self.max_frames_cap)

    def _acoustic(self, req, max_frames: int, x_T=None,
                  zero_noise: bool = False):
        """``model.infer`` with the decode as a graph (``decode_graph``),
        or frame-sharded or pipelined (eager), + F0 post + mel
        denormalization -> (mel_denorm, f0, frame_lengths,
        raw_frame_lengths), all on the device. The frame mask and the F0
        post-processing are the vocoder's span."""
        rid = req["id"]
        with trace.span("synth.acoustic", rid):
            cond, flens, fmask, log_cf0, vuv, raw = self.model.infer_cond(
                req["phoneme"], req["plens"], max_frames, req["prompt_ids"],
                req["prompt_mask"], req["ref_mel"], req["ref_lens"],
                use_max=req["use_max"], noise_scale=req["noise_scale"],
                style_generator=self._generator(req["seed"]))
        with trace.span("synth.decode", rid):
            if self.decode_pipelined:
                mel = self._decoder.inference(
                    cond, x_T, zero_noise, self._generator(req["seed"] + 1))
            elif self.frame_sharded_decode:
                mel = decode_frames_sharded(
                    self.mesh, self._decoder, cond, x_T, zero_noise,
                    self._generator(req["seed"] + 1),
                    denoiser=self._sharded_denoiser)
            else:
                mel = decode_graph.decode(self._decoder, cond, x_T,
                                          zero_noise,
                                          self._generator(req["seed"] + 1))
        with trace.span("synth.vocoder", rid):
            mel = mel * fmask[:, :, None].to(mel.dtype)
            f0, mel_denorm = self._postprocess(mel, log_cf0, vuv)
        return mel_denorm, f0, flens, raw

    def _postprocess(self, mel, log_cf0, vuv):
        """F0 smoothing + vuv gating and mel denormalization."""
        log_cf0 = lowpass_filter(log_cf0[..., 0], fs=100, cutoff=20)
        f0 = torch.where(vuv[..., 0] > 0.5, torch.exp(log_cf0),
                         torch.zeros_like(log_cf0))[..., None]
        mel_denorm = mel * self.mel_stats["std"] + self.mel_stats["mean"]
        return f0, mel_denorm

    def _vocode(self, mel_denorm, f0):
        """-> wav [B, samples, 1]. Chunked and sharded vocoding return
        float32 whatever ``return_int16`` says: as in JAX, only the batched
        vocoder (JAX's fused request program) quantizes."""
        if self.vocoder_mode == "sharded":
            return vocode_sharded(self.mesh, self.vocoder, mel_denorm, f0,
                                  chunk_frames=self.chunk_frames,
                                  halo_frames=self.halo_frames,
                                  upsample=self.upsample,
                                  replicas=self._voc_replicas,
                                  deterministic=True)
        if self.vocoder_mode == "chunked":
            return vocode_chunked(self.vocoder, mel_denorm, f0,
                                  chunk_frames=self.chunk_frames,
                                  halo_frames=self.halo_frames,
                                  upsample=self.upsample, deterministic=True)
        wav = self.vocoder(mel_denorm, f0, deterministic=True)
        if self.return_int16:
            wav = torch.clamp(torch.round(wav * 32767.0), -32768.0,
                              32767.0).to(torch.int16)
        return wav

    def _full_pass(self, req, max_frames: int, x_T=None,
                   zero_noise: bool = False):
        """text -> wav queued on the device -> (wav, mel_denorm,
        frame_lengths, raw_frame_lengths)."""
        mel_denorm, f0, flens, raw = self._acoustic(req, max_frames, x_T,
                                                    zero_noise)
        with trace.span("synth.vocoder", req["id"]):
            wav = None if self.vocoder is None else self._vocode(mel_denorm,
                                                                 f0)
        return wav, mel_denorm, flens, raw

    def _readback(self, *tensors):
        """Device -> host copies of ``tensors`` (None stays None), all
        queued first, then one wait for the device."""
        host = [None if t is None else t.to("cpu", non_blocking=True)
                for t in tensors]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return [None if h is None else h.numpy() for h in host]

    @staticmethod
    def _count_frames(n_items: int, buckets: Sequence[int], flens_np):
        """Record a resolved request's frames: those its passes decoded
        (the batch times each pass's frame bucket) and the useful ones
        (its frame lengths)."""
        if trace.active():
            trace.count("synth.frames_decoded", n_items * sum(buckets))
            trace.count("synth.frames_useful", int(np.sum(flens_np)))

    def _split(self, n_items, wav_np, mel_np, flens_np):
        wavs, mels = [], []
        for i in range(n_items):
            n = int(flens_np[i])
            if mel_np is not None:
                mels.append(mel_np[i, :n])
            if wav_np is not None:
                wavs.append(wav_np[i, : n * self.upsample, 0])
        return wavs, mels

    # ------------------------------------------------------------- F5-TTS
    def _dispatch_f5(self, text_seqs, reference_texts, reference_mels,
                     reference_wavs, seed, return_mels,
                     request_id) -> _PendingRequest:
        """Queue an F5-TTS request's whole pass; the handle's ``result()``
        reads it back. ``seed``: one per request, or an int that gives
        request i the seed ``seed + i``."""
        B = len(text_seqs)
        if reference_texts is None or len(reference_texts) != B:
            raise ValueError("F5TTS takes a reference_texts entry per "
                             "request")
        if (reference_mels is None) == (reference_wavs is None):
            raise ValueError("exactly one of reference_mels / "
                             "reference_wavs must be given")
        seeds = ([int(seed) + i for i in range(B)]
                 if isinstance(seed, (int, np.integer)) else list(seed))
        with trace.span("synth.inputs", request_id):
            refs = [self._to(np.asarray(r, np.float32))
                    for r in (reference_wavs if reference_mels is None
                              else reference_mels)]
        with trace.span("synth.acoustic", request_id):
            if reference_mels is None:
                refs = [self.to_mel.to_mel(w) for w in refs]
            ref_lens = [int(m.shape[0]) for m in refs]
            lens = [duration(r, len(rt), len(t)) for r, rt, t in
                    zip(ref_lens, reference_texts, text_seqs)]
            if max(lens) > self.max_frames_cap:
                raise ValueError(f"{max(lens)} frames exceed the cap "
                                 f"{self.max_frames_cap}")
            order = sorted(range(B), key=lambda i: lens[i])
            groups = [order[j:j + F5_DECODE_GROUP]
                      for j in range(0, B, F5_DECODE_GROUP)]
            ref_t = self._to(np.asarray(ref_lens, np.int64))
        gen = np.asarray([n - r for n, r in zip(lens, ref_lens)], np.int64)
        G = bucket_shape(int(gen.max()), self.frame_quantum)
        gen_mel = torch.zeros((B, G, self.model.out_dim), device=self.device)
        decoded = 0
        for group in groups:
            with trace.span("synth.acoustic", request_id):
                T = bucket_shape(max(lens[i] for i in group),
                                 self.frame_quantum)
                decoded += len(group) * T
                mel = torch.zeros((len(group), T, self.model.out_dim),
                                  device=self.device)
                ids = np.zeros((len(group), T), np.int64)
                for row, i in enumerate(group):
                    mel[row, : ref_lens[i]] = refs[i]
                    text = list(reference_texts[i]) + list(text_seqs[i])
                    text = np.asarray(text[: lens[i]], np.int64) + 1
                    ids[row, : len(text)] = text
                rows = self._to(np.asarray(group, np.int64))
                cond = (mel, self._to(ids), self._to(np.asarray(
                    [lens[i] for i in group], np.int64)), ref_t[rows])
                x_T = F5TTS.draw_y0([lens[i] for i in group],
                                    [seeds[i] for i in group], T,
                                    self.model.out_dim, self.device)
            with trace.span("synth.decode", request_id):
                out = decode_graph.decode(self._decoder, cond, x_T)
            with trace.span("synth.vocoder", request_id):
                idx = (cond[3][:, None] + torch.arange(G, device=self.device)
                       ).clamp(max=T - 1)
                gen_mel.index_copy_(0, rows, torch.gather(
                    out, 1, idx[:, :, None].expand(-1, -1, out.shape[-1])))
        with trace.span("synth.vocoder", request_id):
            wav = self.vocoder(gen_mel, self._to(gen))[:, :, None]
        # the copies to the host are queued now, behind this request's own
        # work, and ``result()`` waits for them alone: a request queued
        # after this one keeps the device busy meanwhile
        back = [None if t is None else t.to("cpu", non_blocking=True)
                for t in (wav, gen_mel if return_mels else None)]
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()

        def resolve():
            with trace.span("synth.readback", request_id):
                if done is not None:
                    done.synchronize()
                host = [None if t is None else t.numpy() for t in back]
            if trace.active():
                trace.count("synth.frames_decoded", decoded)
                trace.count("synth.frames_useful", int(sum(lens)))
            return None, host + [gen]

        return _PendingRequest(self, B, request_id, resolve)

    # ------------------------------------------------------- speculative
    def _predict_frames(self, phoneme: np.ndarray, plens: np.ndarray) -> int:
        """Host-side frame-bucket prediction for speculative dispatch.

        With a per-phone duration table: the sum of the request's per-phone
        means times (1 + ``spec_rate_margin``) plus ``spec_margin``
        standard deviations of the sum; ids outside the table count
        ``spec_frames_per_phone``. Without one: ``spec_frames_per_phone``
        times the longest phone count."""
        if self.spec_duration_table is not None:
            n = len(self.spec_duration_table)
            known = phoneme < n
            safe = np.where(known, phoneme, 0)
            mean = np.where(known & (phoneme > 0),
                            self.spec_duration_table[safe],
                            np.where(phoneme > 0, self.spec_frames_per_phone,
                                     0.0)).sum(axis=1)
            var = np.where(known, self.spec_duration_std[safe] ** 2,
                           0.0).sum(axis=1)
            frames = float(np.max(mean * (1.0 + self.spec_rate_margin)
                                  + self.spec_margin * np.sqrt(var)))
        else:
            frames = float(np.max(plens)) * self.spec_frames_per_phone
        return min(bucket_shape(max(1, int(np.ceil(frames))),
                                self.frame_quantum), self.max_frames_cap)

    def _speculative(self, phoneme, plens, run, request_id):
        """Speculative dispatch. ``run(bucket)`` queues a pass at a frame
        bucket and returns (device outputs, device tensors to read back,
        the frame lengths and the unclipped duration sums last). The pass
        is queued at once at the predicted bucket, with no readback.
        Returns ``resolve()``, which makes the one readback and, when the
        duration sums overflow the prediction, runs the pass again at the
        true bucket (right, just slower for this request) -> (device
        outputs, host arrays of the other read-back tensors)."""
        self.spec_requests += 1
        pred = self._predict_frames(phoneme, plens)
        out, back = run(pred)

        def resolve():
            with trace.span("synth.readback", request_id):
                host = self._readback(*back)
            done, buckets = out, [pred]
            true_max = int(host[-1].max())
            if true_max > pred and pred < self.max_frames_cap:
                self.spec_mispredicts += 1
                buckets.append(min(bucket_shape(true_max, self.frame_quantum),
                                   self.max_frames_cap))
                done, back_again = run(buckets[-1])
                with trace.span("synth.readback", request_id):
                    host = self._readback(*back_again)
            self._count_frames(len(plens), buckets, host[-2])
            return done, host[:-1]

        return resolve

    def _dispatch_speculative(self, n_items, phoneme, plens, req,
                              return_mels) -> _PendingRequest:
        """Queue the full pass at the predicted bucket; no readback."""
        def run(max_frames):
            wav, mel, flens, raw = self._full_pass(req, max_frames)
            return None, (wav, mel if return_mels else None, flens, raw)

        return _PendingRequest(self, n_items, req["id"], self._speculative(
            phoneme, plens, run, req["id"]))

    # ----------------------------------------------------------- prewarm
    def _speculative_grid(self, max_phones: int):
        """The (phone bucket, frame bucket) pairs that speculative serving
        dispatches for phone counts up to ``max_phones``: for each phone
        bucket, the frame buckets its phone counts predict (with a duration
        table, one frame bucket more on each side, since its prediction
        depends on the phones). Every phone bucket up to ``max_phones`` is
        listed, also past the one whose prediction reaches
        ``max_frames_cap``."""
        pq, fq = self.phone_quantum, self.frame_quantum
        if self.spec_duration_table is not None:
            t = self.spec_duration_table[1:]
            s = self.spec_duration_std[1:]
            mean_fpp = float(t[t > 0].mean()) if (t > 0).any() else 10.0
            mean_var = float((s[t > 0] ** 2).mean()) if (t > 0).any() else 0.0
        pairs = []
        for p in range(pq, bucket_shape(max_phones, pq) + 1, pq):
            frames = set()
            for n in range(p - pq + 1, p + 1):
                if self.spec_duration_table is not None:
                    f = (n * mean_fpp * (1.0 + self.spec_rate_margin)
                         + self.spec_margin * np.sqrt(n * mean_var))
                else:
                    f = n * self.spec_frames_per_phone
                fb = min(bucket_shape(max(1, int(np.ceil(f))), fq),
                         self.max_frames_cap)
                frames.add(fb)
                if self.spec_duration_table is not None:
                    frames.add(max(fq, fb - fq))
                    frames.add(min(self.max_frames_cap, fb + fq))
            pairs.extend((p, f) for f in sorted(frames))
        return pairs

    @torch.inference_mode()
    def prewarm(self, batch_sizes=(1,), prompt_lens=(32,),
                grid: str = "speculative", max_phones: int = 256,
                use_max: bool = True, noise_scale: float = 0.5,
                streaming: bool = False, log=None):
        """Run one full text -> wav pass at every serving shape ahead of
        the first request: on the GPU it captures the decode graph of each
        (batch, frame bucket), builds the kernels and sets up cuDNN's and
        cuBLAS's plans, which a request would otherwise pay at its first
        shape. The duration pre-pass runs once per phone bucket.

        grid="speculative": the shapes speculative serving dispatches for
        phone counts up to ``max_phones`` (``_speculative_grid``);
        grid="full": every (phone, frame) bucket pair up to (max_phones,
        ``max_frames_cap``), mispredict re-dispatches included.
        streaming=True also runs the acoustic-only pass of
        ``synthesize_streaming`` at every grid entry and the streaming
        vocoder over a first chunk and one full chunk. Returns
        [{B, Tp, Tf, L, seconds}, ...], one row per grid entry, and with
        ``streaming`` one row per batch size with
        ``program="streaming_vocoder_chunks"``."""
        if self.vocoder is None:
            raise ValueError("prewarm requires a vocoder")
        pq, fq = self.phone_quantum, self.frame_quantum
        if grid == "speculative":
            pairs = self._speculative_grid(max_phones)
        elif grid == "full":
            phones = range(pq, bucket_shape(max_phones, pq) + 1, pq)
            pairs = [(p, f) for p in phones
                     for f in range(fq, self.max_frames_cap + 1, fq)]
        else:
            raise ValueError(f"unknown prewarm grid {grid!r}")
        rows = []
        for B in batch_sizes:
            for L in prompt_lens:
                ones = np.ones((B, L), np.int64)
                warmed = set()
                for p, f in pairs:
                    req = dict(phoneme=self._to(np.ones((B, p), np.int64)),
                               plens=self._to(np.full((B,), p, np.int64)),
                               prompt_ids=self._to(ones),
                               prompt_mask=self._to(ones), ref_mel=None,
                               ref_lens=None, use_max=use_max,
                               noise_scale=noise_scale, seed=0, id=None)
                    t0 = time.perf_counter()
                    self._readback(self._full_pass(req, f)[2])
                    if streaming:
                        self._readback(self._acoustic(req, f)[2])
                    if p not in warmed:
                        warmed.add(p)
                        self._frame_bucket(req)
                    dt = time.perf_counter() - t0
                    rows.append(dict(B=B, Tp=p, Tf=f, L=L,
                                     seconds=round(dt, 2)))
                    if log is not None:
                        log(f"prewarm B={B} Tp={p} Tf={f} L={L}: "
                            f"{dt:.1f}s")
            if streaming:
                t0 = time.perf_counter()
                T = (self.first_chunk_frames
                     or self.chunk_frames) + self.chunk_frames
                mel = torch.zeros((B, T, self.model.decoder.out_dim),
                                  device=self.device)
                f0 = torch.zeros((B, T, 1), device=self.device)
                for wav in vocode_streaming(
                        self.vocoder, mel, f0,
                        chunk_frames=self.chunk_frames,
                        halo_frames=self.halo_frames,
                        upsample=self.upsample,
                        first_chunk_frames=self.first_chunk_frames,
                        deterministic=True):
                    self._readback(wav)
                dt = time.perf_counter() - t0
                rows.append(dict(B=B, Tp=0, Tf=T, L=0, seconds=round(dt, 2),
                                 program="streaming_vocoder_chunks"))
                if log is not None:
                    log(f"prewarm streaming vocoder chunks B={B}: "
                        f"{dt:.1f}s")
        return rows

    # --------------------------------------------------------------- API
    @torch.inference_mode()
    def synthesize_async(self, phoneme_seqs: Sequence[Sequence[int]],
                         prompts: Optional[Sequence[str]] = None,
                         reference_mels=None, reference_wavs=None,
                         use_max: bool = True, noise_scale: float = 0.5,
                         seed: int = 0,
                         return_mels: bool = False,
                         reference_texts=None) -> _PendingRequest:
        """Queue a speculative request without waiting for the device; the
        handle's ``result()`` makes the one readback and returns (wavs,
        mels) like ``synthesize``. Submitting request N+1 before resolving
        request N keeps the device busy while N's audio comes back.

        Requires ``speculative=True``, a vocoder,
        ``vocoder_mode="batched"`` and ``frame_sharded_decode=False``; an
        F5-TTS request (``reference_texts``) needs none of them."""
        if self._f5:
            rid = next(self._request_ids)
            with trace.span("synth.request", rid):
                return self._dispatch_f5(phoneme_seqs, reference_texts,
                                         reference_mels, reference_wavs,
                                         seed, return_mels, rid)
        if not (self.speculative and self.vocoder is not None
                and self.vocoder_mode == "batched"
                and not self.frame_sharded_decode):
            raise ValueError("synthesize_async requires speculative=True, "
                             "a vocoder, vocoder_mode='batched' and "
                             "frame_sharded_decode=False")
        rid = next(self._request_ids)
        with trace.span("synth.request", rid):
            phoneme, plens, req = self._request(
                phoneme_seqs, prompts, reference_mels, reference_wavs,
                use_max, noise_scale, seed, rid)
            return self._dispatch_speculative(len(phoneme_seqs), phoneme,
                                              plens, req, return_mels)

    @torch.inference_mode()
    def synthesize(self, phoneme_seqs: Sequence[Sequence[int]],
                   prompts: Optional[Sequence[str]] = None,
                   reference_mels=None, reference_wavs=None,
                   use_max: bool = True, noise_scale: float = 0.5,
                   seed: int = 0, return_mels: bool = True, x_T=None,
                   zero_noise: bool = False, reference_texts=None
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Synthesize with exactly one of style-prompt strings, raw log-mel
        references [T, n_mels] or 24 kHz reference wavs -> (list of wav
        arrays, list of mel [T, n_mels] arrays; [] when ``return_mels`` is
        False). ``x_T`` [B, frame_bucket, n_mels] and ``zero_noise`` make
        the decode deterministic (parity checks); ``x_T`` must match the
        exact frame bucket, so both take the two-phase path.

        F5-TTS: ``phoneme_seqs`` are the ids of the text to speak,
        ``reference_texts`` those of each reference's transcript; the
        generated part is returned."""
        if self._f5:
            return self.synthesize_async(
                phoneme_seqs, reference_mels=reference_mels,
                reference_wavs=reference_wavs, seed=seed,
                return_mels=return_mels,
                reference_texts=reference_texts).result()
        n = len(phoneme_seqs)
        rid = next(self._request_ids)
        with trace.span("synth.request", rid):
            phoneme, plens, req = self._request(
                phoneme_seqs, prompts, reference_mels, reference_wavs,
                use_max, noise_scale, seed, rid)
            pending = None
            if (self.speculative and self.vocoder is not None
                    and self.vocoder_mode == "batched"
                    and not self.frame_sharded_decode and x_T is None
                    and not zero_noise):
                pending = self._dispatch_speculative(n, phoneme, plens, req,
                                                     return_mels)
            else:
                max_frames = self._frame_bucket(req)
                if x_T is not None:
                    x_T = torch.as_tensor(x_T, dtype=torch.float32,
                                          device=self.device)
                wav, mel, flens, _ = self._full_pass(req, max_frames, x_T,
                                                     zero_noise)
        if pending is not None:
            return pending.result()
        with trace.span("synth.readback", rid):
            host = self._readback(wav, mel if return_mels else None, flens)
            self._count_frames(n, [max_frames], host[-1])
            return self._split(n, *host)

    def synthesize_streaming(self, phoneme_seqs: Sequence[Sequence[int]],
                             prompts: Optional[Sequence[str]] = None,
                             reference_mels=None, reference_wavs=None,
                             use_max: bool = True, noise_scale: float = 0.5,
                             seed: int = 0):
        """Generator of waveform chunks [B, width * upsample] (numpy) as
        they are computed: one acoustic pass (text -> denormalized mel and
        gated F0, the diffusion decode included), then the vocoder chunk by
        chunk with halo context and a phase-continuous NSF source, so the
        stitched stream equals the batched waveform in the interior. With
        ``speculative=True`` the acoustic pass skips the duration pre-pass
        as ``synthesize`` does.

        The generator's return value (``StopIteration.value``) is the
        per-item frame lengths: item i's stream is
        ``flens[i] * upsample`` samples long."""
        if self.vocoder is None:
            raise ValueError("streaming requires a vocoder")
        rid = next(self._request_ids)
        with torch.inference_mode():
            with trace.span("synth.request", rid):
                phoneme, plens, req = self._request(
                    phoneme_seqs, prompts, reference_mels, reference_wavs,
                    use_max, noise_scale, seed, rid)
                if self.speculative:
                    def run(max_frames):
                        mel_denorm, f0, flens, raw = self._acoustic(
                            req, max_frames)
                        return (mel_denorm, f0), (flens, raw)

                    resolve = self._speculative(phoneme, plens, run, rid)
                else:
                    max_frames = self._frame_bucket(req)
                    mel_denorm, f0, flens, _ = self._acoustic(req,
                                                              max_frames)
            if self.speculative:
                (mel_denorm, f0), (flens_np,) = resolve()
            else:
                with trace.span("synth.readback", rid):
                    flens_np, = self._readback(flens)
                self._count_frames(len(plens), [max_frames], flens_np)
            chunks = vocode_streaming(
                self.vocoder, mel_denorm, f0,
                chunk_frames=self.chunk_frames, halo_frames=self.halo_frames,
                upsample=self.upsample,
                first_chunk_frames=self.first_chunk_frames,
                deterministic=True)
        while True:
            with torch.inference_mode():
                with trace.span("synth.vocoder", rid):
                    wav = next(chunks, None)
                if wav is None:
                    return flens_np
                with trace.span("synth.readback", rid):
                    wav = wav[:, :, 0].cpu().numpy()
            yield wav


def write_wav(path, wav: np.ndarray, sample_rate: int = 24000):
    """float wav in [-1, 1] (clipped) -> 16-bit PCM file."""
    from scipy.io import wavfile

    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
