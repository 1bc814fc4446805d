"""Chunked and streaming vocoder synthesis.

Counterpart of ``promptttspp_tpu/vocoders/streaming.py`` (``vocode_chunked``,
``vocode_sharded`` and ``vocode_streaming``). The vocoder runs over
fixed-size mel chunks, each with ``halo_frames`` of context on both sides
that is synthesized and dropped:

- ``vocode_chunked`` folds the chunks into the batch axis and synthesizes
  them in one vocoder call;
- ``vocode_sharded`` pads that chunk batch to a multiple of a mesh's data
  axis and splits it over its devices, one vocoder call on each;
- ``vocode_streaming`` yields waveform chunks one after another (the first
  may be shorter, ``first_chunk_frames``: the time-to-first-audio ramp).

The mel and F0 are edge-padded: ``halo_frames`` on the left, and on the right
up to the chunk grid plus ``halo_frames``. For the F0-aware vocoder each
chunk gets the NSF source phase accumulated before its first output frame,
measured from the unpadded t = 0 (``phase0``), so the harmonic excitation
is continuous across chunks and the stitched waveform equals the batched
one in the interior.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from promptttspp_tpu_torch.parallel.mesh import replicas as mesh_replicas


def _replicate(x, left: int, right: int):
    """Edge-pad [B, T, C] along time."""
    return F.pad(x.transpose(1, 2), (left, right),
                 mode="replicate").transpose(1, 2)


def _pad_to(x, length: int):
    """Edge-pad [B, T, C] on the right up to ``length`` frames."""
    return _replicate(x, 0, max(length - x.shape[1], 0))


def _chunk_phase0(f0_p, starts, halo_frames: int, upsample: int,
                  sample_rate: int):
    """Fundamental NSF phase (revolutions) accumulated before each chunk's
    input start, re-referenced to the unpadded stream's t = 0.

    Frame-nearest x``upsample`` upsampling makes the phase at the start of
    padded frame p equal (upsample / sr) * sum(f0_p[:, :p]); subtracting the
    left halo pad's share re-references it to the real t = 0, so chunk i's
    output region carries the full synthesis's phase. -> [B, n]. The
    starts are sliced one by one: an index tensor would be a copy from host
    memory, which waits for the device's queue."""
    cum = torch.cumsum(f0_p[..., 0], dim=1)
    excl = F.pad(cum, (1, 0))[:, :-1]  # exclusive cumsum
    ph = torch.cat([excl[:, s:s + 1] for s in starts], dim=1) \
        - excl[:, halo_frames:halo_frames + 1]
    return (ph * (upsample / sample_rate)) % 1.0


def _vocoder_sr(vocoder, sample_rate: Optional[int]):
    return sample_rate or getattr(vocoder, "sampling_rate", None)


def _chunk_grid(T: int, step: int, first: Optional[int] = None
                ) -> Tuple[List[Tuple[int, int]], int]:
    """Output spans [(start, width), ...] covering [0, padded T).

    ``first`` < ``step`` shrinks only the first chunk, the
    time-to-first-audio ramp. Returns (spans, padded_total)."""
    if first is None or first >= step or first >= T:
        n = -(-T // step)
        return [(i * step, step) for i in range(n)], n * step
    n_rest = -(-(T - first) // step)
    spans = [(0, first)] + [(first + i * step, step) for i in range(n_rest)]
    return spans, first + n_rest * step


def _chunk_batch(vocoder, mel, f0, n_chunks: int, step: int,
                 halo_frames: int, upsample: int, sample_rate):
    """The vocoder's inputs for ``n_chunks`` chunks of ``step`` frames
    with their halos, folded into the batch axis -> (args, kwargs), each
    tensor [B * n_chunks, ...], batch-major."""
    B, T, M = mel.shape
    Tp = n_chunks * step
    win = step + 2 * halo_frames
    idx = (torch.arange(n_chunks, device=mel.device)[:, None] * step
           + torch.arange(win, device=mel.device)[None, :])  # [n, win]
    mel_p = _replicate(_pad_to(mel, Tp + halo_frames), halo_frames, 0)
    args = (mel_p[:, idx, :].reshape(B * n_chunks, win, M),)
    kwargs = {}
    if f0 is not None:
        f0_p = _replicate(_pad_to(f0, Tp + halo_frames), halo_frames, 0)
        args = args + (f0_p[:, idx, :].reshape(B * n_chunks, win, 1),)
        sr = _vocoder_sr(vocoder, sample_rate)
        if sr:
            starts = range(0, Tp, step)
            kwargs["phase0"] = _chunk_phase0(
                f0_p, starts, halo_frames, upsample, sr).reshape(
                    B * n_chunks, 1)
    return args, kwargs


def _stitch(wav_c, B: int, T: int, n_chunks: int, step: int,
            halo_frames: int, upsample: int):
    """The chunks' waveforms [B * n_chunks, samples, 1] without their halos,
    joined -> [B, T * upsample, 1]."""
    h = halo_frames * upsample
    wav = wav_c[:, h:h + step * upsample, :].reshape(
        B, n_chunks * step * upsample, 1)
    return wav[:, : T * upsample, :]


def vocode_chunked(vocoder, mel, f0=None, chunk_frames: int = 256,
                   halo_frames: int = 16, upsample: int = 240,
                   sample_rate: Optional[int] = None, **forward_kwargs):
    """mel [B, T, n_mels] (+ f0 [B, T, 1]) -> wav [B, T * upsample, 1],
    every chunk in one batched vocoder call."""
    B, T, _ = mel.shape
    n_chunks = -(-T // chunk_frames)
    args, kwargs = _chunk_batch(vocoder, mel, f0, n_chunks, chunk_frames,
                                halo_frames, upsample, sample_rate)
    wav_c = vocoder(*args, **forward_kwargs, **kwargs)
    return _stitch(wav_c, B, T, n_chunks, chunk_frames, halo_frames,
                   upsample)


def vocode_sharded(mesh, vocoder, mel, f0=None, chunk_frames: int = 256,
                   halo_frames: int = 16, upsample: int = 240,
                   sample_rate: Optional[int] = None, replicas=None,
                   **forward_kwargs):
    """``vocode_chunked`` spread over ``mesh``'s data axis: the chunk
    batch, padded to a multiple of the axis's W chunks, is split into W
    contiguous blocks, one vocoder call each on its device
    (``replicas``: {device: vocoder}, default ``parallel.mesh.replicas``); the
    waveform comes back on mel's device. Padding chunks are synthesized
    and dropped, so the result is ``vocode_chunked``'s."""
    B, T, _ = mel.shape
    devices = mesh.data_devices
    n_data = len(devices)
    n_chunks = -(-(-(-T // chunk_frames)) // n_data) * n_data
    args, kwargs = _chunk_batch(vocoder, mel, f0, n_chunks, chunk_frames,
                                halo_frames, upsample, sample_rate)
    replicas = replicas or mesh_replicas(vocoder, devices)
    per = B * n_chunks // n_data
    outs = []
    for i, d in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        outs.append(replicas[d](
            *(a[rows].to(d) for a in args), **forward_kwargs,
            **{k: v[rows].to(d) for k, v in kwargs.items()}).to(mel.device))
    return _stitch(torch.cat(outs), B, T, n_chunks, chunk_frames,
                   halo_frames, upsample)


def vocode_streaming(vocoder, mel, f0=None, chunk_frames: int = 256,
                     halo_frames: int = 16, upsample: int = 240,
                     sample_rate: Optional[int] = None,
                     first_chunk_frames: Optional[int] = None,
                     **forward_kwargs) -> Iterator[torch.Tensor]:
    """Generator of wav chunks [B, width * upsample, 1], one vocoder call
    each (the last chunk may be shorter), with the NSF source phase
    continuous across chunks."""
    B, T, M = mel.shape
    spans, Tp = _chunk_grid(T, chunk_frames, first_chunk_frames)
    mel_p = _replicate(_pad_to(mel, Tp + halo_frames), halo_frames, 0)
    f0_p = phase0 = None
    if f0 is not None:
        f0_p = _replicate(_pad_to(f0, Tp + halo_frames), halo_frames, 0)
        sr = _vocoder_sr(vocoder, sample_rate)
        if sr:
            phase0 = _chunk_phase0(f0_p, [s for s, _ in spans], halo_frames,
                                   upsample, sr)
    h = halo_frames * upsample
    for ci, (s, w) in enumerate(spans):
        win = w + 2 * halo_frames
        args = (mel_p[:, s:s + win],)
        kwargs = dict(forward_kwargs)
        if f0_p is not None:
            args = args + (f0_p[:, s:s + win],)
            if phase0 is not None:
                kwargs["phase0"] = phase0[:, ci:ci + 1]
        wav = vocoder(*args, **kwargs)[:, h:h + w * upsample, :]
        remaining = (T - s) * upsample
        if remaining < w * upsample:
            wav = wav[:, :remaining, :]
        yield wav
