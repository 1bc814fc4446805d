"""The system under test for the F5-TTS cells: the port's
``infer.Synthesizer`` around F5-TTS and Vocos of the cell's configuration,
with weights the benchmark makes from the seed (``weights.py``), serving
voice-cloning requests.

A request of ``traffic/requests.py`` becomes an F5-TTS request: its
``phones`` are the ids of the text to speak, its ``prompt`` the ids of the
reference's transcript, and the reference is a waveform made from the
request's seed, as long as the transcript at ``chars_per_s`` characters a
second (``reference_audio``): harmonics of an F0 gliding inside
``f0_hz`` under a slow envelope, with noise, at ``rms``. The waveform
holds (frames - 1) x hop samples, so its centred mel holds ``frames``.
The waveforms of every request of the pool are made at set-up
(``Server.warm``): made inside the window, their ~0.5 s of host work a
batch lay between the decode graphs, whose launches keep the host in step
with the device, and the device idled meanwhile.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from perfbench.harness import weights
from perfbench.harness.serving import set_float32


def reference_frames(cfg: Dict, n_chars: int) -> int:
    """The mel frames of a reference whose transcript has ``n_chars``
    characters."""
    a, mel = cfg["reference_audio"], cfg["model"]["mel_spec"]
    seconds = n_chars / a["chars_per_s"]
    return int(math.ceil(seconds * mel["target_sample_rate"]
                         / mel["hop_length"]))


def reference_wav(cfg: Dict, n_chars: int, seed: int,
                  device: str = "cpu") -> np.ndarray:
    """The seeded reference waveform of a transcript of ``n_chars``, made
    in float64 on ``device`` (the same seed and device give the same
    samples)."""
    a, mel = cfg["reference_audio"], cfg["model"]["mel_spec"]
    sr, hop = mel["target_sample_rate"], mel["hop_length"]
    n = (reference_frames(cfg, n_chars) - 1) * hop
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 21])
    rate, start = rng.uniform(0.2, 0.8), rng.uniform(0, 2 * np.pi)
    noise = torch.Generator(device).manual_seed(int(rng.integers(2**62)))
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / sr
    lo, hi = a["f0_hz"]
    f0 = lo + (hi - lo) * (0.5 + 0.5 * torch.sin(2 * np.pi * rate * t
                                                  + start))
    phase = 2 * np.pi * torch.cumsum(f0, 0) / sr
    wav = sum(torch.sin(k * phase) / k for k in range(1, 9))
    wav = wav * (0.6 + 0.4 * torch.sin(2 * np.pi * 3.0 * t)) \
        + 0.05 * torch.randn(n, generator=noise, **f64)
    wav = wav * (a["rms"] / torch.sqrt(torch.mean(wav ** 2)))
    return wav.float().cpu().numpy()


def total_frames(cfg: Dict, r: Dict) -> int:
    """F5-TTS's frame count of request ``r``."""
    from promptttspp_tpu_torch.models.f5tts import duration

    return duration(reference_frames(cfg, len(r["prompt"])),
                    len(r["prompt"]), len(r["phones"]))


def shapes(cfg: Dict, reqs: Sequence[Dict]):
    """The (group size, frame bucket) of each decode graph a batch runs:
    its requests sorted by frame count, in the Synthesizer's groups of
    ``F5_DECODE_GROUP``."""
    from promptttspp_tpu_torch.infer import F5_DECODE_GROUP as size

    q = cfg["synthesizer"]["frame_quantum"]
    frames = sorted(total_frames(cfg, r) for r in reqs)
    return [(len(g), max(q, -(-g[-1] // q) * q))
            for g in (frames[j:j + size] for j in range(0, len(frames),
                                                        size))]


class Server:
    """The ``Synthesizer`` of ``run``'s F5-TTS configuration, on
    ``run.device``, with the interface of ``closed_batches``'s servers."""

    def __init__(self, run):
        from promptttspp_tpu_torch import flagship
        from promptttspp_tpu_torch.infer import Synthesizer
        from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform

        cfg = self.cfg = run.config
        if run.device == "cuda":
            set_float32(cfg["precision"]["float32"])
        model_cfg = dict(cfg["model"], dtype=cfg["precision"]["dit"])
        mel = cfg["model"]["mel_spec"]
        model = flagship.build_f5tts(model_cfg, run.device, seed=0)
        vocoder = flagship.build_vocos(run.device, seed=1,
                                       cfg=cfg["vocoder"])
        self.fill(model, vocoder, run.seed)
        to_mel = MelSpectrogramTransform(
            sample_rate=mel["target_sample_rate"], n_fft=mel["n_fft"],
            win_length=mel["win_length"], hop_length=mel["hop_length"],
            f_min=0.0, f_max=mel["target_sample_rate"] / 2.0,
            n_mels=mel["n_mel_channels"], mel_scale="htk", norm=None)
        self.synth = Synthesizer(model, vocoder, to_mel=to_mel,
                                 device=run.device, **cfg["synthesizer"])
        self.sample_rate = cfg["sample_rate"]
        self.upsample = cfg["synthesizer"]["upsample"]
        self.device = run.device
        self.wavs = {}  # (seed, transcript length) -> reference waveform

    def fill(self, model, vocoder, seed: int):
        """The benchmark's weights of ``seed``, in place (the DiT's rounded
        to its dtype)."""
        weights.fill(model, weights.sub_seed(seed, "model"))
        weights.fill(vocoder, weights.sub_seed(seed, "vocoder"))

    def reseed(self, seed: int):
        self.fill(self.synth.model, self.synth.vocoder, seed)

    def wav(self, r: Dict) -> np.ndarray:
        """Request ``r``'s reference waveform, made once."""
        key = (r["seed"], len(r["prompt"]))
        if key not in self.wavs:
            self.wavs[key] = reference_wav(self.cfg, len(r["prompt"]),
                                           r["seed"], self.device)
        return self.wavs[key]

    def dispatch(self, reqs: Sequence[Dict]):
        """Queue one batch (``synthesize_async``); -> its handle."""
        return self.synth.synthesize_async(
            [r["phones"] for r in reqs],
            reference_wavs=[self.wav(r) for r in reqs],
            reference_texts=[r["prompt"] for r in reqs],
            seed=[r["seed"] for r in reqs], return_mels=True)

    def warm(self, batches: Sequence[Sequence[Dict]]):
        """Make every request's reference waveform; then run to its end
        each batch of ``batches`` that decodes a group shape no batch
        before it did: every decode graph is captured, cuBLAS's and
        cuDNN's plans made."""
        for reqs in batches:
            for r in reqs:
                self.wav(r)
        seen = set()
        for reqs in batches:
            new = set(shapes(self.cfg, reqs)) - seen
            if new:
                seen |= new
                self.dispatch(reqs).result()

    def close(self):
        self.synth = None
