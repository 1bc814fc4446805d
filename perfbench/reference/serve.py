"""The reference's side of a serving check: the same requests, in the same
batches, through the frozen plain model (``ptts/``) as the port's
two-phase path computes them (padding, the duration pre-pass and its frame
bucket, the style and diffusion draws from the request's seed, the F0
post-processing, the mel denormalisation, the vocoder), in blocks of one
batch. It reads nothing the program made: the weights come from the same
seed (``perfbench/harness/weights.py``), the inputs from the traffic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.harness import weights
from perfbench.reference.ptts import build, precision
from perfbench.reference.ptts.ops.filters import lowpass_filter

MIX_TYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": "float8_e4m3fn",
             "float32": None}


def _ceil(n: int, q: int) -> int:
    return max(q, int(math.ceil(n / q)) * q)


def mix_type(name):
    if name == "float8_e4m3fn":
        return torch.float8_e4m3fn
    return MIX_TYPES[name]


class Reference:
    """The plain model and vocoder of ``cfg`` with the weights of
    ``seed``, on ``device``."""

    def __init__(self, cfg: Dict, seed: int, device: str):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build.build_model(cfg["model"], device)
        weights.fill(self.model, weights.sub_seed(seed, "model"),
                     cfg["pins"])
        self.vocoder = build.build_vocoder(cfg["vocoder"], device)
        weights.fill(self.vocoder, weights.sub_seed(seed, "vocoder"))

    def _inputs(self, reqs: Sequence[Dict]):
        s = self.cfg["synthesizer"]
        B = len(reqs)
        tp = _ceil(max(len(r["phones"]) for r in reqs), s["phone_quantum"])
        phoneme = np.zeros((B, tp), np.int64)
        L = _ceil(max(len(r["prompt"]) for r in reqs), 16)
        ids = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), np.int64)
        for i, r in enumerate(reqs):
            phoneme[i, : len(r["phones"])] = r["phones"]
            ids[i, : len(r["prompt"])] = r["prompt"]
            mask[i, : len(r["prompt"])] = 1
        plens = [len(r["phones"]) for r in reqs]
        return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                     for a in (phoneme, plens, ids, mask))

    def _generator(self, seed: int):
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def batch(self, reqs: Sequence[Dict]) -> Dict[str, List[np.ndarray]]:
        """-> {"mels": [[T_i, 80]], "wavs": [[T_i * upsample]]}."""
        s, opt = self.cfg["synthesizer"], self.cfg["synthesize"]
        stats = self.cfg["mel_stats"]
        seed = reqs[0]["seed"]
        phoneme, plens, ids, mask = self._inputs(reqs)
        frames = self.model.infer_frame_lengths(
            phoneme, plens, ids, mask, None, None, use_max=opt["use_max"],
            noise_scale=0.0, style_generator=self._generator(seed))
        max_frames = min(_ceil(int(frames.max()), s["frame_quantum"]),
                         s["max_frames_cap"])
        cond, flens, fmask, log_cf0, vuv, _ = self.model.infer_cond(
            phoneme, plens, max_frames, ids, mask, None, None,
            use_max=opt["use_max"], noise_scale=opt["noise_scale"],
            style_generator=self._generator(seed))
        mel = self.model.decoder.inference(
            cond, None, False, self._generator(seed + 1))
        mel = mel * fmask[:, :, None].to(mel.dtype)
        lcf0 = lowpass_filter(log_cf0[..., 0], fs=100, cutoff=20)
        f0 = torch.where(vuv[..., 0] > 0.5, torch.exp(lcf0),
                         torch.zeros_like(lcf0))[..., None]
        mel = mel * stats["std"] + stats["mean"]
        wav = self.vocoder(mel, f0, deterministic=True)
        flens = flens.cpu().numpy()
        mel, wav = mel.cpu().numpy(), wav.cpu().numpy()
        up = s["upsample"]
        return {"mels": [mel[i, : int(n)] for i, n in enumerate(flens)],
                "wavs": [wav[i, : int(n) * up, 0]
                         for i, n in enumerate(flens)]}


def outputs(cfg: Dict, seed: int, batches: Sequence[Sequence[Dict]],
            device: str, float32: str = "ieee", mix="bfloat16"):
    """The reference's outputs of ``batches``, one dict per batch, computed
    in ``float32`` ("ieee"; "tf32" for the control) with the vocoder's mix
    in ``mix`` ("bfloat16"; "float32" as the port's plain layer on a CPU
    tensor; "float8_e4m3fn" for the control)."""
    ref = Reference(cfg, seed, device)
    with precision.use(float32, mix_type(mix)):
        out = [ref.batch(reqs) for reqs in batches]
    del ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return out
