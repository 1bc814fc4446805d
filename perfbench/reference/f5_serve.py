"""The reference's side of an F5-TTS serving check: each request of the
checked batches alone and unpadded through the frozen plain F5-TTS and
Vocos (``f5tts/f5tts_plain.py``), from the same reference waveform, ids
and seed, with the benchmark's weights of the run's seed, in float32 with
TF32 off. It reads nothing the program made; padding that leaks into a
request of a batch shows as a gap.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from perfbench.harness import weights
from perfbench.harness.f5_serving import reference_wav
from perfbench.reference.f5tts import f5tts_plain as plain


def outputs(cfg: Dict, seed: int, batches: Sequence[Sequence[Dict]],
            device: str, dit_dtype: str = "float32"):
    """Per batch {"mels": [generated [T_i, mel]], "wavs": [T_i x hop]}; the
    DiT in ``dit_dtype`` ("bfloat16" for the control), its weights the
    float32 ones rounded."""
    arch, smp = cfg["model"]["arch"], cfg["model"]["sampler"]
    model = plain.F5TTS(mel_dim=cfg["model"]["mel_spec"]["n_mel_channels"],
                        **arch).to(device)
    vocoder = plain.Vocos(**cfg["vocoder"]).to(device)
    weights.fill(model, weights.sub_seed(seed, "model"))
    weights.fill(vocoder, weights.sub_seed(seed, "vocoder"))
    model.dit.to(getattr(torch, dit_dtype))
    out = []
    for reqs in batches:
        mels, wavs = [], []
        for r in reqs:
            wav = torch.as_tensor(reference_wav(cfg, len(r["prompt"]),
                                                r["seed"], device),
                                  device=device)
            mel, audio = plain.synthesize(
                model, vocoder, plain.log_mel(wav), r["prompt"],
                r["phones"], r["seed"], nfe=smp["nfe_step"],
                cfg_strength=smp["cfg_strength"],
                sway_coef=smp["sway_sampling_coef"])
            mels.append(mel.cpu().numpy())
            wavs.append(audio.cpu().numpy())
        out.append({"mels": mels, "wavs": wavs})
    del model, vocoder
    if device == "cuda":
        torch.cuda.empty_cache()
    return out
