"""How far bf16 rounding of the AMPLayers' channel mix moves the flagship
vocoder's waveform, from the plain versions alone:

    python3 -m promptttspp_tpu_torch.tools.bf16_wav_deviation \
        [--frames 24] [--device cuda]

The full-width F0-aware BigVGAN (random weights, seed 1) vocodes a random
mel at a constant 150 Hz F0 (deterministic source) three times, every
AMPLayer running a plain version: float32; bf16 channel-mix operands with
AA in float32 (K2-bf16's plain version); and the same with AA computed in
float64 before the rounding, which now and then rounds AA's output to the
neighbouring bf16 value, as a kernel that sums AA in another order does.
Prints the max abs wav difference of bf16 against float32 and of the two
bf16 forms against each other.
"""

from __future__ import annotations

import argparse
import sys
from unittest import mock

import numpy as np
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.nn.layers import conv1d_same
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.ops.kernels.snake import antialias_snake_plain


def layer_plain(aa_dtype, bf16):
    """An ``amp_layer`` stand-in: AA in ``aa_dtype``, the mix's operands
    rounded to bf16 if ``bf16``, whatever the caller asks."""
    def mix(t):
        return t.to(torch.bfloat16).float() if bf16 else t

    def aa(h, alpha):
        return antialias_snake_plain(h.to(aa_dtype),
                                     alpha.to(aa_dtype)).float()

    def amp_layer(x, alpha1, w1, b1, alpha2, w2, b2, dilation, bf16=None):
        h = conv1d_same(mix(aa(x, alpha1)), mix(w1), b1, dilation)
        h = conv1d_same(mix(aa(h, alpha2)), mix(w2), b2, 1)
        return x + h
    return amp_layer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    vocoder = flagship.build_vocoder(args.device, seed=1)
    dev = next(vocoder.parameters()).device
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    mel = torch.randn((1, args.frames, 80), generator=g, device=dev)
    f0 = torch.full((1, args.frames, 1), 150.0, device=dev)
    wavs = {}
    with torch.no_grad():
        for name, fn in (("f32", layer_plain(torch.float32, False)),
                         ("bf16", layer_plain(torch.float32, True)),
                         ("bf16_aa64", layer_plain(torch.float64, True))):
            with mock.patch.object(k2, "amp_layer", fn):
                wavs[name] = vocoder(mel, f0, deterministic=True)[
                    0, :, 0].cpu().numpy()
    dev_f32 = float(np.abs(wavs["bf16"] - wavs["f32"]).max())
    flips = float(np.abs(wavs["bf16"] - wavs["bf16_aa64"]).max())
    print(f"{args.frames} frames on {dev}: wav rms "
          f"{np.sqrt(np.mean(wavs['f32'] ** 2)):.4f}; bf16 vs float32 max "
          f"abs {dev_f32:.3g}; AA float64 vs float32 before the bf16 "
          f"rounding max abs {flips:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
