"""Analytic FLOPs of F5-TTS with Vocos, from the configuration's
``model`` and ``vocoder`` and a request's unpadded lengths: 2 per
multiply-add of every matrix product and convolution, attention's scores
and values included; elementwise work (norms, modulations, RoPE, the
Euler update) not counted.

A request of ``T`` frames (the reference's and the generated ones) runs
``2 x nfe_step`` DiT passes over its T frames (the guided pair of each
step), the text embedding twice (with and without the text), and Vocos
over its ``G`` generated frames.
"""

from __future__ import annotations

from typing import Dict


def dit_pass(model: Dict, T: int) -> int:
    """One DiT pass over ``T`` frames."""
    a = model["arch"]
    d, depth, inner = a["dim"], a["depth"], a["heads"] * a["dim_head"]
    mel = model["mel_spec"]["n_mel_channels"]
    block = 2 * T * (3 * d * inner + inner * d + 2 * d * a["ff_mult"] * d)
    block += 4 * T * T * inner  # scores and values
    block += 2 * d * 6 * d  # the modulations, once per row
    embed = 2 * T * (2 * mel + a["text_dim"]) * d \
        + 2 * 2 * T * d * (d // 16) * 31  # the grouped position convs
    out = 2 * T * d * mel + 2 * d * 2 * d
    time = 2 * (256 * d + d * d)
    return depth * block + embed + out + time


def text_embed(model: Dict, T: int) -> int:
    a = model["arch"]
    c = a["text_dim"]
    return a["conv_layers"] * 2 * T * (c * 7 + 2 * c * 2 * c)


def dit(model: Dict, T: int) -> int:
    """The whole sampler of a request of ``T`` frames."""
    return 2 * model["sampler"]["nfe_step"] * dit_pass(model, T) \
        + 2 * text_embed(model, T)


def vocos(voc: Dict, G: int) -> int:
    """Vocos over ``G`` frames (the inverse FFT not counted)."""
    d, h = voc["dim"], voc["intermediate_dim"]
    per_layer = 2 * G * (d * 7 + 2 * d * h)
    return 2 * G * voc["n_mels"] * d * 7 + voc["num_layers"] * per_layer \
        + 2 * G * d * (voc["n_fft"] + 2)


def attention(model: Dict, B: int, T: int) -> int:
    """The attention FLOPs of one decode at batch ``B`` and frame bucket
    ``T``: 4 B' H T^2 d over every block of every step, B' = 2 B."""
    a = model["arch"]
    return 4 * 2 * B * a["heads"] * T * T * a["dim_head"] * a["depth"] \
        * model["sampler"]["nfe_step"]
