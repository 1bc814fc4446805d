"""Operations, bytes and roofline bounds of the port's vocoder kernels, at
a call's shape (frozen from the port's ``chip_smoke.py``, where PRs 1-17
checked them against the kernels' timings): each input byte read once and
each output byte written once; AA (the anti-aliased Snake) ``AA_FLOPS``
per output element.
"""

from __future__ import annotations

from perfbench.costs.peaks import (BF16_TC_FLOP_PER_S, FP32_FLOP_PER_S,
                                   HBM_BYTES_PER_S, TF32_TC_FLOP_PER_S)

# flops per output element of the anti-aliased snake: two 2x-rate values
# each of 6 taps (12) + the x2 scale (1) + snake (u*a, 7-fma sin^2 with its
# range reduction ~18, scale and add: ~21), then the 12-tap downsample (24)
AA_FLOPS = 2 * (13 + 21) + 24


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_cost(B, T, C):
    """K1 (the anti-aliased Snake): (bytes, flops)."""
    return (2 * B * T * C + C) * 4, B * T * C * AA_FLOPS


def k2_cost(B, T, C, k):
    """One AMPLayer: x read and y written once, both convs' weights and
    the four per-channel vectors; two AA passes and two k-tap C x C convs
    with bias, plus the residual add."""
    nbytes = (2 * B * T * C + 2 * k * C * C + 4 * C) * 4
    flops = 2 * B * T * C * AA_FLOPS + 2 * (2 * k * C + 1) * B * T * C \
        + B * T * C
    return nbytes, flops


def k2_bf16_bound(B, T, C, k):
    """One AMPLayer with the channel mix in bf16: x read and y written once
    in float32, both convs' weights in bf16 and the four per-channel
    vectors; the two convs' mix at the bf16 tensor-core peak, AA, bias and
    the residual add at the float32 peak. Returns the three times in
    seconds (bytes, mix, float32)."""
    nbytes = (2 * B * T * C + 4 * C) * 4 + 2 * k * C * C * 2
    mix = 2 * 2 * k * C * C * B * T
    fp32 = 2 * B * T * C * AA_FLOPS + 3 * B * T * C
    return (nbytes / HBM_BYTES_PER_S, mix / BF16_TC_FLOP_PER_S,
            fp32 / FP32_FLOP_PER_S)


def k2_f32_tc_bound(B, T, C, k):
    """One AMPLayer with the channel mix as 3xTF32: x read and y written
    once, both convs' weights in float32 and the four per-channel vectors;
    three passes of the two convs' mix at the TF32 tensor-core peak, AA,
    bias and the residual add at the float32 peak. Returns the three times
    in seconds (bytes, mix, float32)."""
    nbytes = k2_cost(B, T, C, k)[0]
    mix = 3 * 2 * 2 * k * C * C * B * T
    fp32 = 2 * B * T * C * AA_FLOPS + 3 * B * T * C
    return (nbytes / HBM_BYTES_PER_S, mix / TF32_TC_FLOP_PER_S,
            fp32 / FP32_FLOP_PER_S)


def k3_bound(B, T, C, k, n_layers, bf16):
    """A whole AMPBlock in one precision: x read and y written once in
    float32, every layer's two conv weights (bf16 or float32) and four
    per-channel vectors; the layers' mixes at the tensor-core peak of the
    precision (three TF32 passes for float32), AA, bias and the residual
    add at the float32 peak. Returns the three times in seconds (bytes,
    mix, float32)."""
    nbytes = 2 * B * T * C * 4 + n_layers * (
        2 * k * C * C * (2 if bf16 else 4) + 4 * C * 4)
    mix = n_layers * 2 * 2 * k * C * C * B * T
    t_mix = mix / BF16_TC_FLOP_PER_S if bf16 else \
        3 * mix / TF32_TC_FLOP_PER_S
    fp32 = n_layers * (2 * B * T * C * AA_FLOPS + 3 * B * T * C)
    return nbytes / HBM_BYTES_PER_S, t_mix, fp32 / FP32_FLOP_PER_S


def stage_shapes(voc_cfg, frames):
    """(C, T) of each upsample stage's AMPLayers for ``frames`` mel
    frames."""
    shapes, T = [], frames
    for i, u in enumerate(voc_cfg["upsample_rates"]):
        T *= u
        shapes.append((voc_cfg["upsample_initial_channel"] // 2 ** (i + 1),
                       T))
    return shapes


def vocoder_k2_bf16_bound_s(voc_cfg, B, frames) -> float:
    """The least time the K2-bf16 launches of one batched vocoder call
    ([B, frames] mel) can take: every AMPLayer's largest of its three
    times, summed."""
    total = 0.0
    for C, T in stage_shapes(voc_cfg, frames):
        for k, dils in zip(voc_cfg["resblock_kernel_sizes"],
                           voc_cfg["resblock_dilations"]):
            total += len(dils) * max(k2_bf16_bound(B, T, C, k))
    return total


def vocoder_k2_launches(voc_cfg) -> int:
    """K2 launches of one batched vocoder call: two per AMPLayer."""
    layers = sum(len(d) for d in voc_cfg["resblock_dilations"])
    return 2 * layers * len(voc_cfg["upsample_rates"])
