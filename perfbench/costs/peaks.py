"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): HBM3 bytes per second, float32 on the CUDA cores, dense bf16
and TF32 on the tensor cores. A card set below 700 W runs under them; the
benchmark states shares against these peaks."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 494.7e12
