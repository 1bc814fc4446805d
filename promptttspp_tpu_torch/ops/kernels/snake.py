"""Kernel K1: the anti-aliased Snake, ``y = down2(snake(up2(x)))``.

Replaces ``promptttspp_tpu/ops/pallas/snake.py::fused_antialias_snake`` (both
of its Pallas bodies, ``_kernel`` and the lane-packed ``_kernel_packed``)
with one CUDA kernel, ``csrc/antialias_snake.cu``, for any channel count.

What bounds it: it reads x once and writes y once and does ~90 flops per
output element, so on an H100 it is memory-bound (at ``act_post``,
[1, 153600, 32] float32: 39 MB moved against ~0.45 GFLOP). The design keeps
the 2x-rate intermediate out of device memory: each block stages its x tile
plus a 6-sample halo in shared memory, computes the 2x-rate snake values
there, and writes only y.

``antialias_snake`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.vocoders.activations import (
    downsample2, snake, upsample2)


def antialias_snake_plain(x, alpha):
    """Plain PyTorch version: the unfused up2 -> snake -> down2."""
    return downsample2(snake(upsample2(x), alpha))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("antialias_snake")
    fn = lib.antialias_snake
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def antialias_snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] float32, alpha [C] (log-scale) -> [B, T, C]."""
    if x.device.type == "cpu":
        return antialias_snake_plain(x, alpha)
    B, T, C = x.shape
    _build.check(x, "x", (B, T, C), x.device)
    _build.check(alpha, "alpha", (C,), x.device)
    y = torch.empty_like(x)
    _build.launch(_lib().antialias_snake, x.device, x.data_ptr(),
                  alpha.data_ptr(), y.data_ptr(), B, T, C)
    antialias_snake.launches += 1
    return y


antialias_snake.launches = 0
