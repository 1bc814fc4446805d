"""Kernel K2: one BigVGAN AMPLayer, ``y = x + conv2(AA2(conv1(AA1(x))))``.

Replaces ``promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer`` (one-layer
``fused_amp_block``, Pallas body ``_kernel``). AA is the anti-aliased Snake
of kernel K1; conv1 is a k-tap SAME conv with dilation d, conv2 a k-tap
SAME conv; both C x C with bias.

The CUDA source ``csrc/amp_layer.cu`` has one kernel, ``aa_conv``, launched
twice per layer:

    h = conv1(AA1(x))          (residual: none)
    y = x + conv2(AA2(h))      (residual: x)

Each block stages a time tile plus the conv's halo, computes AA there in
shared memory, and accumulates the C_out channel mix from shared memory
with weights read from device memory (L2-resident: at most 2.9 MB per conv,
C=256, k=11). The split meets the edge rules without masks: AA clamps its
input to [0, T) (edge replication, which for the second launch is exactly
"conv1's output replicated before AA2"), and the conv reads zeros outside
[0, T).

What bounds it: the channel mix, 4*k*C^2 flops per time step and layer
(~2.6e11 flops per 640-frame request over the 36 layers) against ~1 GB of
x/y traffic, so on an H100 in float32 it is bound by operations. This first
version computes in float32 on the CUDA cores (no tensor cores) for both
``conv_precision`` settings, which meets the tolerances of both; bf16
``wgmma`` is later work.

``amp_layer`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version only for a tensor on the CPU. Its launch count goes up by
one per kernel launch, two per layer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from promptttspp_tpu_torch.nn.layers import conv1d_same
from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.ops.kernels.snake import antialias_snake_plain


def amp_layer_plain(x, alpha1, w1, b1, alpha2, w2, b2, dilation: int):
    """Plain PyTorch version. w* are torch conv weights [C, C, k]."""
    h = conv1d_same(antialias_snake_plain(x, alpha1), w1, b1, dilation)
    h = conv1d_same(antialias_snake_plain(h, alpha2), w2, b2, 1)
    return x + h


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("amp_layer")
    fn = lib.amp_aa_conv
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _aa_conv(x, alpha, w, b, residual, dilation):
    B, T, C = x.shape
    k = w.shape[-1]
    _build.check(alpha, "alpha", (C,), x.device)
    _build.check(w, "w", (C, C, k), x.device)
    _build.check(b, "b", (C,), x.device)
    # kernel layout [k, C_in, C_out]: one tap's weights for a run of output
    # channels are contiguous
    w_k = w.permute(2, 1, 0).contiguous()
    y = torch.empty_like(x)
    _build.launch(_lib().amp_aa_conv, x.device, x.data_ptr(),
                  alpha.data_ptr(), w_k.data_ptr(), b.data_ptr(),
                  0 if residual is None else residual.data_ptr(),
                  y.data_ptr(), B, T, C, k, dilation)
    amp_layer.launches += 1
    return y


def amp_layer(x, alpha1, w1, b1, alpha2, w2, b2, dilation: int):
    """x [B, T, C] float32; alpha* [C]; w* torch conv weights [C, C, k]
    (odd k); b* [C] -> [B, T, C]. On CUDA, C must be a multiple of 4."""
    if x.device.type == "cpu":
        return amp_layer_plain(x, alpha1, w1, b1, alpha2, w2, b2, dilation)
    B, T, C = x.shape
    _build.check(x, "x", (B, T, C), x.device)
    if C % 4 or w1.shape[-1] % 2 == 0:
        raise ValueError(f"amp_layer kernel needs C % 4 == 0 and odd k, "
                         f"got C={C}, k={w1.shape[-1]}")
    h = _aa_conv(x, alpha1, w1, b1, None, dilation)
    return _aa_conv(h, alpha2, w2, b2, x, 1)


amp_layer.launches = 0
