"""The DiffNet residual blocks' elementwise work in a decode: three kernels
around each block's two float32 library products.

A ``models/diffusion.py::ResidualBlock`` is a dilated convolution (cuDNN),
a gate, a 1x1 output projection (cuBLAS) and the residual and skip sums.
Eager PyTorch ran the work between the products as about nine passes a
block over float32 [B, T, R..2R] tensors, several of them strided, because
the convolution works on [B, C, T] and the model's tensors are [B, T, C]
(the convolution input's layout copy, cuDNN's caller's bias add, the
conditioner add, sigmoid, tanh and their product, the projection's bias
add, the residual add and scale, the skip add, the next block's step add).
``csrc/diffnet_block.cu`` folds them into three passes, each reading its
inputs once and writing its outputs once in the layout their next reader
takes:

- ``entry`` (G0): the input projection's output h -> x = relu(h) and the
  first block's convolution input x + dp0 as [B, R, T];
- ``gate`` (G1): the convolution's output c [B, 2R, T] (its bias apart or
  included), the bias and the hoisted conditioner projection [B, T, 2R]
  (float32 or ``infer_io_dtype``'s bf16) -> z = sigmoid(gate) * tanh(filter)
  [B, T, R], frame-major in memory as eager PyTorch lays it out;
- ``residual`` (G2): the projection's output o [B, T, 2R] without its bias,
  the bias, x and the skip sum -> x = (x + residual) / sqrt(2) and skip sum
  + skip, both in place, and the next block's convolution input x + dp as
  [B, R, T].

No JAX ``pallas_call`` has them: XLA fuses this glue itself. They are bound
by bytes: at [16, 1024] and R = 256 the three move about 200 MB a block
against the eager passes' ~485 MB.

Each kernel does the float32 operations torch's own kernels do, in torch's
order and rounding, so a decode gives the same bits through them as
through ``ResidualBlock.forward``. ``gate`` writes z in the eager z's
layout, so the output projection is the same cuBLAS call on the same
operands (a channel-last z made cuBLAS pick another kernel, 34% slower in
the offline decode on the H100).

Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch expression it replaces for a CPU tensor; a dtype or layout it does
not take raises on either. ``gate.launches``, ``entry.launches`` and
``residual.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.ops.kernels import _build

SQRT2 = math.sqrt(2.0)  # ResidualBlock's residual divisor
# torch's CUDA division by a Python float: a multiply by its float32
# reciprocal, computed in float32
_INV_SQRT2 = float(np.float32(1.0) / np.float32(SQRT2))
_COND_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("diffnet_block")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.diffnet_entry.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.diffnet_gate.argtypes = ([ptr] * 3 + [i32, i64, ptr] + [i32] * 3
                                 + [ptr])
    lib.diffnet_residual.argtypes = ([ptr] * 4 + [i32] + [ptr] * 2
                                     + [ctypes.c_float] + [i32] * 3 + [ptr])
    for fn in (lib.diffnet_entry, lib.diffnet_gate, lib.diffnet_residual):
        fn.restype = ctypes.c_int
    return lib


def _float32(name, *tensors):
    for t in tensors:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def entry_plain(h, dp):
    x = torch.relu(h)
    return x, (x + dp[:, None, :]).transpose(1, 2).contiguous()


def entry(h: torch.Tensor, dp: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B, T, R] (the input projection's output), dp [B, R] (block 0's
    diffusion projection) -> (x = relu(h) [B, T, R], x + dp as [B, R, T]
    contiguous)."""
    _float32("entry", h, dp)
    if h.device.type == "cpu":
        return entry_plain(h, dp)
    B, T, R = h.shape
    _build.check(h, "h", (B, T, R), h.device)
    _build.check(dp, "dp", (B, R), h.device)
    x = torch.empty_like(h)
    u = torch.empty((B, R, T), device=h.device)
    _build.launch(_lib().diffnet_entry, h.device, h.data_ptr(),
                  dp.data_ptr(), x.data_ptr(), u.data_ptr(), B, T, R)
    entry.launches += 1
    return x, u


def gate_plain(c, bias, cond_proj):
    if bias is not None:
        c = c + bias[:, None]
    gate_, filt = (c.transpose(1, 2) + cond_proj).chunk(2, dim=-1)
    return torch.sigmoid(gate_) * torch.tanh(filt)


def gate(c: torch.Tensor, bias: Optional[torch.Tensor],
         cond_proj: torch.Tensor) -> torch.Tensor:
    """c [B, 2R, T] (the dilated convolution's output; ``bias`` None when
    it holds the bias already), bias [2R], cond_proj [B, T, 2R] (float32
    or bf16; its rows contiguous, any batch stride) -> the gated
    activation z [B, T, R], a view of [B, R, T] memory."""
    _float32("gate", c, bias)
    if cond_proj.dtype not in _COND_DTYPES:
        raise TypeError(f"gate takes a float32 or bfloat16 cond_proj, got "
                        f"{cond_proj.dtype}")
    if c.device.type == "cpu":
        return gate_plain(c, bias, cond_proj)
    B, R2, T = c.shape
    R = R2 // 2
    _build.check(c, "c", (B, 2 * R, T), c.device)
    if bias is not None:
        _build.check(bias, "bias", (2 * R,), c.device)
    if cond_proj.device != c.device:
        raise ValueError(f"cond_proj is on {cond_proj.device}, expected "
                         f"{c.device}")
    if tuple(cond_proj.shape) != (B, T, 2 * R):
        raise ValueError(f"cond_proj has shape {tuple(cond_proj.shape)}, "
                         f"expected {(B, T, 2 * R)}")
    if cond_proj.stride(2) != 1 or (T > 1 and cond_proj.stride(1) != 2 * R):
        raise ValueError("cond_proj's rows are not contiguous")
    z = torch.empty((B, R, T), device=c.device)
    _build.launch(_lib().diffnet_gate, c.device, c.data_ptr(), _ptr(bias),
                  cond_proj.data_ptr(), int(cond_proj.dtype == torch.bfloat16),
                  cond_proj.stride(0), z.data_ptr(), B, T, R)
    gate.launches += 1
    return z.transpose(1, 2)


def residual_plain(o, bias, x, skip, dp):
    res, s = (o + bias).chunk(2, dim=-1)
    x = (x + res) / SQRT2
    skip = (0.0 if skip is None else skip) + s
    u = None if dp is None else \
        (x + dp[:, None, :]).transpose(1, 2).contiguous()
    return x, skip, u


def residual(o: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
             skip: Optional[torch.Tensor], dp: Optional[torch.Tensor]):
    """o [B, T, 2R] (the output projection without its bias), bias [2R],
    x [B, T, R], skip [B, T, R] (the skip sum; None before the first
    block), dp [B, R] (the next block's diffusion projection; None after
    the last) -> (x, skip, u): x = (x + residual) / sqrt(2), the skip sum
    with this block's skip added, and the next block's convolution input
    x + dp as [B, R, T] contiguous (None without dp). On the card x and
    skip are updated in place."""
    _float32("residual", o, bias, x, skip, dp)
    if o.device.type == "cpu":
        return residual_plain(o, bias, x, skip, dp)
    B, T, R2 = o.shape
    R = R2 // 2
    dev = o.device
    _build.check(o, "o", (B, T, 2 * R), dev)
    _build.check(bias, "bias", (2 * R,), dev)
    _build.check(x, "x", (B, T, R), dev)
    first = skip is None
    if first:
        skip = torch.empty_like(x)
    else:
        _build.check(skip, "skip", (B, T, R), dev)
    u = None
    if dp is not None:
        _build.check(dp, "dp", (B, R), dev)
        u = torch.empty((B, R, T), device=dev)
    _build.launch(_lib().diffnet_residual, dev, o.data_ptr(),
                  bias.data_ptr(), x.data_ptr(), skip.data_ptr(), int(first),
                  _ptr(dp), _ptr(u), _INV_SQRT2, B, T, R)
    residual.launches += 1
    return x, skip, u


entry.launches = 0
gate.launches = 0
residual.launches = 0
