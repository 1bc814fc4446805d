"""Whole-module parameter re-initialization (ESPnet's ``initialize``).

Counterpart of ``promptttspp_tpu/nn/initialization.py``: every parameter
of more than one dim is drawn anew from a family (``xavier_uniform``,
``xavier_normal``, ``kaiming_uniform``, ``kaiming_normal``, the kaiming
ones with ReLU's gain), every other parameter is set to 0; ``pytorch``
leaves the module as it is. ``lecun_normal_init`` draws N(0, 1/fan_in)
weights and zero biases.

The fans are JAX's, counted on the tensor as JAX stores it: a ``Linear``
or convolution weight is transposed there (torch's [out, in, *k] is
JAX's [*k, in, out]), which gives torch's own fans; every other tensor
(an embedding table, the relative attention's biases, a GRU's weights)
is stored as it is here, and JAX counts ``shape[-2]`` (times the leading
dims) as its fan-in and ``shape[-1]`` as its fan-out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

FAMILIES = ("xavier_uniform", "xavier_normal", "kaiming_uniform",
            "kaiming_normal")
_TRANSPOSED = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def fans(module: nn.Module, name: str, p: torch.Tensor):
    """(fan_in, fan_out) of parameter ``name`` of ``module`` as JAX counts
    them (see the module docstring)."""
    if name == "weight" and isinstance(module, nn.modules.conv
                                       ._ConvTransposeNd):
        # torch [in, out, *k] is JAX's [*k, in, out]
        rec = math.prod(p.shape[2:])
        return p.shape[0] * rec, p.shape[1] * rec
    if name == "weight" and isinstance(module, _TRANSPOSED):
        rec = math.prod(p.shape[2:])
        return p.shape[1] * rec, p.shape[0] * rec
    rec = math.prod(p.shape[:-2])
    return p.shape[-2] * rec, p.shape[-1] * rec


def _draw(p, fan_in, fan_out, init_type, generator):
    if init_type == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return p.uniform_(-a, a, generator=generator)
    if init_type == "xavier_normal":
        return p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                         generator=generator)
    if init_type == "kaiming_uniform":
        a = math.sqrt(6.0 / fan_in)
        return p.uniform_(-a, a, generator=generator)
    if init_type == "kaiming_normal":
        return p.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    raise ValueError(f"Unknown initialization: {init_type}")


@torch.no_grad()
def initialize(module: nn.Module, init_type: str,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw ``module``'s parameters in place from ``init_type`` (one of
    ``FAMILIES``, or ``pytorch``: unchanged) with ``generator``; returns
    ``module``."""
    if init_type == "pytorch":
        return module
    if init_type not in FAMILIES:
        raise ValueError(f"Unknown initialization: {init_type}")
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim <= 1:
                p.zero_()
            else:
                _draw(p, *fans(mod, name, p), init_type, generator)
    return module


@torch.no_grad()
def lecun_normal_init(module: nn.Module,
                      generator: Optional[torch.Generator] = None
                      ) -> nn.Module:
    """Zero biases, weights N(0, 1/fan_in) with JAX's fans; in place."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim <= 1:
                p.zero_()
            else:
                p.normal_(0.0, fans(mod, name, p)[0] ** -0.5,
                          generator=generator)
    return module
