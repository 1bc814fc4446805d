"""The precisions the reference computes in.

``FLOAT32`` is what ``models/diffusion.py::float32_math`` sets for the
convolutions, recurrent layers and matrix products of the decode and the
training step: "ieee" (float32), or "tf32" for the control, which also
sets the process-wide flags (``use``). ``MIX`` is the type the vocoder's
AMPLayer channel mix rounds its two operands to: ``torch.bfloat16`` (the
port's K2-bf16 arithmetic), None (float32, as the port's plain layer on a
CPU tensor), or ``torch.float8_e4m3fn`` for the control.
"""

from __future__ import annotations

import contextlib

import torch

FLOAT32 = {"value": "ieee"}
MIX = {"value": torch.bfloat16}


def _flags():
    return (torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
            torch.backends.cuda.matmul)


@contextlib.contextmanager
def use(float32: str = "ieee", mix=torch.bfloat16):
    """Compute in ``float32`` ("ieee" or "tf32") everywhere, the vocoder's
    mix in ``mix``, for the duration of the block."""
    saved = (FLOAT32["value"], MIX["value"],
             [f.fp32_precision for f in _flags()])
    FLOAT32["value"], MIX["value"] = float32, mix
    for f in _flags():
        f.fp32_precision = float32
    try:
        yield
    finally:
        FLOAT32["value"], MIX["value"] = saved[0], saved[1]
        for f, value in zip(_flags(), saved[2]):
            f.fp32_precision = value
