"""Fingerprints of kernel K2-bf16's output bits at a few AMPLayer shapes,
on one GPU, to hold a change of K2-bf16 (``csrc/amp_layer_wgmma.cu``, and
before it ``csrc/amp_layer_tc.cu``) to the kernel's earlier output bit for
bit. From the root of a checkout:

    PYTHONPATH=. python3 path/to/promptttspp_tpu_torch/tools/k2_bits.py

prints one SHA-256 prefix of the [B, T, C] float32 output per case in
``CASES`` for the ``promptttspp_tpu_torch`` found first on the path, so the
same file fingerprints an older checkout's kernel too. The inputs are drawn
with numpy from fixed seeds, so every machine makes the same ones; the
conv weights have gain 1 at most, as in ``chip_smoke.py``.

``EARLIER`` holds the fingerprints that the K2-bf16 kernel of commit
ae756b5 (before ``amp_layer_tc.cu`` took the float32 K2 as a second mix)
gave on an NVIDIA H100 80GB HBM3; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` compare against them.
"""

from __future__ import annotations

import hashlib
import math
import sys

import numpy as np
import torch

# (B, T, C, k, d): each flagship width with a flagship (k, d), a ragged
# batch, and a T inside one AA run at the smallest C the kernel takes
CASES = ((1, 400, 32, 11, 5), (1, 200, 64, 7, 3), (1, 150, 128, 3, 1),
         (1, 100, 256, 11, 5), (2, 77, 12, 7, 1), (1, 9, 4, 3, 1))
EARLIER = {
    (1, 400, 32, 11, 5): "998c9b0b6ef88758",
    (1, 200, 64, 7, 3): "034ab99238ec3b4f",
    (1, 150, 128, 3, 1): "68c30b4833ac8fb1",
    (1, 100, 256, 11, 5): "a17786bba72cd7e3",
    (2, 77, 12, 7, 1): "4d0790d3106e67c6",
    (1, 9, 4, 3, 1): "58a8c175a96bd144",
}


def inputs(case, device):
    """The amp_layer arguments of ``case`` on ``device``."""
    B, T, C, k, d = case
    rng = np.random.RandomState(sum(case))
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    f = lambda scale, *s: torch.from_numpy(
        (scale * rng.randn(*s)).astype(np.float32)).to(device)
    return (f(0.3, B, T, C), f(0.2, C), f(ws, C, C, k), f(0.1, C),
            f(0.2, C), f(ws, C, C, k), f(0.1, C), d)


def fingerprint(y: torch.Tensor) -> str:
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]


def fingerprints(k2, device) -> dict:
    """case -> fingerprint of ``k2.amp_layer(..., bf16=True)``."""
    return {case: fingerprint(k2.amp_layer(*inputs(case, device), bf16=True))
            for case in CASES}


def main() -> int:
    from promptttspp_tpu_torch.ops.kernels import amp as k2

    if not torch.cuda.is_available():
        print("k2_bits: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"# {k2.__file__}")
    for case, fp in fingerprints(k2, torch.device("cuda", 0)).items():
        print(f"    {case}: \"{fp}\",")
    return 0


if __name__ == "__main__":
    sys.exit(main())
