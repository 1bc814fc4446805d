"""PyTorch/CUDA port of promptttspp_tpu for NVIDIA Hopper GPUs.

The JAX package ``promptttspp_tpu`` is the reference; this package mirrors
its layout (``vocoders/``, ``models/``, ``nn/``, ``ops/``, ``ops/kernels/``
for the counterparts of ``ops/pallas/``, ``compat/``, ``text/``,
``infer.py``, ``flagship.py``) and keeps the JAX package's channel-last
``[B, T, C]`` layout at its public functions. It imports ``torch`` and
never JAX or anything of ``promptttspp_tpu``.

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` on
first use (``ops/kernels/_build.py``). Each kernel wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version only for a
tensor on the CPU.
"""
