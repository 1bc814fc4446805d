"""A frozen copy of the port's plain PyTorch modules, the benchmark's
reference: the model (``models/``, ``nn/``, ``ops/``), the vocoder with its
kernels K1 and K2 replaced by their plain versions (``vocoders/``), the
training data path (``data/``) and the training step (``train/``), built
from a configuration by ``build.py``. It imports nothing of the port, and
the port's later changes do not reach it: it is the yardstick they are
held to. ``precision.py`` sets the precision it computes in (float32 and
the port's bf16 vocoder mix; TF32 and fp8 for the control).
"""
