"""ctypes binding of the C++ feature-batch loader (``csrc/featloader.cpp``).

Counterpart of ``promptttspp_tpu/data/native_loader.py``. The library is
the port's own copy of the JAX package's loader, built from
``csrc/featloader.cpp`` with the host C++ compiler at first use
(``ops/kernels/_build.py``) into ``build/torch_kernels/featloader-<hash>.so``.
Nothing falls back: where the library cannot be built, or a call fails,
``load_feature_batch`` raises with the compiler's or the loader's message.
ctypes releases the interpreter lock for the call, so the loader's threads
run beside Python's.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Optional

import numpy as np

from promptttspp_tpu_torch.ops.kernels import _build

_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built loader, with its C signatures declared (built now if it
    is not yet)."""
    lib = _build.load("featloader")
    lib.ffl_load_batch.restype = ctypes.c_int
    lib.ffl_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, _F32P, _F32P, _F32P,
        _F32P, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int,
    ]
    return lib


def _paths_array(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def _buffer(out: Optional[Dict[str, np.ndarray]], key: str, shape, dtype):
    """``out[key]`` after checking it, or a new zeroed array."""
    if out is None or key not in out:
        return np.zeros(shape, dtype)
    a = out[key]
    if a.shape != tuple(shape) or a.dtype != dtype or \
            not a.flags["C_CONTIGUOUS"] or not a.flags["WRITEABLE"]:
        raise ValueError(f"out[{key!r}]: {a.shape} {a.dtype}, expected a "
                         f"writable C-contiguous {tuple(shape)} {dtype}")
    return a


def load_feature_batch(
    mel_paths: List[str],
    cf0_paths: List[str],
    vuv_paths: List[str],
    t_frames: int,
    mel_mean: float,
    mel_std: float,
    n_mels: int = 80,
    n_threads: Optional[int] = None,
    out: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """-> dict(mel [B, Tf, n_mels], log_cf0 / vuv / energy [B, Tf, 1]
    float32, frame_lengths [B] int32): the mel normalized by
    (mel_mean, mel_std), the energy from the raw mel, everything zero-padded
    to ``t_frames``. ``out`` may hold caller-owned arrays for any of these
    keys (e.g. numpy views of pinned tensors), which are filled in place."""
    lib = library()
    n = len(mel_paths)
    mel = _buffer(out, "mel", (n, t_frames, n_mels), np.float32)
    cf0 = _buffer(out, "log_cf0", (n, t_frames, 1), np.float32)
    vuv = _buffer(out, "vuv", (n, t_frames, 1), np.float32)
    energy = _buffer(out, "energy", (n, t_frames, 1), np.float32)
    flens = _buffer(out, "frame_lengths", (n,), np.int32)
    errbuf = ctypes.create_string_buffer(512)

    def fptr(a):
        return a.ctypes.data_as(_F32P)

    rc = lib.ffl_load_batch(
        _paths_array(mel_paths), _paths_array(cf0_paths),
        _paths_array(vuv_paths), n, t_frames, n_mels,
        ctypes.c_float(mel_mean), ctypes.c_float(mel_std),
        fptr(mel), fptr(cf0), fptr(vuv), fptr(energy),
        flens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads or (os.cpu_count() or 1), errbuf, 512)
    if rc != 0:
        raise RuntimeError(f"feature loader failed: {errbuf.value.decode()}")
    return dict(mel=mel, log_cf0=cf0, vuv=vuv, energy=energy,
                frame_lengths=flens)

