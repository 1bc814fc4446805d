"""Build the sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built with nvcc) or
``csrc/<name>.cpp`` (host code, ``HOST_LIBRARIES``: the feature loader,
built with the host C++ compiler) exposes a plain C interface and becomes
its own shared library ``build/torch_kernels/<name>-<hash>.so`` under the
repository root (``.gitignore`` lists ``build/``). The hash covers the
compiler flags, the source and, for CUDA, every header in ``csrc/``, so an
edited source is rebuilt and an unchanged one is reused within and across
runs. ``build()`` starts one compiler per missing library, all at once,
and waits for all of them; a failed build raises with the compiler's
output.

Nothing is compiled when a module is imported: the first launch of a kernel
(or an explicit ``build()``) compiles it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("antialias_snake", "amp_layer_tc", "amp_layer_wgmma",
           "amp_block", "diffnet_block")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_LIBRARIES = ("featloader",)
# no -march=native: the library may run on another host than the one that
# built it
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def host_compiler() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (c++ or g++ on PATH)")


def _flags_and_sources(name: str):
    if name in HOST_LIBRARIES:
        return HOST_FLAGS, [CSRC / f"{name}.cpp"]
    return NVCC_FLAGS, [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    flags, sources = _flags_and_sources(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named library that is not built yet, one compiler
    each, all started together. Returns name -> the compiler's output
    (for a kernel, nvcc's ``-Xptxas -v`` report: registers, shared memory,
    spills) for the libraries built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        flags, sources = _flags_and_sources(name)
        compiler = host_compiler() if name in HOST_LIBRARIES \
            else nvcc_path()
        cmd = [compiler, *flags, "-o", str(tmp), str(sources[0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{Path(proc.args[0]).name} failed for {name}:\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def check(t: torch.Tensor, name: str, shape, device: torch.device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` — what every kernel in ``csrc/`` takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(fn, device: torch.device, *args) -> None:
    """Call a C launcher on ``device``'s current stream; raise on a
    non-zero ``cudaGetLastError()`` code it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
