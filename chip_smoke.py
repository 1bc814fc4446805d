#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PromptTTS++ once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the hand-written kernels from ``promptttspp_tpu_torch/csrc/`` with
   nvcc (one process per source, all at once) and print each kernel's
   registers and shared memory (``-Xptxas -v``).
2. Hold kernel K1 (``antialias_snake``) against its plain PyTorch version at
   the ``act_post`` shape [1, 153600, 32] and at C=256.
3. Hold kernel K2 (``amp_layer``) against its plain version at every
   AMPLayer shape of a 640-frame request: each upsample stage's (C, T) and
   every (kernel size, dilation).
4. Build the flagship model and vocoder at full width from seeds (duration
   head biased to 10 frames per phone) and run 3 two-phase requests of 64
   phones and a 32-token prompt (640 frames, 6.4 s of audio each) through
   ``Synthesizer.synthesize``. The kernels' launch counts are set to 0
   just before and read just after. Then one deterministic request (fixed
   x_T, zero diffusion noise, deterministic NSF source, noise_scale 0) is
   run with the kernels and again with every kernel replaced by its plain
   version, and the waveforms are compared.
5. Print request wall time and real-time factor, the kernels' times from
   CUDA events beside their bounds and their plain versions' times, a
   device-time profile of one request, and the ``kernels`` JSON line.

float32 throughout: TF32 is switched off for cuDNN convolutions and cuBLAS
matrix products, so the plain versions are full float32 references.
Exits non-zero without a GPU, or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3 rate
# and float32 on the CUDA cores (the kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# flops per output element of the anti-aliased snake: two 2x-rate values
# each of 6 taps (12) + the x2 scale (1) + snake (u*a, 7-fma sin^2 with its
# range reduction ~18, scale and add: ~21), then the 12-tap downsample (24)
AA_FLOPS = 2 * (13 + 21) + 24

K1_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_snake.py:34
K2_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_pallas_amp.py:51
# kernel vs plain wav of a whole request: float32 with another summation
# order in each of 36 AMPLayers and the final activation; tanh-bounded
WAV_ATOL = 1e-3

PHONES, PROMPT_LEN, FRAMES, N_REQUESTS, N_TIMED = 64, 32, 640, 3, 7


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_cost(B, T, C):
    return (2 * B * T * C + C) * 4, B * T * C * AA_FLOPS


def k2_cost(B, T, C, k):
    """One AMPLayer: x read and y written once, both convs' weights and
    the four per-channel vectors; two AA passes and two k-tap C x C convs
    with bias, plus the residual add."""
    nbytes = (2 * B * T * C + 2 * k * C * C + 4 * C) * 4
    flops = 2 * B * T * C * AA_FLOPS + 2 * (2 * k * C + 1) * B * T * C \
        + B * T * C
    return nbytes, flops


def stage_shapes(voc_cfg, frames):
    """(C, T) of each upsample stage's AMPLayers for ``frames`` mel frames."""
    shapes, T = [], frames
    for i, u in enumerate(voc_cfg["upsample_rates"]):
        T *= u
        shapes.append((voc_cfg["upsample_initial_channel"] // 2 ** (i + 1),
                       T))
    return shapes


class FixedTokenizer:
    """Seeded stand-in for the WordPiece tokenizer: [CLS] + random
    bert-base ids + [SEP], ``L`` tokens, the same ids on every call (the
    model sees ids either way)."""

    pad_id = 0

    def __init__(self, L, seed=0):
        self.L, self.seed = L, seed

    def batch_encode(self, prompts):
        import numpy as np

        ids = np.random.RandomState(self.seed).randint(
            1000, 29000, (len(prompts), self.L))
        ids[:, 0], ids[:, -1] = 101, 102
        return ids.astype(np.int64), np.ones_like(ids)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from promptttspp_tpu_torch import flagship
        from promptttspp_tpu_torch.infer import Synthesizer
        from promptttspp_tpu_torch.ops.kernels import _build
        from promptttspp_tpu_torch.ops.kernels import amp as k2
        from promptttspp_tpu_torch.ops.kernels import snake as k1
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    t_start = time.perf_counter()
    failures = []
    print(f"[{gpu}] torch {torch.__version__} CUDA {torch.version.cuda}; "
          "TF32 off for cuDNN and cuBLAS (float32 references)", flush=True)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    # -- phase 2: K1 against its plain version ------------------------------
    k1_err, k1_row = 0.0, None
    for shape in [(1, FRAMES * 240, 32), (1, FRAMES * 6, 256)]:
        x, alpha = randn(*shape), 0.3 * randn(shape[-1])
        y = k1.antialias_snake(x, alpha)
        ref = k1.antialias_snake_plain(x, alpha)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        k1_err = max(k1_err, err)
        ok = torch.allclose(y, ref, **K1_TOL)
        if not ok:
            failures.append(f"K1 {shape}: max abs err {err:.3g}")
        ms = cuda_ms(lambda: k1.antialias_snake(x, alpha), iters=20)
        plain = cuda_ms(lambda: k1.antialias_snake_plain(x, alpha), iters=5)
        bms, by = bound_ms(*k1_cost(*shape))
        print(f"[{gpu}] phase 2: K1 antialias_snake {list(shape)} "
              f"max_abs_err {err:.3g} ({'ok' if ok else 'FAIL'}); kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)
        if k1_row is None:  # the act_post shape of the main path
            k1_row = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          shape=list(shape))

    # -- phase 3: K2 against its plain version ------------------------------
    voc_cfg = flagship.VOCODER
    k2_err, k2_ms, k2_plain, k2_bound, k2_flops = 0.0, 0.0, 0.0, 0.0, 0.0
    for C, T in stage_shapes(voc_cfg, FRAMES):
        st_ms = st_plain = st_bound = 0.0
        for k, dils in zip(voc_cfg["resblock_kernel_sizes"],
                           voc_cfg["resblock_dilations"]):
            for d in dils:
                args_ = (0.3 * randn(1, T, C), 0.2 * randn(C),
                         0.05 * randn(C, C, k), 0.1 * randn(C),
                         0.2 * randn(C), 0.05 * randn(C, C, k),
                         0.1 * randn(C), d)
                y = k2.amp_layer(*args_)
                ref = k2.amp_layer_plain(*args_)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                k2_err = max(k2_err, err)
                if not torch.allclose(y, ref, **K2_TOL):
                    failures.append(f"K2 C={C} T={T} k={k} d={d}: max abs "
                                    f"err {err:.3g}")
                ms = cuda_ms(lambda: k2.amp_layer(*args_), iters=5)
                plain = cuda_ms(lambda: k2.amp_layer_plain(*args_), iters=3)
                nbytes, flops = k2_cost(1, T, C, k)
                bms, _ = bound_ms(nbytes, flops)
                st_ms, st_plain, st_bound = (st_ms + ms, st_plain + plain,
                                             st_bound + bms)
                k2_flops += flops
                print(f"  K2 C={C} T={T} k={k} d={d}: err {err:.3g} "
                      f"kernel {ms:.4f} ms plain {plain:.4f} ms bound "
                      f"{bms:.4f} ms", flush=True)
        k2_ms, k2_plain, k2_bound = (k2_ms + st_ms, k2_plain + st_plain,
                                     k2_bound + st_bound)
        print(f"[{gpu}] phase 3: K2 amp_layer stage C={C} T={T} (9 layers): "
              f"kernel {st_ms:.3f} ms, plain {st_plain:.3f} ms, bound "
              f"{st_bound:.3f} ms", flush=True)
    print(f"[{gpu}] phase 3: K2 amp_layer, 36 layers of a {FRAMES}-frame "
          f"request: kernel {k2_ms:.3f} ms "
          f"({k2_flops / (k2_ms * 1e-3) / 1e12:.2f} TFLOP/s fp32), plain "
          f"{k2_plain:.3f} ms, bound {k2_bound:.3f} ms (operations), max "
          f"abs err {k2_err:.3g}", flush=True)
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1

    # -- phase 4: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = flagship.build_flagship_model(dev, seed=0, frames_per_phone=10.0)
    vocoder = flagship.build_vocoder(dev, seed=1)
    torch.cuda.synchronize()
    print(f"phase 4: flagship model "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params) and vocoder "
          f"({sum(p.numel() for p in vocoder.parameters()) / 1e6:.1f} M) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    synth = Synthesizer(model, vocoder, tokenizer=FixedTokenizer(PROMPT_LEN),
                        device=dev)
    rng = np.random.RandomState(3)
    seqs = [list(rng.randint(1, 90, PHONES))]
    prompts = ["a deep calm male voice speaking slowly"]
    samples = FRAMES * 240
    audio_s = samples / flagship.VOCODER["sampling_rate"]

    k1.antialias_snake.launches = 0
    k2.amp_layer.launches = 0
    walls = []
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        wavs, mels = synth.synthesize(seqs, prompts, use_max=True,
                                      noise_scale=0.0, seed=i)
        walls.append(time.perf_counter() - t0)
        w = wavs[0]
        if w.shape != (samples,) or not np.isfinite(w).all():
            failures.append(f"request {i}: wav shape {w.shape}, finite "
                            f"{bool(np.isfinite(w).all())}")
    launches = {"antialias_snake": k1.antialias_snake.launches,
                "amp_layer": k2.amp_layer.launches}
    expect = {"antialias_snake": N_REQUESTS, "amp_layer": 72 * N_REQUESTS}
    print(f"phase 4: {N_REQUESTS} requests, launches {launches} "
          f"(expected {expect})", flush=True)
    if launches != expect:
        failures.append(f"launch counts {launches} != {expect}")

    x_T = torch.randn((1, FRAMES, 80), generator=g, device=dev)
    det = dict(use_max=True, noise_scale=0.0, seed=7, x_T=x_T,
               zero_noise=True)
    wav_k, mel_k = synth.synthesize(seqs, prompts, **det)
    before = {"antialias_snake": k1.antialias_snake.launches,
              "amp_layer": k2.amp_layer.launches}
    with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
            mock.patch.object(k1, "antialias_snake",
                              k1.antialias_snake_plain):
        wav_p, mel_p = synth.synthesize(seqs, prompts, **det)
    if {"antialias_snake": k1.antialias_snake.launches,
            "amp_layer": k2.amp_layer.launches} != before:
        failures.append("a kernel launched while its plain version was "
                        "patched in")
    wav_err = float(np.abs(wav_k[0] - wav_p[0]).max())
    mel_err = float(np.abs(mel_k[0] - mel_p[0]).max())
    print(f"[{gpu}] phase 4: deterministic request, kernels vs plain "
          f"versions: wav max abs err {wav_err:.3g} (tol {WAV_ATOL}), mel "
          f"max abs err {mel_err:.3g}; wav rms "
          f"{np.sqrt(np.mean(wav_k[0] ** 2)):.4f}", flush=True)
    if not (wav_err <= WAV_ATOL and np.isfinite(wav_k[0]).all()):
        failures.append(f"deterministic wav: kernels vs plain {wav_err:.3g}")
    synth.return_int16 = True
    pcm, _ = synth.synthesize(seqs, prompts, **det)
    synth.return_int16 = False
    want = np.clip(np.round(wav_k[0] * 32767.0), -32768, 32767)
    if pcm[0].dtype != np.int16 or np.abs(pcm[0] - want).max() > 1:
        failures.append("PCM16 output disagrees with the float wav")

    # -- phase 5: timings ----------------------------------------------------
    for i, wall in enumerate(walls):
        print(f"[{gpu}] request {i}: wall {wall * 1e3:.1f} ms for "
              f"{audio_s:.1f} s of audio, RTF {wall / audio_s:.5f}")
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        synth.synthesize(seqs, prompts, use_max=True, noise_scale=0.0)
        walls.append(time.perf_counter() - t0)
    steady = float(np.median(walls[N_REQUESTS:]))
    print(f"[{gpu}] steady request: median of {N_TIMED} more requests "
          f"{steady * 1e3:.1f} ms (min {min(walls) * 1e3:.1f}, max "
          f"{max(walls[N_REQUESTS:]) * 1e3:.1f}), RTF {steady / audio_s:.5f}",
          flush=True)
    profile_request(synth, seqs, prompts, gpu, steady)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    kernels = [
        dict(name="antialias_snake", route="cuda",
             source="promptttspp_tpu_torch/csrc/antialias_snake.cu",
             replaces="promptttspp_tpu/ops/pallas/snake.py:248",
             launches=launches["antialias_snake"], max_abs_err=k1_err,
             ms=k1_row["ms"], plain_ms=k1_row["plain_ms"],
             bound_ms=k1_row["bound_ms"], bound_by=k1_row["bound_by"],
             library_ms=None, shape=k1_row["shape"]),
        dict(name="amp_layer", route="cuda",
             source="promptttspp_tpu_torch/csrc/amp_layer.cu",
             replaces="promptttspp_tpu/ops/pallas/amp.py:332",
             launches=launches["amp_layer"], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain, bound_ms=k2_bound, bound_by="operations",
             library_ms=None,
             per=f"sum over the 36 AMPLayers of one {FRAMES}-frame request "
                 "(72 launches)"),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_request(synth, seqs, prompts, gpu, wall_s):
    """Device time by kernel over one request (torch.profiler); the table
    goes to build/chip_smoke/profile_request.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synth.synthesize(seqs, prompts, use_max=True, noise_scale=0.0,
                         seed=0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    # kernels only: an aten op's device time repeats its kernels' time
    rows = sorted(((dev_us(e), e.count, e.key) for e in events
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    total_us = sum(r[0] for r in rows)
    if total_us == 0:
        print(f"[{gpu}] profile: no device time recorded (not measured)")
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lines = [f"{us / 1e3:10.3f} ms {n:7d}x  {key}" for us, n, key in rows]
    (OUT_DIR / "profile_request.txt").write_text(
        f"{gpu}\none two-phase 640-frame request; device ms, calls, name\n"
        + "\n".join(lines) + "\n")
    print(f"[{gpu}] profile of one request: device busy "
          f"{total_us / 1e3:.1f} ms (sum of kernel times) of "
          f"{wall_s * 1e3:.1f} ms wall; top kernels:")
    for line in lines[:12]:
        print("   " + line)


if __name__ == "__main__":
    sys.exit(main())
