#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PromptTTS++ once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the hand-written kernels from ``promptttspp_tpu_torch/csrc/`` with
   nvcc (one process per source, all at once, beside the ``mix_only``
   build of K2-bf16 that phase 3 times) and print each kernel's registers
   and shared memory (``-Xptxas -v``), the counts of bf16 and of TF32
   tensor-core MMA instructions (HMMA) in the ``mma.sync`` K2's SASS and
   of HGMMA (``wgmma``) in K2-bf16's (``cuobjdump -sass``; none of any
   fails).
2. Hold kernel K1 (``antialias_snake``) against its plain PyTorch version at
   the ``act_post`` shape [1, 153600, 32], at C=256 and at four small,
   ragged shapes; print its bandwidth and its share of the bound.
3. Hold both precisions of kernel K2 (``amp_layer``) against their plain
   versions at every AMPLayer shape of a 640-frame request (each upsample
   stage's (C, T) and every (kernel size, dilation)): K2-bf16 (the
   ``wgmma`` kernel, bf16 channel mix, the serving path's) against the
   bf16 plain version and against the float32 one at the JAX package's
   bf16 tolerance, and bit for bit against the earlier ``mma.sync``
   K2-bf16, with which it is timed in alternated turns, beside its mix
   alone and two bf16 cuDNN convolutions of the layer's shapes (a
   yardstick the port never calls); the float32 K2 (3xTF32 on the tensor
   cores) against the float32 plain version; per-stage times, and both
   beside their bounds (the float32 K2 beside both of its: TF32 tensor
   cores, float32 CUDA cores). K2-bf16's output bits must equal those of
   its earlier kernel (``promptttspp_tpu_torch/tools/k2_bits.py``).
4. Build the flagship model and vocoder at full width from seeds (duration
   head biased to 10 frames per phone) and run 3 two-phase requests of 64
   phones and a 32-token prompt (640 frames, 6.4 s of audio each) through
   ``Synthesizer.synthesize``. The kernels' launch counts are set to 0
   just before and read just after: the vocoder's default
   ``conv_precision`` launches K2-bf16 only. Then one deterministic request
   (fixed x_T, zero diffusion noise, deterministic NSF source, noise_scale
   0) is run with the kernels and again with every kernel replaced by its
   plain version of the same precision, and the waveforms are compared;
   the same request with the vocoder at ``conv_precision="highest"``
   launches only the float32 K2 (72 launches), is held against its float32
   plain versions and gives the bf16 wav's deviation from float32. With
   ``return_int16`` the batched request returns PCM16 and a chunked one
   float32, as in JAX.
5. Print request wall time and real-time factor and a device-time profile
   of one request (its decode replayed as a CUDA graph), and one of the
   same request with the vocoder at ``conv_precision="highest"``.
6. Hold kernel K3 (``amp_block``, a whole AMPBlock in one launch) against
   its plain version at the 12 AMPBlock shapes of a 640-frame request, and
   time it beside three float32 ``amp_layer`` calls (3xTF32, equal to it
   within the float32 tolerance), three K2-bf16 calls (what the serving
   path makes for the same block) and its bound. The serving path does not
   call K3.
7. Serving paths, each driven with the launch counts set to 0 just before
   and read just after: speculative requests (bucket predicted at 10
   frames per phone, no mispredict); a forced mispredict (5 frames per
   phone: one re-dispatch, the two-phase wav); a request's input staging
   (every host -> device copy) behind a spin kernel, which must still run
   when the staging returns; three ``synthesize_async`` requests, the third
   conditioned on a reference wav, queued before the first is resolved (the
   dispatch makes no synchronizing CUDA call, each result equals its
   ``synthesize`` result);
   ``synthesize_streaming`` with chunk 256 and halo 16, with and without a
   64-frame first chunk (time to first chunk, launches per chunk, the
   stitched stream against the batched wav in the interior);
   ``vocoder_mode="chunked"`` against batched; and a request conditioned on
   a 3 s, 24 kHz reference wav.
8. Decode graphs (``models/decode_graph.py``): ``Synthesizer.prewarm(grid=
   "speculative", max_phones=64, streaming=True)`` and its rows; every
   captured graph's capture time and memory, the largest frame bucket's
   (2048) included; requests with the decode as
   graphs against the same requests with the eager decode, bit for bit
   (noise from the generator, and x_T with zero noise); eager and graph
   two-phase requests in alternated turns (wall, RTF); a profile of an
   eager request beside phase 5's graph request (device time, device-busy
   share, host-issued launches); a PLMS-10 request (``pndm_speedup=10``,
   graph against eager bit for bit) and a request with bf16 decode
   storage (``infer_io_dtype`` and ``decode_param_dtype``), each timed and
   profiled; the decode alone per graph replay for each, and with TF32 on
   (which the port does not use) for comparison.
9. Real-checkpoint serving through the port's own entry point, at full
   flagship width with the demo model (legacy relative positions) and the
   flagship vocoder: reference-format checkpoints written from seeded
   modules (the model as ``{epoch, model, optimizer}``, the vocoder as
   ``{generator}`` with its convolutions split into ``weight_g`` /
   ``weight_v``), a synthetic eval corpus (2 utterances of 64 phones, a
   30,522-line stand-in vocabulary, ``stats.yaml``, 3 s reference wavs),
   then the synthesize CLI's ``main`` in-process: the loaded parameters
   against the saved ones (bit for bit where unfolded), its eval tree, 4
   requests with K1 once and K2-bf16 72 times each, a prompt request of its
   synthesizer against the in-memory one on the original modules, the load
   and first-request times, and the demo model's steady wall beside the
   flagship's in alternated turns. The files are deleted at the end.
10. Training on the card (``promptttspp_tpu_torch/train/``), about a
    minute: (a) one train step of the flagship at full width (dropout rates
    0, the diffusion steps and noise given, 2 short utterances) from the
    same weights on the card and on the CPU, the losses and grad_norm
    within 1e-4 / 1e-3 and every parameter and BatchNorm statistic after
    the update within 1e-5;
    (b) the train CLI's ``main`` in-process (``bin/train.py``, the
    flagship, ``dataset.max_tokens=10000``, one epoch of at least 20
    updates) on a synthetic training corpus written under
    ``build/chip_smoke/train/`` by ``tools/synthetic_corpus.py``: the
    median update time after 3 warm-up updates (CUDA events between update
    starts, no synchronization added), frames/s, the peak of
    ``torch.cuda.max_memory_allocated``, the device-busy share of 3
    profiled updates (``train.profile_steps``), the first and last losses,
    every loss finite; (c) its ``ckpt/last`` served by the synthesize
    CLI's ``main`` for one utterance (a prompt and a reference request),
    K1 once and K2-bf16 72 times per request. The files are deleted at the
    end.
11. Print the ``kernels`` JSON line, the GPU line and the result line.

TF32 is switched off for cuDNN convolutions and cuBLAS matrix products, so
the plain versions are full float32 references; the bf16 plain version
rounds only the channel mix's operands to bf16. Kernel times are CUDA-event
means over launches queued behind a spin kernel, so the host's launch cost
(the wrappers' Python) stays out of them; a kernel timing in which the
device caught up with the host is taken again behind a longer spin, and
fails the run if it still is.
Exits non-zero without a GPU, or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3 rate,
# float32 on the CUDA cores, dense bf16 (K2-bf16's channel mix) and dense
# TF32 (the float32 K2's, three passes) on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 494.7e12
# flops per output element of the anti-aliased snake: two 2x-rate values
# each of 6 taps (12) + the x2 scale (1) + snake (u*a, 7-fma sin^2 with its
# range reduction ~18, scale and add: ~21), then the 12-tap downsample (24)
AA_FLOPS = 2 * (13 + 21) + 24

K1_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_snake.py:34
K2_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_pallas_amp.py:51
# K2-bf16 against the bf16 plain version: both round AA's output to bf16,
# but AA computed in another order can round to the neighbouring bf16 value
# (one 2^-8 relative step); such flips in A, and in AA2 after them, moved
# the output by at most 2.4e-3 at the 36 shapes of phase 3 (H100)
K2_BF16_TOL = dict(atol=1e-2, rtol=1e-3)
K2_BF16_F32_TOL = dict(atol=3e-2, rtol=1e-2)  # tests/test_pallas_amp.py:70
# kernel vs plain wav of a whole request: float32 with another summation
# order in each of 36 AMPLayers and the final activation; tanh-bounded
WAV_ATOL = 1e-3
# the same with K2-bf16: the A flips above, propagated through the later
# layers (2.0e-3 for 24 frames of the flagship vocoder on the CPU,
# promptttspp_tpu_torch/tools/bf16_wav_deviation.py)
WAV_BF16_ATOL = 1e-2
# streamed or chunked wav against the batched one, away from the edges
# (tests/test_infer.py:334-370)
STREAM_ATOL = 5e-3
CHUNK, HALO, FIRST_CHUNK = 256, 16, 64
N_TURNS = 4  # alternated runs of each of two serving variants
N_ALT = 5  # alternated eager-decode and graph-decode requests, each
PLMS_SPEEDUP = 10
# a spin kernel queued before a request's inputs are staged: 1e9 clock
# cycles, about 0.5 s at the H100's 1.98 GHz, far longer than the staging
SPIN_CYCLES = 1_000_000_000
# the spin kernel a kernel timing queues its launches behind: 2e7 cycles,
# about 10 ms, longer than the host takes to launch them
TIMING_SPIN_CYCLES = 20_000_000

PHONES, PROMPT_LEN, FRAMES, N_REQUESTS, N_TIMED = 64, 32, 640, 3, 7
# phase 10: the training corpus (utterances, phones and frames per phone
# [lo, hi)); one epoch at max_tokens 10000 then takes about 25 updates
TRAIN_UTTS, TRAIN_PHONES, TRAIN_FPP, MAX_TOKENS = 720, (20, 80), (3, 12), \
    10000
TRAIN_WARMUP, PROFILE_STEP, MIN_STEPS = 3, 8, 20
# phase 10 (a): the losses and grad_norm on the card against the CPU, and
# the parameters after the update (cuDNN sums in another order)
TRAIN_LOSS_TOL = dict(atol=1e-4, rtol=1e-3)
TRAIN_PARAM_ATOL = 1e-5


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5, warmup: int = 1,
            kernel: bool = True) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel, so the device runs them back to back and
    the host's launch cost stays out. A ``kernel`` timing in which the
    device reached the first call before the host had queued the last is
    taken again behind a spin 4 times longer, up to three times; then it
    raises. The plain versions (``kernel=False``) copy their FIR taps from
    host memory, which waits for the device: their times include the
    host's gaps."""
    import torch

    for _ in range(warmup):
        fn()
    spin = TIMING_SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if not (kernel and caught_up):
            return start.elapsed_time(end) / iters
        spin *= 4
    raise RuntimeError(f"cuda_ms: the device caught up with the host "
                       f"behind a spin of {spin // 4} cycles")


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


def k2_bf16_bound(B, T, C, k):
    """One AMPLayer with the channel mix in bf16: x read and y written once
    in float32, both convs' weights in bf16 and the four per-channel
    vectors; the two convs' mix at the bf16 tensor-core peak, AA, bias and
    the residual add at the float32 peak. Returns the three times in
    seconds (bytes, mix, float32)."""
    nbytes = (2 * B * T * C + 4 * C) * 4 + 2 * k * C * C * 2
    mix = 2 * 2 * k * C * C * B * T
    fp32 = 2 * B * T * C * AA_FLOPS + 3 * B * T * C
    return (nbytes / HBM_BYTES_PER_S, mix / BF16_TC_FLOP_PER_S,
            fp32 / FP32_FLOP_PER_S)


def k2_f32_tc_bound(B, T, C, k):
    """One AMPLayer with the channel mix as 3xTF32: x read and y written
    once, both convs' weights in float32 and the four per-channel vectors;
    three passes of the two convs' mix at the TF32 tensor-core peak, AA,
    bias and the residual add at the float32 peak. Returns the three times
    in seconds (bytes, mix, float32)."""
    nbytes = k2_cost(B, T, C, k)[0]
    mix = 3 * 2 * 2 * k * C * C * B * T
    fp32 = 2 * B * T * C * AA_FLOPS + 3 * B * T * C
    return (nbytes / HBM_BYTES_PER_S, mix / TF32_TC_FLOP_PER_S,
            fp32 / FP32_FLOP_PER_S)


def k3_cost(B, T, C, k, n_layers):
    """A whole AMPBlock: x read and y written once, every layer's two conv
    weights and four per-channel vectors; the layers' operations."""
    nbytes = (2 * B * T * C + n_layers * (2 * k * C * C + 4 * C)) * 4
    return nbytes, n_layers * k2_cost(B, T, C, k)[1]


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
        from promptttspp_tpu_torch.tools import k2_bits, k2_variants
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
    # the mix-alone build of K2-bf16 (phase 3) compiles beside the kernels
    with ThreadPoolExecutor(1) as pool:
        mix_only = pool.submit(k2_variants.build, ["mix_only"],
                               "amp_aa_conv_wgmma", "wgmma")
        reports = _build.build()
        mix_only = mix_only.result()["mix_only"]
    for name in _build.KERNELS:
        _build.load(name)
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} and "
          f"K2-bf16's mix_only variant in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    n_mma = tensor_core_mmas(_build, "amp_layer_tc")
    n_gmma = tensor_core_mmas(_build, "amp_layer_wgmma")
    print(f"phase 1: tensor-core MMA instructions in K2's SASS: "
          f"amp_layer_tc HMMA {n_mma['bf16']} bf16 (the mma.sync K2-bf16), "
          f"{n_mma['tf32']} TF32 (the float32 K2); amp_layer_wgmma HGMMA "
          f"{n_gmma['hgmma']} ({n_gmma['bf16']} bf16, K2-bf16)", flush=True)
    if not (n_mma["bf16"] and n_mma["tf32"] and n_gmma["hgmma"]):
        print(f"chip_smoke: K2's SASS lacks bf16 or TF32 HMMA or bf16 HGMMA "
              f"instructions: {n_mma}, {n_gmma}", file=sys.stderr)
        return 1

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    # -- phase 2: K1 against its plain version ------------------------------
    k1_err, k1_row = 0.0, None
    # act_post of the main path, a C=256 stage, then small and ragged shapes
    # (C below a warp or not a multiple of 32, batches, T inside one run)
    for shape in [(1, FRAMES * 240, 32), (1, FRAMES * 6, 256), (2, 300, 4),
                  (1, 1000, 12), (2, 513, 48), (2, 9, 12)]:
        x, alpha = randn(*shape), 0.3 * randn(shape[-1])
        y = k1.antialias_snake(x, alpha)
        ref = k1.antialias_snake_plain(x, alpha)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        k1_err = max(k1_err, err)
        ok = torch.allclose(y, ref, **K1_TOL)
        if not ok:
            failures.append(f"K1 {shape}: max abs err {err:.3g}")
        if shape[1] < FRAMES * 6:
            print(f"phase 2: K1 {list(shape)} max_abs_err {err:.3g} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            continue
        ms = cuda_ms(lambda: k1.antialias_snake(x, alpha), iters=50)
        plain = cuda_ms(lambda: k1.antialias_snake_plain(x, alpha), iters=5,
                        kernel=False)
        nbytes, flops = k1_cost(*shape)
        bms, by = bound_ms(nbytes, flops)
        print(f"[{gpu}] phase 2: K1 antialias_snake {list(shape)} "
              f"max_abs_err {err:.3g} ({'ok' if ok else 'FAIL'}); kernel "
              f"{ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s, "
              f"{bms / ms:.0%} of the bound), plain {plain:.4f} ms, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        if k1_row is None:  # the act_post shape of the main path
            k1_row = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          shape=list(shape))

    # -- phase 3: both K2 precisions against their plain versions ----------
    voc_cfg = flagship.VOCODER
    k2_row, k2bf_row = phase_k2(k2, k2_variants, mix_only, randn, voc_cfg,
                                gpu, failures)
    bits = k2_bits.fingerprints(k2, dev)
    same_bits = {case: fp == k2_bits.EARLIER.get(case)
                 for case, fp in bits.items()}
    print(f"phase 3: K2-bf16 output bits equal those of its earlier kernel "
          f"at {sum(same_bits.values())} of {len(bits)} shapes: "
          f"{[(c, bits[c]) for c, ok in same_bits.items() if not ok]} "
          "differ", flush=True)
    if not all(same_bits.values()):
        failures.append("K2-bf16 output bits differ from its earlier "
                        "kernel's")
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1

    # -- phase 4: the main path ---------------------------------------------
    print(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
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

    _zero_counts(k1, k2)
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
    launches = _counts(k1, k2)
    # the serving path runs an AMPBlock as three amp_layer calls, as the
    # JAX package does (K3 is not on it), at the vocoder's default
    # conv_precision: K2-bf16, not the float32 K2
    expect = {"antialias_snake": N_REQUESTS,
              "amp_layer_bf16": 72 * N_REQUESTS, "amp_layer": 0,
              "amp_block": 0}
    print(f"phase 4: {N_REQUESTS} requests, launches {launches} "
          f"(expected {expect})", flush=True)
    if launches != expect:
        failures.append(f"launch counts {launches} != {expect}")

    x_T = torch.randn((1, FRAMES, 80), generator=g, device=dev)
    det = dict(use_max=True, noise_scale=0.0, seed=7, x_T=x_T,
               zero_noise=True)
    wav_k, mel_k = synth.synthesize(seqs, prompts, **det)
    before = _counts(k1, k2)
    with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
            mock.patch.object(k1, "antialias_snake",
                              k1.antialias_snake_plain):
        wav_p, mel_p = synth.synthesize(seqs, prompts, **det)
    if _counts(k1, k2) != before:
        failures.append("a kernel launched while its plain version was "
                        "patched in")
    wav_err = float(np.abs(wav_k[0] - wav_p[0]).max())
    mel_err = float(np.abs(mel_k[0] - mel_p[0]).max())
    set_conv_precision(vocoder, "highest")
    try:
        _zero_counts(k1, k2)
        wav_f, _ = synth.synthesize(seqs, prompts, **det)
        launches_f = _counts(k1, k2)
        with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
                mock.patch.object(k1, "antialias_snake",
                                  k1.antialias_snake_plain):
            wav_fp, _ = synth.synthesize(seqs, prompts, **det)
    finally:
        set_conv_precision(vocoder, "default")
    expect_f = {"antialias_snake": 1, "amp_layer_bf16": 0, "amp_layer": 72,
                "amp_block": 0}
    print(f"phase 4: conv_precision=\"highest\" request, launches "
          f"{launches_f} (expected {expect_f})", flush=True)
    if launches_f != expect_f:
        failures.append(f"highest request: launch counts {launches_f} != "
                        f"{expect_f}")
    wav_f_err = float(np.abs(wav_f[0] - wav_fp[0]).max())
    bf16_dev = float(np.abs(wav_k[0] - wav_f[0]).max())
    print(f"[{gpu}] phase 4: deterministic request, kernels vs plain "
          f"versions: bf16 (K2-bf16) wav max abs err {wav_err:.3g} (tol "
          f"{WAV_BF16_ATOL}), float32 (K2) wav {wav_f_err:.3g} (tol "
          f"{WAV_ATOL}), mel max abs err {mel_err:.3g}; bf16 wav vs float32 "
          f"wav max abs dev {bf16_dev:.3g}; wav rms "
          f"{np.sqrt(np.mean(wav_k[0] ** 2)):.4f}", flush=True)
    if not (wav_err <= WAV_BF16_ATOL and np.isfinite(wav_k[0]).all()):
        failures.append(f"deterministic wav: kernels vs plain {wav_err:.3g}")
    if not (wav_f_err <= WAV_ATOL and np.isfinite(wav_f[0]).all()):
        failures.append(f"deterministic float32 wav: kernels vs plain "
                        f"{wav_f_err:.3g}")
    synth.return_int16 = True
    pcm, _ = synth.synthesize(seqs, prompts, **det)
    synth.return_int16 = False
    want = np.clip(np.round(wav_k[0] * 32767.0), -32768, 32767)
    if pcm[0].dtype != np.int16 or np.abs(pcm[0] - want).max() > 1:
        failures.append("PCM16 output disagrees with the float wav")
    # as in JAX, return_int16 quantizes only the batched vocoder's output
    chunked16 = Synthesizer(model, vocoder, tokenizer=synth.tokenizer,
                            device=dev, vocoder_mode="chunked",
                            chunk_frames=CHUNK, halo_frames=HALO,
                            return_int16=True)
    wav_c16, _ = chunked16.synthesize(seqs, prompts, **det)
    print(f"phase 4: return_int16: batched wav {pcm[0].dtype}, chunked wav "
          f"{wav_c16[0].dtype}", flush=True)
    if wav_c16[0].dtype != np.float32:
        failures.append(f"return_int16 chunked request gave "
                        f"{wav_c16[0].dtype}, not float32")

    # -- phase 5: timings ----------------------------------------------------
    print(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
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
    graph_profile = profile_request(synth, seqs, prompts, gpu, steady)
    set_conv_precision(vocoder, "highest")
    try:
        profile_request(synth, seqs, prompts, gpu, None, "highest")
    finally:
        set_conv_precision(vocoder, "default")

    # -- phase 6: K3 against its plain version ------------------------------
    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    k3_row = phase_k3(k2, randn, voc_cfg, gpu, failures)

    # -- phase 7: the serving paths --------------------------------------------
    print(f"phase 7 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase_serving(Synthesizer, k1, k2, model, vocoder, synth, seqs, prompts,
                  gpu, failures)

    # -- phase 8: decode graphs against the eager decode --------------------
    print(f"phase 8 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase_graphs(Synthesizer, k1, k2, model, vocoder, synth, seqs, prompts,
                 gpu, failures, graph_profile, audio_s)

    # -- phase 9: reference checkpoints through the synthesize CLI ---------
    print(f"phase 9 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase_cli(Synthesizer, k1, k2, vocoder, synth, seqs, prompts, gpu,
              failures)

    # -- phase 10: training on the card --------------------------------------
    print(f"phase 10 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    del synth
    torch.cuda.empty_cache()
    phase_train(k1, k2, vocoder, dev, gpu, failures)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    per_request = f"sum over the 36 AMPLayers of one {FRAMES}-frame request"
    kernels = [
        dict(name="antialias_snake", route="cuda",
             source="promptttspp_tpu_torch/csrc/antialias_snake.cu",
             replaces="promptttspp_tpu/ops/pallas/snake.py:248",
             launches=launches["antialias_snake"], max_abs_err=k1_err,
             ms=k1_row["ms"], plain_ms=k1_row["plain_ms"],
             bound_ms=k1_row["bound_ms"], bound_by=k1_row["bound_by"],
             library_ms=None, shape=k1_row["shape"]),
        dict(name="amp_layer_bf16", route="cuda",
             source="promptttspp_tpu_torch/csrc/amp_layer_wgmma.cu",
             replaces="promptttspp_tpu/ops/pallas/amp.py:332",
             launches=launches["amp_layer_bf16"],
             max_abs_err=k2bf_row["err"], ms=k2bf_row["ms"],
             plain_ms=k2bf_row["plain_ms"], bound_ms=k2bf_row["bound_ms"],
             bound_by=k2bf_row["bound_by"], library_ms=None,
             max_abs_dev_from_fp32_plain=k2bf_row["dev_f32"],
             mma_sync_ms=k2bf_row["mma_sync_ms"],
             max_abs_diff_from_mma_sync=k2bf_row["diff_mma_sync"],
             mix_alone_ms=k2bf_row["mix_ms"],
             cudnn_bf16_conv_ms=k2bf_row["cudnn_ms"],
             per=f"{per_request} (72 launches), mxu_bf16=True; mma_sync_ms "
                 "is the earlier K2-bf16 (amp_layer_tc.cu) in alternated "
                 "turns, cudnn_bf16_conv_ms two bf16 cuDNN convolutions per "
                 "layer (a yardstick, not the same function)"),
        dict(name="amp_layer", route="cuda",
             source="promptttspp_tpu_torch/csrc/amp_layer_tc.cu",
             replaces="promptttspp_tpu/ops/pallas/amp.py:332",
             launches=launches["amp_layer"], max_abs_err=k2_row["err"],
             ms=k2_row["ms"], plain_ms=k2_row["plain_ms"],
             bound_ms=k2_row["bound_ms"], bound_by=k2_row["bound_by"],
             library_ms=None, bound_ms_cuda_cores=k2_row["bound_cc_ms"],
             launches_highest_request=launches_f["amp_layer"],
             per=f"{per_request} (72 launches), mxu_bf16=False as 3xTF32; "
                 "serving runs it only for a conv_precision=\"highest\" "
                 "vocoder"),
        dict(name="amp_block", route="cuda",
             source="promptttspp_tpu_torch/csrc/amp_block.cu",
             replaces="promptttspp_tpu/ops/pallas/amp.py:348",
             launches=launches["amp_block"], max_abs_err=k3_row["err"],
             ms=k3_row["ms"],
             plain_ms=k3_row["plain_ms"], bound_ms=k3_row["bound_ms"],
             bound_by=k3_row["bound_by"], library_ms=None,
             amp_layer_x3_ms=k3_row["layers_ms"],
             amp_layer_bf16_x3_ms=k3_row["layers_bf16_ms"],
             per=f"sum over the 12 AMPBlocks of one {FRAMES}-frame request "
                 "(12 launches); the serving path does not call it"),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def tensor_core_mmas(_build, name):
    """Tensor-core MMA instructions (HMMA, HGMMA) in a built library's SASS,
    from the toolkit's ``cuobjdump -sass``, by operand type, and the HGMMA
    (wgmma) among them: {"bf16": n, "tf32": n, "hgmma": n}."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    mmas = [line for line in out.stdout.splitlines()
            if "HMMA" in line or "HGMMA" in line]
    counts = {t: sum(1 for line in mmas if t.upper() in line)
              for t in ("bf16", "tf32")}
    counts["hgmma"] = sum(1 for line in mmas if "HGMMA" in line)
    return counts


def set_conv_precision(vocoder, precision):
    from promptttspp_tpu_torch.vocoders.bigvgan import AMPLayer

    for m in vocoder.modules():
        if isinstance(m, AMPLayer):
            m.conv_precision = precision


def phase_k2(k2, k2_variants, mix_only, randn, voc_cfg, gpu, failures):
    """Both K2 precisions at every AMPLayer shape of a request against
    their plain versions, timed beside them and their bounds. K2-bf16 (the
    wgmma kernel) is also held bit for bit against the mma.sync K2-bf16
    and timed in alternated turns with it (wgmma, mma.sync, mma.sync,
    wgmma), beside its mix alone (``mix_only``, the launches of
    ``tools/k2_variants.py``'s mix_only build: AA skipped, no residual)
    and, as a yardstick the port never calls, two bf16 cuDNN convolutions
    of the layer's shapes. The conv weights have gain 1 at most (scale
    min(0.05, 1/sqrt(k*C)), as trained BigVGAN convs have): at scale 0.05
    a C=256, k=11 conv has gain 2.65, the layer's output reaches 11, and
    bf16 rounding leaves the JAX package's bf16 tolerance, which it checks
    at C=32, k=7 (gain 0.66)."""
    import math

    import torch
    import torch.nn.functional as F

    f32 = dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_cc_ms=0.0,
               flops=0.0, t_bytes=0.0, t_mix=0.0, t_fp32=0.0)
    bf = dict(err=0.0, dev_f32=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              t_bytes=0.0, t_mix=0.0, t_fp32=0.0, mma_sync_ms=0.0,
              mix_ms=0.0, cudnn_ms=0.0, diff_mma_sync=0.0)
    for C, T in stage_shapes(voc_cfg, FRAMES):
        st = dict(ms=0.0, plain_ms=0.0, bf_ms=0.0, bf_plain_ms=0.0,
                  bound=0.0, bound_cc=0.0, bf_bound=0.0, mma_sync=0.0,
                  mix=0.0, cudnn=0.0)
        for k, dils in zip(voc_cfg["resblock_kernel_sizes"],
                           voc_cfg["resblock_dilations"]):
            ws = min(0.05, 1.0 / math.sqrt(k * C))
            for d in dils:
                args_ = (0.3 * randn(1, T, C), 0.2 * randn(C),
                         ws * randn(C, C, k), 0.1 * randn(C),
                         0.2 * randn(C), ws * randn(C, C, k),
                         0.1 * randn(C), d)
                x, a1, w1, b1, a2, w2, b2, _ = args_
                y = k2.amp_layer(*args_)
                yb = k2.amp_layer(*args_, bf16=True)
                yo = k2.amp_layer_mma_sync(*args_)
                ref = k2.amp_layer_plain(*args_)
                refb = k2.amp_layer_plain(*args_, bf16=True)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                errb = (yb - refb).abs().max().item()
                dev = (yb - ref).abs().max().item()
                diff = (yb - yo).abs().max().item()
                f32["err"] = max(f32["err"], err)
                bf["err"] = max(bf["err"], errb)
                bf["dev_f32"] = max(bf["dev_f32"], dev)
                bf["diff_mma_sync"] = max(bf["diff_mma_sync"], diff)
                shape = f"C={C} T={T} k={k} d={d}"
                if not torch.allclose(y, ref, **K2_TOL):
                    failures.append(f"K2 {shape}: max abs err {err:.3g}")
                if not torch.allclose(yb, refb, **K2_BF16_TOL):
                    failures.append(f"K2-bf16 {shape}: max abs err "
                                    f"{errb:.3g}")
                if not torch.allclose(yb, ref, **K2_BF16_F32_TOL):
                    failures.append(f"K2-bf16 {shape} vs float32: max abs "
                                    f"dev {dev:.3g}")
                if diff != 0.0:
                    failures.append(f"K2-bf16 {shape}: differs from the "
                                    f"mma.sync kernel by {diff:.3g}")
                mix1, _ = k2_variants.wgmma_call(mix_only, "mix_only", x, a1,
                                                 w1, b1, d)
                mix2, _ = k2_variants.wgmma_call(mix_only, "mix_only", x, a2,
                                                 w2, b2, 1)
                xc = x.permute(0, 2, 1).contiguous().to(torch.bfloat16)
                wc1, wc2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
                bc1, bc2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
                pad = (k - 1) // 2
                new = lambda: k2.amp_layer(*args_, bf16=True)
                old = lambda: k2.amp_layer_mma_sync(*args_)
                msb = cuda_ms(new, iters=10)
                mso = cuda_ms(old, iters=10)
                mso = (mso + cuda_ms(old, iters=10)) / 2
                msb = (msb + cuda_ms(new, iters=10)) / 2
                msm = cuda_ms(lambda: (mix1(), mix2()), iters=10)
                msc = cuda_ms(lambda: (
                    F.conv1d(xc, wc1, bc1, padding=pad * d, dilation=d),
                    F.conv1d(xc, wc2, bc2, padding=pad)), iters=10)
                ms = cuda_ms(lambda: k2.amp_layer(*args_), iters=10)
                plain = cuda_ms(lambda: k2.amp_layer_plain(*args_), iters=3,
                                kernel=False)
                plainb = cuda_ms(
                    lambda: k2.amp_layer_plain(*args_, bf16=True), iters=3,
                    kernel=False)
                nbytes, flops = k2_cost(1, T, C, k)
                bms_cc, _ = bound_ms(nbytes, flops)
                times = k2_bf16_bound(1, T, C, k)
                times_f = k2_f32_tc_bound(1, T, C, k)
                for key, v in zip(("t_bytes", "t_mix", "t_fp32"), times):
                    bf[key] += v * 1e3
                for key, v in zip(("t_bytes", "t_mix", "t_fp32"), times_f):
                    f32[key] += v * 1e3
                bf["bound_ms"] += max(times) * 1e3
                f32["bound_ms"] += max(times_f) * 1e3
                f32["bound_cc_ms"] += bms_cc
                f32["flops"] += flops
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("bf_ms", msb), ("bf_plain_ms", plainb),
                               ("bound", max(times_f) * 1e3),
                               ("bound_cc", bms_cc),
                               ("bf_bound", max(times) * 1e3),
                               ("mma_sync", mso), ("mix", msm),
                               ("cudnn", msc)):
                    st[key] += v
                print(f"  K2 {shape}: bf16 err {errb:.3g} (vs float32 plain "
                      f"{dev:.3g}, vs mma.sync {diff:.3g}) kernel "
                      f"{msb:.4f} ms (mma.sync {mso:.4f}, mix alone "
                      f"{msm:.4f}, cuDNN bf16 convs {msc:.4f}) plain "
                      f"{plainb:.4f} ms bound {max(times) * 1e3:.4f} ms; "
                      f"float32 err {err:.3g} kernel {ms:.4f} ms plain "
                      f"{plain:.4f} ms bound {max(times_f) * 1e3:.4f} ms "
                      f"(CUDA cores {bms_cc:.4f} ms)", flush=True)
        f32["ms"] += st["ms"]
        f32["plain_ms"] += st["plain_ms"]
        bf["ms"] += st["bf_ms"]
        bf["plain_ms"] += st["bf_plain_ms"]
        bf["mma_sync_ms"] += st["mma_sync"]
        bf["mix_ms"] += st["mix"]
        bf["cudnn_ms"] += st["cudnn"]
        print(f"[{gpu}] phase 3: K2 amp_layer stage C={C} T={T} (9 layers): "
              f"K2-bf16 {st['bf_ms']:.3f} ms (mma.sync K2-bf16 "
              f"{st['mma_sync']:.3f} ms in alternated turns, mix alone "
              f"{st['mix']:.3f} ms, cuDNN bf16 convs {st['cudnn']:.3f} ms, "
              f"plain {st['bf_plain_ms']:.3f} ms, bound {st['bf_bound']:.3f} "
              f"ms), float32 K2 {st['ms']:.3f} ms (plain "
              f"{st['plain_ms']:.3f} ms, bound {st['bound']:.3f} ms on the "
              f"TF32 tensor cores, {st['bound_cc']:.3f} ms on the CUDA "
              "cores)", flush=True)
    for row in (f32, bf):
        parts = {"bytes": row["t_bytes"],
                 "operations": max(row["t_mix"], row["t_fp32"])}
        row["bound_by"] = max(parts, key=parts.get)
    print(f"[{gpu}] phase 3: K2 amp_layer, 36 layers of a {FRAMES}-frame "
          f"request: K2-bf16 {bf['ms']:.3f} ms "
          f"({bf['bound_ms'] / bf['ms']:.0%} of its bound), mma.sync K2-bf16 "
          f"{bf['mma_sync_ms']:.3f} ms, "
          f"mix alone {bf['mix_ms']:.3f} ms, cuDNN bf16 convs "
          f"{bf['cudnn_ms']:.3f} ms, plain {bf['plain_ms']:.3f} "
          f"ms, bound {bf['bound_ms']:.3f} ms (sums of bytes "
          f"{bf['t_bytes']:.3f}, bf16 mix {bf['t_mix']:.3f}, float32 "
          f"{bf['t_fp32']:.3f} ms), max abs err {bf['err']:.3g}, max abs "
          f"dev from the float32 plain version {bf['dev_f32']:.3g}, largest "
          f"difference from the mma.sync kernel {bf['diff_mma_sync']:.3g}; "
          f"float32 K2 (3xTF32) {f32['ms']:.3f} ms "
          f"({f32['flops'] / (f32['ms'] * 1e-3) / 1e12:.2f} TFLOP/s of "
          f"float32 work), plain {f32['plain_ms']:.3f} ms, bound "
          f"{f32['bound_ms']:.3f} ms on the TF32 tensor cores (sums of bytes "
          f"{f32['t_bytes']:.3f}, 3 x TF32 mix {f32['t_mix']:.3f}, float32 "
          f"{f32['t_fp32']:.3f} ms; {f32['bound_by']}) and "
          f"{f32['bound_cc_ms']:.3f} ms on the CUDA cores (operations), max "
          f"abs err {f32['err']:.3g}", flush=True)
    return f32, bf


def phase_k3(k2, randn, voc_cfg, gpu, failures):
    """K3 at every AMPBlock shape of a request against its plain version,
    timed beside the three amp_layer calls of the serving path."""
    import math

    import torch

    row = dict(err=0.0, ms=0.0, plain_ms=0.0, layers_ms=0.0,
               layers_bf16_ms=0.0, bound_ms=0.0, bytes_ms=0.0)
    for C, T in stage_shapes(voc_cfg, FRAMES):
        for k, dils in zip(voc_cfg["resblock_kernel_sizes"],
                           voc_cfg["resblock_dilations"]):
            dils = tuple(dils)
            # conv gain capped at 1 (tests/test_torch_cuda.py::_block_args)
            ws = min(0.05, 1.0 / math.sqrt(k * C))
            x = 0.3 * randn(1, T, C)
            params = tuple((0.2 * randn(C), ws * randn(C, C, k),
                            0.1 * randn(C), 0.2 * randn(C),
                            ws * randn(C, C, k), 0.1 * randn(C))
                           for _ in dils)

            def layers(bf16=False):
                h = x
                for p, d in zip(params, dils):
                    h = k2.amp_layer(h, *p, d, bf16=bf16)
                return h

            y = k2.amp_block(x, params, dils)
            ref = k2.amp_block_plain(x, params, dils)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            row["err"] = max(row["err"], err)
            if not torch.allclose(y, ref, **K2_TOL):
                failures.append(f"K3 C={C} T={T} k={k}: max abs err "
                                f"{err:.3g}")
            ms = cuda_ms(lambda: k2.amp_block(x, params, dils), iters=5)
            lms = cuda_ms(layers, iters=5)
            lbms = cuda_ms(lambda: layers(True), iters=5)
            plain = cuda_ms(lambda: k2.amp_block_plain(x, params, dils),
                            iters=2, kernel=False)
            nbytes, flops = k3_cost(1, T, C, k, len(dils))
            bms, by = bound_ms(nbytes, flops)
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("layers_ms", lms), ("layers_bf16_ms", lbms),
                           ("bound_ms", bms),
                           ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3)):
                row[key] += v
            print(f"[{gpu}] phase 6: K3 amp_block C={C} T={T} k={k} "
                  f"d={dils}: err {err:.3g}; kernel {ms:.4f} ms, 3 x "
                  f"amp_layer {lms:.4f} ms (bf16: {lbms:.4f} ms), plain "
                  f"{plain:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["bound_ms"]
                       else "operations")
    print(f"[{gpu}] phase 6: K3, 12 AMPBlocks of a {FRAMES}-frame request: "
          f"kernel {row['ms']:.3f} ms, 3 x amp_layer {row['layers_ms']:.3f} "
          f"ms (bf16: {row['layers_bf16_ms']:.3f} ms), plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
          f"ms ({row['bound_by']}), max abs err {row['err']:.3g}",
          flush=True)
    return row


def _counts(k1, k2):
    return {"antialias_snake": k1.antialias_snake.launches,
            "amp_layer_bf16": k2.amp_layer.launches_bf16,
            "amp_layer": k2.amp_layer.launches,
            "amp_block": k2.amp_block.launches}


def _zero_counts(k1, k2):
    k1.antialias_snake.launches = 0
    k2.amp_layer.launches = 0
    k2.amp_layer.launches_bf16 = 0
    k2.amp_block.launches = 0


def _reference_wav(seconds=3.0, sr=24000, seed=5):
    """A seeded voiced stand-in recording: 8 harmonics of a gliding
    120-220 Hz fundamental with a syllable envelope, plus noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 170 + 50 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.15 * env * wav + 0.005 * rng.randn(t.size)).astype(np.float32)


def phase_serving(Synthesizer, k1, k2, model, vocoder, synth, seqs, prompts,
                  gpu, failures):
    """The serving paths beyond the two-phase request, each checked and
    driven with the launch counts set to 0 just before and read after."""
    import numpy as np
    import torch

    from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform

    samples = FRAMES * 240
    per_request = {"antialias_snake": 1, "amp_layer_bf16": 72,
                   "amp_layer": 0, "amp_block": 0}
    tok = synth.tokenizer
    kw = dict(use_max=True, noise_scale=0.0)

    def run(label, fn, expect):
        _zero_counts(k1, k2)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = _counts(k1, k2)
        print(f"[{gpu}] phase 7: {label}: wall {wall * 1e3:.1f} ms, "
              f"launches {got}", flush=True)
        if got != expect:
            failures.append(f"{label}: launches {got} != {expect}")
        return out, wall

    def times(n):
        return {k: v * n for k, v in per_request.items()}

    def same(label, a, b, atol=0.0):
        err = float(np.abs(a.astype(np.float64) - b).max())
        if a.shape != b.shape or not err <= atol:
            failures.append(f"{label}: shape {a.shape} vs {b.shape}, max "
                            f"abs err {err:.3g} (tol {atol})")
        return err

    # two-phase references, seeds 0-2
    ref = [synth.synthesize(seqs, prompts, seed=i, **kw)[0][0]
           for i in range(3)]

    # speculative (the 640-frame bucket predicted, no pre-pass) and
    # two-phase requests in turns: the host's launch rate, which sets the
    # wall time, drifts within a call
    spec = Synthesizer(model, vocoder, tokenizer=tok, device=synth.device,
                       speculative=True, spec_frames_per_phone=10.0,
                       to_mel=MelSpectrogramTransform())
    walls = {"two-phase": [], "speculative": []}
    err = 0.0
    for i in range(N_TURNS):
        order = [("two-phase", synth), ("speculative", spec)]
        for name, sy in (order if i % 2 == 0 else order[::-1]):
            (wavs, _), wall = run(
                f"{name} request {i}",
                lambda: sy.synthesize(seqs, prompts, seed=i % 3, **kw),
                times(1))
            walls[name].append(wall)
            err = max(err, same(f"{name} request {i} vs two-phase",
                                wavs[0], ref[i % 3]))
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    diff = [round((b - a) * 1e3, 1)
            for a, b in zip(walls["two-phase"], walls["speculative"])]
    print(f"[{gpu}] phase 7: {N_TURNS} turns, median wall two-phase "
          f"{med['two-phase']:.1f} ms, speculative {med['speculative']:.1f} "
          f"ms (speculative minus two-phase, per turn: {diff} ms); "
          f"spec_requests {spec.spec_requests}, spec_mispredicts "
          f"{spec.spec_mispredicts}; vs two-phase max abs err {err:.3g}",
          flush=True)
    if spec.spec_mispredicts != 0:
        failures.append(f"{spec.spec_mispredicts} mispredicts at 10 frames "
                        "per phone")

    # forced mispredict: 5 frames per phone predicts 320 frames
    short = Synthesizer(model, vocoder, tokenizer=tok, device=synth.device,
                        speculative=True, spec_frames_per_phone=5.0)
    (wavs, _), _ = run("forced mispredict (320 -> 640 frames)",
                       lambda: short.synthesize(seqs, prompts, seed=1, **kw),
                       times(2))
    err = same("mispredict vs two-phase", wavs[0], ref[1])
    print(f"[{gpu}] phase 7: mispredicts {short.spec_mispredicts} of "
          f"{short.spec_requests}; re-dispatched wav vs two-phase max abs "
          f"err {err:.3g}", flush=True)
    if short.spec_mispredicts != 1:
        failures.append(f"forced mispredict: {short.spec_mispredicts} "
                        "re-dispatches")

    # the two-phase reference-wav request (it also puts the mel
    # filterbank and the STFT window on the device once)
    ref_synth = Synthesizer(model, vocoder, tokenizer=tok,
                            device=synth.device,
                            to_mel=MelSpectrogramTransform())
    ref_wav = _reference_wav()
    ref.append(ref_synth.synthesize(seqs, reference_wavs=[ref_wav], seed=0,
                                    **kw)[0][0])

    # a request's host -> device copies (phones, prompt ids, the reference
    # wav and its mel) are all made when its inputs are staged
    # (Synthesizer._request); staged behind a spin kernel, they must be
    # queued while the spin still runs, not wait for it
    torch.cuda.synchronize()
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    spin[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin[1].record()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spec._request(seqs, prompts, None, None, True, 0.0, 0)
        spec._request(seqs, None, None, [ref_wav], True, 0.0, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_stage = time.perf_counter() - t0
    spinning = not spin[1].query()
    spin[1].synchronize()
    spin_ms = spin[0].elapsed_time(spin[1])
    print(f"[{gpu}] phase 7: inputs of a prompted and a reference-wav "
          f"request staged in {t_stage * 1e3:.2f} ms behind a "
          f"{spin_ms:.1f} ms spin kernel, which was "
          f"{'still' if spinning else 'NO LONGER'} running", flush=True)
    if not spinning:
        failures.append(f"staging a request's inputs took "
                        f"{t_stage * 1e3:.1f} ms, past the {spin_ms:.1f} ms "
                        "spin queued before it")

    # synthesize_async: two prompted requests and one conditioned on a
    # reference wav, queued, then resolved in order
    def queued():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handles = [spec.synthesize_async(seqs, prompts, seed=i, **kw)
                       for i in range(2)]
            handles.append(spec.synthesize_async(
                seqs, reference_wavs=[ref_wav], seed=0, **kw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_queue = time.perf_counter() - t0
        return t_queue, [h.result()[0][0] for h in handles]

    (t_queue, outs), wall = run("3 x synthesize_async (one reference-wav)",
                                queued, times(3))
    errs = [same(f"async request {i} vs synthesize", o, ref[r])
            for i, (o, r) in enumerate(zip(outs, (0, 1, 3)))]
    print(f"[{gpu}] phase 7: async: 3 requests (the third conditioned on a "
          f"reference wav) queued in {t_queue * 1e3:.1f} ms with no "
          f"synchronizing call, all resolved after {wall * 1e3:.1f} ms "
          f"({wall / 3 * 1e3:.1f} ms per request); vs synthesize max abs "
          f"err {max(errs):.3g}", flush=True)

    # streaming, with and without the first-chunk ramp, in turns
    stream_synths = {first: Synthesizer(
        model, vocoder, tokenizer=tok, device=synth.device,
        chunk_frames=CHUNK, halo_frames=HALO, first_chunk_frames=first)
        for first in (None, FIRST_CHUNK)}
    ttfc = {first: [] for first in stream_synths}
    totals = {first: [] for first in stream_synths}
    n_chunks, errs = {}, {first: 0.0 for first in stream_synths}
    margin = HALO * 240
    for i in range(N_TURNS):
        order = list(stream_synths) if i % 2 == 0 \
            else list(stream_synths)[::-1]
        for first in order:
            _zero_counts(k1, k2)
            t0 = time.perf_counter()
            gen = stream_synths[first].synthesize_streaming(
                seqs, prompts, seed=0, **kw)
            chunks, per_chunk = [], []
            while True:
                before = _counts(k1, k2)
                try:
                    chunks.append(next(gen))
                except StopIteration as stop:
                    flens = stop.value
                    break
                if len(chunks) == 1:
                    ttfc[first].append(time.perf_counter() - t0)
                after = _counts(k1, k2)
                per_chunk.append({k: after[k] - before[k] for k in after})
            totals[first].append(time.perf_counter() - t0)
            n_chunks[first] = len(chunks)
            stream = np.concatenate(chunks, axis=1)[0, : int(flens[0]) * 240]
            errs[first] = max(errs[first], same(
                f"stream (first {first}) vs batched, interior",
                stream[margin:-margin], ref[0][margin:-margin],
                STREAM_ATOL))
            if any(c != per_request for c in per_chunk):
                failures.append(f"streaming launches per chunk {per_chunk}")
    for first in stream_synths:
        print(f"[{gpu}] phase 7: streaming chunk {CHUNK} halo {HALO} first "
              f"{first}: {n_chunks[first]} chunks, time to first chunk "
              f"median {np.median(ttfc[first]) * 1e3:.1f} ms "
              f"({[round(t * 1e3, 1) for t in ttfc[first]]}), total median "
              f"{np.median(totals[first]) * 1e3:.1f} ms; launches per chunk "
              f"{per_request}; stream vs batched interior max abs err "
              f"{errs[first]:.3g}", flush=True)

    # chunked vocoding against batched
    chunked = Synthesizer(model, vocoder, tokenizer=tok, device=synth.device,
                          vocoder_mode="chunked", chunk_frames=CHUNK,
                          halo_frames=HALO)
    (wavs, _), _ = run("chunked vocoder request",
                       lambda: chunked.synthesize(seqs, prompts, seed=0,
                                                  **kw), times(1))
    margin = HALO * 240
    err = same("chunked vs batched, interior", wavs[0][margin:-margin],
               ref[0][margin:-margin], STREAM_ATOL)
    print(f"[{gpu}] phase 7: chunked vs batched interior max abs err "
          f"{err:.3g}", flush=True)

    # reference-wav conditioning
    (wavs, _), wall = run(
        "reference-wav request (3 s, 24 kHz)",
        lambda: ref_synth.synthesize(seqs, reference_wavs=[ref_wav], seed=0,
                                     **kw), times(1))
    w = wavs[0]
    err = same("reference-wav request vs its first run", w, ref[3])
    print(f"[{gpu}] phase 7: reference-wav request: wav {w.shape}, rms "
          f"{np.sqrt(np.mean(w ** 2)):.4f}, wall {wall * 1e3:.1f} ms; vs "
          f"its first run max abs err {err:.3g}", flush=True)
    if w.shape != (samples,) or not np.isfinite(w).all():
        failures.append(f"reference-wav request: wav {w.shape}, finite "
                        f"{bool(np.isfinite(w).all())}")


def _eager_decode(decoder, cond, x_T=None, zero_noise=False,
                  generator=None):
    """The decode without its graph: ``GaussianDiffusion.inference``."""
    return decoder.inference(cond, x_T, zero_noise, generator)


def phase_graphs(Synthesizer, k1, k2, model, vocoder, synth, seqs, prompts,
                 gpu, failures, graph_profile, audio_s):
    """The decode as CUDA graphs: prewarm, capture costs, bits and timings
    against the eager decode, PLMS-10 and bf16 decode storage."""
    import contextlib

    import numpy as np
    import torch

    from promptttspp_tpu_torch.models import decode_graph

    dev, tok = synth.device, synth.tokenizer
    kw = dict(use_max=True, noise_scale=0.0)
    eager = lambda: mock.patch.object(decode_graph, "decode", _eager_decode)

    def same_bits(label, a, b):
        ok = all(np.array_equal(x, y) for x, y in zip(a[0] + a[1],
                                                      b[0] + b[1]))
        if not ok:
            failures.append(f"{label}: graph decode differs from eager")
        return ok

    # prewarm: the speculative grid up to the request's 64 phones
    pw = Synthesizer(model, vocoder, tokenizer=tok, device=dev,
                     speculative=True, spec_frames_per_phone=10.0,
                     chunk_frames=CHUNK, halo_frames=HALO,
                     first_chunk_frames=FIRST_CHUNK)
    _zero_counts(k1, k2)
    t0 = time.perf_counter()
    rows = pw.prewarm(grid="speculative", max_phones=PHONES, streaming=True)
    t_pw = time.perf_counter() - t0
    print(f"[{gpu}] phase 8: prewarm(grid=\"speculative\", max_phones="
          f"{PHONES}, streaming=True): {len(rows)} rows in {t_pw:.1f} s, "
          f"kernel launches {_counts(k1, k2)}", flush=True)
    for row in rows:
        print(f"  prewarm {json.dumps(row)}")
    captured = decode_graph.captured(model.decoder)
    pw.synthesize(seqs, prompts, seed=0, **kw)
    if decode_graph.captured(model.decoder) != captured:
        failures.append("a request on a prewarmed shape captured a graph")
    # the request's conditioning, for the decode alone
    _, _, req = synth._request(seqs, prompts, None, None, True, 0.0, 0)
    with torch.inference_mode():
        cond = model.infer_cond(req["phoneme"], req["plens"], FRAMES,
                                req["prompt_ids"], req["prompt_mask"],
                                use_max=True, noise_scale=0.0)[0]
    # the largest bucket (max_frames_cap frames) too, for its memory
    g = torch.Generator(device=dev).manual_seed(1)
    cond_cap = torch.randn((1, synth.max_frames_cap, cond.shape[-1]),
                           generator=g, device=dev)
    decode_graph.decode(model.decoder, cond_cap, generator=g)
    for c in decode_graph.captured(model.decoder):
        print(f"[{gpu}] phase 8: decode graph B={c['B']} T={c['T']}: "
              f"captured in {c['capture_s']:.2f} s (with its warm-up run), "
              f"static buffers and output {c['buffer_bytes'] / 2**20:.1f} "
              f"MiB, device memory held grew by "
              f"{c['reserved_bytes'] / 2**20:.1f} MiB", flush=True)

    # graph against eager, bit for bit
    x_T = torch.randn((1, FRAMES, model.decoder.out_dim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(11))
    cases = {"noise from the generator": dict(seed=5, **kw),
             "x_T and zero noise": dict(seed=7, x_T=x_T, zero_noise=True,
                                        **kw)}
    for label, args in cases.items():
        got = synth.synthesize(seqs, prompts, **args)
        with eager():
            want = synth.synthesize(seqs, prompts, **args)
        ok = same_bits(f"request with {label}", got, want)
        print(f"[{gpu}] phase 8: request with {label}: graph decode vs "
              f"eager decode {'equal bit for bit' if ok else 'DIFFER'} "
              "(mel and wav)", flush=True)

    # eager and graph requests in turns
    walls = {"eager": [], "graph": []}
    for i in range(N_ALT):
        for mode in (("eager", "graph") if i % 2 == 0
                     else ("graph", "eager")):
            with (eager() if mode == "eager" else contextlib.nullcontext()):
                t0 = time.perf_counter()
                synth.synthesize(seqs, prompts, seed=i % 3, **kw)
                walls[mode].append(time.perf_counter() - t0)
    med = {m: float(np.median(w)) for m, w in walls.items()}
    for m, w in walls.items():
        print(f"[{gpu}] phase 8: {m} decode, two-phase request: median wall "
              f"{med[m] * 1e3:.1f} ms, RTF {med[m] / audio_s:.5f} "
              f"({[round(x * 1e3, 1) for x in w]} ms)", flush=True)
    diff = [round((g - e) * 1e3, 1)
            for e, g in zip(walls["eager"], walls["graph"])]
    print(f"[{gpu}] phase 8: graph minus eager wall per turn: {diff} ms",
          flush=True)
    with eager():
        eager_profile = profile_request(synth, seqs, prompts, gpu,
                                        med["eager"], "eager")
    for m, prof in (("eager", eager_profile), ("graph", graph_profile)):
        if prof is not None:
            print(f"[{gpu}] phase 8: {m} decode: device "
                  f"{prof['device_ms']:.1f} ms of the {med[m] * 1e3:.1f} ms "
                  "median wall, device busy "
                  f"{prof['device_ms'] / (med[m] * 1e3):.1%}; host-issued "
                  f"launches per request {prof['host_launches']} "
                  f"({prof['launches']})", flush=True)


    def decode_ms(decoder):
        g = torch.Generator(device=dev).manual_seed(0)
        return cuda_ms(lambda: decode_graph.decode(decoder, cond,
                                                   generator=g), iters=5)

    # PLMS-10: 11 denoiser calls instead of 100
    plms = Synthesizer(model, vocoder, tokenizer=tok, device=dev)
    plms._decoder = model.decoder.clone(pndm_speedup=PLMS_SPEEDUP)
    # bf16 decode storage: cond projections and denoiser parameters
    bf16 = Synthesizer(model, vocoder, tokenizer=tok, device=dev,
                       decode_param_dtype="bfloat16")
    bf16._decoder = bf16._decoder.clone(infer_io_dtype="bfloat16")
    det = cases["x_T and zero noise"]
    ref_mel = synth.synthesize(seqs, prompts, **det)[1][0]
    for label, sy in ((f"PLMS-{PLMS_SPEEDUP}", plms), ("bf16 storage", bf16)):
        got = sy.synthesize(seqs, prompts, **det)
        with eager():
            want = sy.synthesize(seqs, prompts, **det)
        ok = same_bits(f"{label} request", got, want)
        w = []
        for i in range(3):
            t0 = time.perf_counter()
            wavs, _ = sy.synthesize(seqs, prompts, seed=i, **kw)
            w.append(time.perf_counter() - t0)
        if wavs[0].shape != (FRAMES * 240,) or not np.isfinite(
                wavs[0]).all():
            failures.append(f"{label} request: wav {wavs[0].shape}")
        dev_f32 = float(np.abs(got[1][0] - ref_mel).max())
        print(f"[{gpu}] phase 8: {label} request: graph vs eager "
              f"{'equal bit for bit' if ok else 'DIFFER'}; mel max abs dev "
              f"from the float32 ancestral decode {dev_f32:.3g}; wall "
              f"median {np.median(w) * 1e3:.1f} ms "
              f"({[round(x * 1e3, 1) for x in w]})", flush=True)
        profile_request(sy, seqs, prompts, gpu, float(np.median(w)),
                        label.split()[0].lower())
    g = torch.Generator(device=dev).manual_seed(0)
    cap_ms = cuda_ms(lambda: decode_graph.decode(model.decoder, cond_cap,
                                                 generator=g), iters=3)
    print(f"[{gpu}] phase 8: decode alone at B=1 T={synth.max_frames_cap}, "
          f"ancestral: {cap_ms:.3f} ms per graph replay", flush=True)
    for label, dec in ((f"ancestral (K={model.decoder.K_step})",
                        model.decoder),
                       (f"PLMS-{PLMS_SPEEDUP}", plms._decoder),
                       ("bf16 storage", bf16._decoder)):
        print(f"[{gpu}] phase 8: decode alone at B=1 T={FRAMES}, "
              f"{label}: {decode_ms(dec):.3f} ms per graph replay (CUDA "
              "events, input copy and draws included)", flush=True)

    # what TF32 would give (the port does not use it): the decode captured
    # with the float32 scope lifted and TF32 on for cuDNN and cuBLAS
    from promptttspp_tpu_torch.models import diffusion

    tf32 = model.decoder.clone()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mock.patch.object(diffusion, "float32_math",
                               contextlib.nullcontext):
            tf32_ms = decode_ms(tf32)
            g = torch.Generator(device=dev).manual_seed(0)
            mel_tf32 = decode_graph.decode(tf32, cond, generator=g)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    mel_f32 = decode_graph.decode(model.decoder, cond, generator=g)
    dev_tf32 = (mel_tf32 - mel_f32).abs().max().item()
    print(f"[{gpu}] phase 8: decode alone at B=1 T={FRAMES} with TF32 (not "
          f"used by the port): {tf32_ms:.3f} ms per graph replay; mel max "
          f"abs dev from float32 {dev_tf32:.3g}", flush=True)


def phase_cli(Synthesizer, k1, k2, vocoder, synth, seqs, prompts, gpu,
              failures):
    """The demo model and the flagship vocoder written as reference
    checkpoints, served by the synthesize CLI in-process (see phase 9 of
    the module docstring). ``synth`` is phase 4's flagship synthesizer."""
    import os
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import synthesize as cli
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
    from promptttspp_tpu_torch.tools.synthetic_corpus import write_corpus

    t_phase = time.perf_counter()
    dev = synth.device
    root = OUT_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    demo = flagship.bias_duration_head(
        flagship.build_model(flagship.MODEL_DEMO, dev, seed=2), 10.0)
    rng = np.random.RandomState(9)
    rows = [dict(spk_id=spk, item_name=f"utt_{spk}_{i}",
                 seq=list(rng.randint(1, 90, PHONES)), style_prompt_key=key)
            for i, (spk, key) in enumerate(((1034, "M_p-low_s-slow_e-low"),
                                            (2277, "F_p-high_s-fast_e-high")))]
    cands = {"M_p-low_s-slow_e-low": [
                 "A man speaks slowly with a low voice and low energy",
                 "A deep, calm male voice speaking slowly"],
             "F_p-high_s-fast_e-high": [
                 "A woman speaks quickly and loudly with a high pitch",
                 "A bright, energetic female voice, fast"]}
    t0 = time.perf_counter()
    write_corpus(root, rows, cands, wav_seconds=3.0, mel_mean=0.0,
                 mel_std=1.0)
    saved = to_reference_state_dict(demo)
    torch.save({"epoch": 0, "model": saved, "optimizer": {}},
               root / "model.ckpt")
    saved_voc = to_reference_state_dict(vocoder, BIGVGAN_WEIGHT_NORMED.match)
    torch.save({"generator": saved_voc}, root / "vocoder.ckpt")
    n_params = sum(p.numel() for p in demo.parameters())
    print(f"phase 9: wrote {root / 'model.ckpt'} "
          f"({(root / 'model.ckpt').stat().st_size / 1e9:.2f} GB, "
          f"{n_params / 1e6:.1f} M parameters), the vocoder's "
          f"({(root / 'vocoder.ckpt').stat().st_size / 1e6:.1f} MB, "
          f"{sum(k.endswith('_g') for k in saved_voc)} weight-normed "
          f"convolutions) and the corpus in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    built, walls = [], []
    build, synthesize = cli.build_synthesizer, Synthesizer.synthesize

    def timed_build(cfg, *a, **kw):
        t = time.perf_counter()
        built.append(build(cfg, *a, **kw))
        torch.cuda.synchronize()
        walls.append(("load", time.perf_counter() - t))
        return built[-1]

    def timed_request(self, *a, **kw):
        t = time.perf_counter()
        out = synthesize(self, *a, **kw)
        walls.append(("request", time.perf_counter() - t))
        return out

    out_dir, cwd = root / "out", os.getcwd()
    argv = [f"path.root={root}", f"model_ckpt={root / 'model.ckpt'}",
            f"vocoder_ckpt={root / 'vocoder.ckpt'}", f"output_dir={out_dir}",
            f"hydra.run.dir={root / 'run'}", "num_eval_utts=2",
            "model=prompttts_mdn_v2_wo_erg_final_demo", "noise_scale=0"]
    _zero_counts(k1, k2)
    try:
        with mock.patch.object(cli, "build_synthesizer", timed_build), \
                mock.patch.object(Synthesizer, "synthesize", timed_request):
            cli.main(argv)
    finally:
        os.chdir(cwd)
    launches = _counts(k1, k2)
    expect = {"antialias_snake": 4, "amp_layer_bf16": 4 * 72,
              "amp_layer": 0, "amp_block": 0}
    served = built[0]
    requests = [w for kind, w in walls if kind == "request"]
    print(f"[{gpu}] phase 9: synthesize CLI (demo model): load "
          f"{walls[0][1]:.2f} s, first request {requests[0]:.2f} s, then "
          f"{', '.join(f'{w * 1e3:.1f}' for w in requests[1:])} ms; 4 "
          f"requests, launches {launches} (expected {expect})", flush=True)
    if launches != expect:
        failures.append(f"CLI: launch counts {launches} != {expect}")

    wavs = sorted(out_dir.rglob("*.wav"))
    want = [out_dir / str(r["spk_id"]) / m / "wav" / f"{r['item_name']}.wav"
            for r in rows for m in ("prompt", "ref")]
    if sorted(want) != wavs or not (out_dir / "finish").exists():
        failures.append(f"CLI tree: {wavs}, finish "
                        f"{(out_dir / 'finish').exists()}")
    from scipy.io import wavfile
    lengths = [len(wavfile.read(p)[1]) for p in wavs]
    print(f"phase 9: tree {[p.relative_to(out_dir).as_posix() for p in wavs]}"
          f", wav lengths {lengths}", flush=True)
    if lengths != [PHONES * 10 * 240] * len(wavs):
        failures.append(f"CLI wav lengths {lengths}")

    # loaded against saved: bit for bit, but for the folded weight norm
    mismatch, rel = [], 0.0
    for module, sd in ((served.model, saved), (served.vocoder, saved_voc)):
        for k, v in module.state_dict().items():
            v = v.cpu()
            if k in sd:
                if not torch.equal(v, sd[k]):
                    mismatch.append(k)
            else:
                ref = sd[k + "_v"].double()
                rel = max(rel, float((v.double() - ref).abs().max()
                                     / ref.abs().max()))
    print(f"phase 9: loaded parameters against the saved ones: "
          f"{len(mismatch)} unfolded tensors differ; the folded weight norm's "
          f"max relative error {rel:.3g}", flush=True)
    if mismatch or not rel <= 1e-6:
        failures.append(f"CLI load: {mismatch[:4]} differ, folded rel err "
                        f"{rel:.3g}")

    # the CLI's synthesizer against the in-memory one on the original
    # modules: one prompt request, the diffusion noise drawn from the same
    # seed (each decoder's graph for this shape is then captured once)
    memory = Synthesizer(demo, vocoder, tokenizer=served.tokenizer,
                         mel_stats=served.mel_stats, device=dev)
    det = dict(use_max=True, noise_scale=0.0, seed=7)
    text = [f"{cands['M_p-low_s-slow_e-low'][1]}."]
    wav_c, mel_c = served.synthesize(seqs, text, **det)
    wav_m, mel_m = memory.synthesize(seqs, text, **det)
    err = float(np.abs(wav_c[0] - wav_m[0]).max())
    print(f"[{gpu}] phase 9: CLI synthesizer vs in-memory modules: wav max "
          f"abs err {err:.3g} (tol {WAV_BF16_ATOL}), mel "
          f"{float(np.abs(mel_c[0] - mel_m[0]).max()):.3g}", flush=True)
    if wav_c[0].shape != wav_m[0].shape or not err <= WAV_BF16_ATOL:
        failures.append(f"CLI vs in-memory wav: {err:.3g}")

    # the demo (legacy, T x T attention) and the flagship ('new', T x
    # (2T-1)) models in alternated turns, the same request shape
    demo_synth = Synthesizer(demo, vocoder, tokenizer=synth.tokenizer,
                             device=dev)
    demo_synth.synthesize(seqs, prompts, use_max=True, noise_scale=0.0)
    turns = {"flagship": [], "demo": []}
    for order in (("flagship", "demo"), ("demo", "flagship")) * 2:
        for name in order:
            s = synth if name == "flagship" else demo_synth
            t = time.perf_counter()
            s.synthesize(seqs, prompts, use_max=True, noise_scale=0.0)
            turns[name].append(time.perf_counter() - t)
    print(f"[{gpu}] phase 9: steady two-phase request in alternated turns: "
          + ", ".join(f"{name} median {np.median(w) * 1e3:.1f} ms "
                      f"({', '.join(f'{x * 1e3:.1f}' for x in w)})"
                      for name, w in turns.items()), flush=True)
    del demo, demo_synth, memory, served, built
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)


def train_batch(rng, lens, mel_dim=80, L=16):
    """A numpy training batch of len(lens) utterances of ``lens`` phones,
    2-5 frames per phone, a 64-frame bucket, and the diffusion steps and
    noise given."""
    import numpy as np

    B, Tp = len(lens), max(lens)
    duration = np.zeros((B, Tp), np.int64)
    for b, n in enumerate(lens):
        duration[b, :n] = rng.randint(2, 6, n)
    flens = duration.sum(1)
    Tf = -(-int(flens.max()) // 64) * 64
    frame = (np.arange(Tf)[None] < flens[:, None])[:, :, None]
    phoneme = rng.randint(1, 90, (B, Tp)) * (duration > 0)
    ids = rng.randint(1000, 29000, (B, L))
    ids[:, 0] = 101
    return dict(
        phoneme=phoneme, duration=duration, phone_lengths=np.asarray(lens),
        mel=(rng.randn(B, Tf, mel_dim) * frame).astype(np.float32),
        log_cf0=(rng.randn(B, Tf, 1) * frame).astype(np.float32),
        vuv=((rng.rand(B, Tf, 1) > 0.3) * frame).astype(np.float32),
        frame_lengths=flens, prompt_ids=ids, prompt_mask=np.ones_like(ids),
        batch_weight=np.ones(B, np.float32),
        diffusion_t=rng.randint(0, 100, B),
        diffusion_noise=rng.randn(B, Tf, mel_dim).astype(np.float32))


def phase_train(k1, k2, vocoder, dev, gpu, failures, model_cfg=None,
                bert_config=None, train_overrides=(), synth_overrides=()):
    """Training on the card (see phase 10 of the module docstring).
    ``model_cfg`` (default the flagship's), ``bert_config`` (default
    bert-base) and the overrides appended to the train and synthesize
    CLIs' command lines exist to rehearse the phase at a smaller size."""
    import copy
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import synthesize as synth_cli
    from promptttspp_tpu_torch.bin import train as train_cli
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
    from promptttspp_tpu_torch.data.dataset import (
        read_prompt_candidate, read_spk_prompt_candidate)
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_corpus, write_training_corpus)
    from promptttspp_tpu_torch.train.state import TrainState

    t_phase = time.perf_counter()
    model_cfg = copy.deepcopy(model_cfg or flagship.MODEL)
    bert_config = bert_config or flagship.bert_config_of(
        model_cfg["prompt_encoder"])
    mel_dim = model_cfg["decoder"]["out_dim"]

    # (a) one train step on the card against the CPU, dropout rates 0
    cfg0 = copy.deepcopy(model_cfg)
    cfg0["encoder"].update(dropout_rate=0.0, positional_dropout_rate=0.0)
    va = cfg0["variance_adaptor"]
    va["duration_predictor"]["dropout"] = 0.0
    va["pitch_predictor"]["dropout"] = 0.0
    va["frame_prior_network"].update(p_dropout=0.0, pos_enc_p_dropout=0.0)
    bert0 = dataclasses.replace(bert_config, hidden_dropout=0.0,
                                attention_dropout=0.0)
    cpu = flagship.build_model(cfg0, "cpu", seed=3, bert_config=bert0)
    card = copy.deepcopy(cpu).to(dev)
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = train_batch(np.random.RandomState(4), [24, 17], mel_dim)
    outs, walls = [], []
    for model, d in ((cpu, "cpu"), (card, dev)):
        state = TrainState(model, seed=0)
        tb = {k: torch.from_numpy(np.asarray(v)).to(d)
              for k, v in batch.items()}
        t0 = time.perf_counter()
        outs.append({k: v.item() for k, v in state.train_step(tb).items()})
        walls.append(time.perf_counter() - t0)
    loss_ok = all(np.isclose(outs[1][k], v, **TRAIN_LOSS_TOL)
                  for k, v in outs[0].items())
    ref, params = cpu.state_dict(), dict(cpu.named_parameters())
    diff = moved = 0.0
    for k, v in card.state_dict().items():
        if v.dtype.is_floating_point:
            diff = max(diff, float((v.cpu() - ref[k]).abs().max()))
            if k in params:
                moved = max(moved, float((ref[k] - init[k]).abs().max()))
    print(f"[{gpu}] phase 10 (a): one train step of the flagship "
          f"({sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M params, "
          f"{len(state.params)} trainable tensors), batch "
          f"{list(batch['mel'].shape)}: card "
          + ", ".join(f"{k} {v:.6g}" for k, v in outs[1].items())
          + "; CPU " + ", ".join(f"{k} {v:.6g}" for k, v in outs[0].items())
          + f"; parameters and BatchNorm statistics after the update: max "
          f"abs diff {diff:.3g} (tol {TRAIN_PARAM_ATOL}; the update moved "
          f"the parameters by up to {moved:.3g}); step wall card "
          f"{walls[1] * 1e3:.1f} ms (first), CPU {walls[0]:.2f} s",
          flush=True)
    if not loss_ok or not diff <= TRAIN_PARAM_ATOL:
        failures.append(f"train step card vs CPU: losses {outs}, params "
                        f"{diff:.3g}")
    del cpu, card, init, ref, state

    # (b) the train CLI on a synthetic corpus
    root = OUT_DIR / "train"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    meta = ROOT / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    rows = training_rows(TRAIN_UTTS, cands, spk, TRAIN_PHONES, TRAIN_FPP,
                         valid_every=20, seed=5)
    eval_rows = [dict(spk_id=r["spk_id"], item_name=f"eval_{i}",
                      seq=r["seq"][:24], style_prompt_key=r[
                          "style_prompt_key"])
                 for i, r in enumerate(rows[:1])]
    write_corpus(root, eval_rows, cands, wav_seconds=3.0, mel_mean=-5.0,
                 mel_std=2.0)
    write_training_corpus(root, rows, cands, spk, n_mels=mel_dim,
                          mel_mean=-5.0, mel_std=2.0, seed=6)
    n_frames = sum(sum(r["durations"]) for r in rows if r["split"] == "trn")
    print(f"phase 10 (b): wrote {len(rows)} utterances ({n_frames} training "
          f"frames) under {root} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    starts, losses, frames = [], [], []
    step_fn = TrainState.train_step

    def timed_step(self, b):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append(ev)
        frames.append(b["frame_lengths"])
        out = step_fn(self, b)
        losses.append(torch.stack(list(out.values())))
        return out

    cwd = os.getcwd()
    out_dir = root / "out"
    argv = [f"path.root={root}", f"output_dir={out_dir}",
            f"hydra.run.dir={root / 'run'}", "train.num_epochs=1",
            f"dataset.max_tokens={MAX_TOKENS}",
            f"+train.profile_steps={PROFILE_STEP}", *train_overrides]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(TrainState, "train_step", timed_step):
            trainer = train_cli.main(argv)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    starts.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(starts[:-1], starts[1:])]
    steady = step_ms[TRAIN_WARMUP:]
    n = len(step_ms)
    steady_frames = sum(int(f.sum()) for f in frames[TRAIN_WARMUP:])
    vals = torch.stack(losses).cpu().numpy()
    finite = bool(np.isfinite(vals).all())
    busy = profile_busy(trainer.profile, trainer.profile_wall_s)
    print(f"[{gpu}] phase 10 (b): train CLI, flagship, max_tokens "
          f"{MAX_TOKENS}: {n} updates in one epoch, {wall:.1f} s in all "
          f"(checkpoint included); update time median "
          f"{np.median(steady):.1f} ms after {TRAIN_WARMUP} warm-up updates "
          f"(min {min(steady):.1f}, max {max(steady):.1f}; first "
          f"{step_ms[0]:.1f}), {steady_frames / (sum(steady) / 1e3):.0f} "
          f"frames/s over those; peak memory allocated {peak / 2**30:.2f} "
          f"GiB; {busy}; loss first {vals[0][0]:.4f}, last "
          f"{vals[-1][0]:.4f}, all {vals.size} loss values finite: "
          f"{finite}", flush=True)
    log = (out_dir / "logs/train.log").read_text().splitlines()
    print("  train.log: " + " | ".join(ln for ln in log if "epoch" in ln),
          flush=True)
    if n < MIN_STEPS or not finite:
        failures.append(f"train CLI: {n} updates, losses finite {finite}")
    if not (out_dir / "ckpt/last").exists():
        failures.append("train CLI wrote no ckpt/last")
    del trainer
    torch.cuda.empty_cache()

    # (c) ckpt/last served by the synthesize CLI
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    wavs = root / "wavs"
    _zero_counts(k1, k2)
    try:
        synth_cli.main([
            f"path.root={root}", f"model_ckpt={out_dir / 'ckpt/last'}",
            f"vocoder_ckpt={root / 'vocoder.ckpt'}", f"output_dir={wavs}",
            f"hydra.run.dir={root / 'run'}", "num_eval_utts=1",
            "noise_scale=0", *synth_overrides])
    finally:
        os.chdir(cwd)
    launches = _counts(k1, k2)
    expect = {"antialias_snake": 2, "amp_layer_bf16": 2 * 72,
              "amp_layer": 0, "amp_block": 0}
    from scipy.io import wavfile
    files = sorted(wavs.rglob("*.wav"))
    lengths = [len(wavfile.read(p)[1]) for p in files]
    print(f"[{gpu}] phase 10 (c): the trained ckpt/last served by the "
          f"synthesize CLI: {[p.relative_to(wavs).as_posix() for p in files]}"
          f", wav lengths {lengths}; 2 requests, launches {launches} "
          f"(expected {expect}: K1 1 and K2-bf16 72 per request)", flush=True)
    if launches != expect:
        failures.append(f"trained checkpoint: launch counts {launches} != "
                        f"{expect}")
    if len(files) != 2 or not all(lengths):
        failures.append(f"trained checkpoint: wavs {files} {lengths}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)


def profile_busy(prof, wall_s) -> str:
    """The device-busy share of a torch.profiler window: the sum of its
    kernels' device times over its wall time."""
    from torch.autograd import DeviceType

    if prof is None:
        return "no profile (not measured)"
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # kernels only: a user annotation's device time repeats its kernels'
    total = sum(dev_us(e) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    if total == 0:
        return "profile: no device time recorded (not measured)"
    return (f"3 profiled updates: device busy {total / 1e3:.1f} ms of "
            f"{wall_s * 1e3:.1f} ms wall ({total / 1e3 / (wall_s * 1e3):.1%})")


def profile_request(synth, seqs, prompts, gpu, wall_s, label="default"):
    """Device time by kernel over one request (torch.profiler), and the
    operations the host issued for it: kernel launches, graph launches and
    copies or fills (runtime API calls). The table goes to
    build/chip_smoke/profile_request_<label>.txt. Returns {"device_ms",
    "kernels", "launches": {kind: n}, "host_launches"}, or None when the
    profiler recorded no device time."""
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
    api = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
           "graph": ("cudaGraphLaunch",),
           "copy/fill": ("cudaMemcpyAsync", "cudaMemsetAsync")}
    launches = {kind: sum(e.count for e in events
                          if e.device_type == DeviceType.CPU
                          and e.key.startswith(names))
                for kind, names in api.items()}
    if total_us == 0:
        print(f"[{gpu}] profile ({label}): no device time recorded (not "
              f"measured); host-issued {launches}")
        return None
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lines = [f"{us / 1e3:10.3f} ms {n:7d}x  {key}" for us, n, key in rows]
    ours = {"K2-bf16": "aa_conv_wgmma_kernel", "K2": "Tf32x3Mix",
            "K1": "antialias_snake_kernel"}
    sums = {name: [sum(r[i] for r in rows if pat in r[2]) for i in (0, 1)]
            for name, pat in ours.items()}
    (OUT_DIR / f"profile_request_{label}.txt").write_text(
        f"{gpu}\none two-phase 640-frame request ({label}); device ms, "
        "calls, name\n" + "\n".join(lines) + "\n")
    wall = "" if wall_s is None else (
        f" of {wall_s * 1e3:.1f} ms wall (device busy "
        f"{total_us / 1e3 / (wall_s * 1e3):.1%})")
    summary = dict(device_ms=total_us / 1e3,
                   kernels=sum(r[1] for r in rows), launches=launches,
                   host_launches=sum(launches.values()))
    print(f"[{gpu}] profile of one request ({label}): device busy "
          f"{total_us / 1e3:.1f} ms (sum of kernel times){wall}; "
          f"{summary['kernels']} kernels ran, the host issued "
          f"{summary['host_launches']} launches ({launches}); the port's "
          "kernels: "
          + ", ".join(f"{name} {us / 1e3:.3f} ms ({n} launches)"
                      for name, (us, n) in sums.items())
          + "; top kernels:")
    for line in lines[:12]:
        print("   " + line)
    return summary


if __name__ == "__main__":
    sys.exit(main())
