#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PromptTTS++ once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --phase12`` builds the kernels and runs phase 12
alone (on every visible GPU where it uses more than one), with no result
line; ``--phase13``, ``--phase14`` and ``--phase15`` do the same for
phases 13, 14 and 15.

Phases (any failure exits non-zero and prints no result line):

1. Build the hand-written kernels from ``promptttspp_tpu_torch/csrc/`` with
   nvcc and the C++ feature loader with the host compiler (one process per
   source, all at once, beside the ``mix_only`` build of K2-bf16 that
   phase 3 times) and print each kernel's registers
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
    end. (d) Training's options, about a minute: one flagship step in
    float32 and one in bf16 (``TrainState(bf16=True)``) on the card beside
    a bf16 step on the CPU from the same weights and batch, each step's
    peak memory, the card's bf16 losses within 1.5e-3 (grad_norm 2e-3
    relative) of the CPU's; then one epoch of ``bin/train.py`` (the
    flagship, ``dataset.max_tokens=10000``, a corpus of about 12 updates)
    in each of four settings, ``train.input_pipeline=sync``, ``prefetch``,
    ``sync_native`` and ``prefetch`` with ``train.bf16=true``, in two turns
    (in that order, then reversed): per setting the median update time
    (the 3 warm-up updates, the last and, in the second turn, the profiled
    updates 3-5 left out), frames/s, peak memory and the device-busy share
    of the profiled updates; every setting's per-update checksums of the
    device batch equal, the float32 settings' first-update losses equal bit
    for bit, every loss finite; and the bf16 ``ckpt/last`` served by the synthesize
    CLI (K1 once and K2-bf16 72 times per request).
11. The recipe (``promptttspp_tpu_torch/preprocess/``, ``ops/f0.py``,
    ``eval/``), about 15 s: (a) batched YIN and the mel on the card
    against the port's CPU path at the flagship preprocessing shape (16
    utterances of 3-15 s padded to one 2-s bucket: speech-like pulse
    trains with vibrato, hiss and silence, one of noise, one silent; each
    row's F0 bounds from ``metadata/libritts_r_f0_stats.yaml``): voicing
    agreement, the largest relative F0 error on frames both voice, the
    mel's largest absolute error; and one ``compute_utt_stats`` call (YIN
    at a 5-ms hop) on the card against the CPU; (b) one bucket of 16 in
    alternated turns: the device time of YIN + mel (CUDA events), the host
    time of the contour fix and of the file reads and writes, utterances
    and seconds of audio per second, peak memory; (c) the CLIs in-process
    on a raw synthetic corpus written under ``build/chip_smoke/recipe/``:
    ``bin/preprocess.py`` -> ``split_df`` -> ``compute_mel`` -> ``split_df``
    -> ``filter_eval``, ``bin/train.py`` for one epoch of the flagship on
    the tree they wrote, ``bin/synthesize.py`` on its ``ckpt/last`` for
    the ``eval_filtered`` utterances (K1 once and K2-bf16 72 times per
    request, counts set to 0 just before and read just after) and
    ``bin/eval.py`` on that output, every ``mcd`` and ``mel_l1`` finite.
    The files are deleted at the end.
12. Parallelism (``promptttspp_tpu_torch/parallel/``): (a) three flagship
    updates of ``bin/train.py`` on a synthetic corpus of three batches of
    the config's 32 rows, at the config's peak rate from the first update
    (warm-up 1, so the updates dwarf the bars), in this process without a
    process group, then over NCCL at world size ``device_count()`` (in
    this process, under torchrun's environment, at 1: its losses, gradient
    and parameters must equal the first run's bit for bit), then two gloo
    ranks spawned on ``cuda:0`` (their parameters equal to each other;
    against the first run: the first update's losses and grad_norm within
    1e-5 relative and its global gradient within 0.1 (L2) in every
    tensor, the later losses within 1e-2, the parameters' L2 difference
    within a tenth of the updates'; the reasons stand beside
    ``PARALLEL_LOSS_RTOL``): update time, the gradient all-reduce's
    time and bytes and the peak memory of each rank. Where there are two
    GPUs or more, the NCCL ranks are held to the first run as the gloo
    ranks are, and ``bin/train.py`` with no distributed keys spawns one
    NCCL worker per GPU (it returns None; its ``ckpt/last`` against the
    first run's). (b) A 640-frame request with
    ``Synthesizer(frame_sharded_decode=True, vocoder_mode="sharded")``
    over the mesh ``[cuda:0, cuda:0]``: its mel within 1e-5 of the
    unsharded eager decode's, its wav's interior within 5e-3 of the
    batched path's, its K1 and K2-bf16 launches (counts set to 0 just
    before, read just after), the decode and vocoder times of both paths.
    Where there are two GPUs or more, the request also runs over
    ``[cuda:0, cuda:1]``; with one the lines say so.
13. The model axis (``parallel/tp.py``, ``parallel/pp.py``), at the
    flagship's widths: (a) TP=2 training: three updates of ``bin/train.py``
    with ``train.mesh.model=2`` (batches of the config's 32 rows, peak
    rate from the first update) on two gloo ranks spawned on ``cuda:0``
    (NCCL over two GPUs where there are two), against one process on the
    same batches: the first update's losses and grad_norm within 1e-5
    relative, its whole gradient (the sharded tensors joined) at phase
    12's bars, the later losses and the whole ``ckpt/last`` as phase 12
    holds them; the update span, the model group's all-reduce time and
    bytes per update and each rank's peak memory; the all-reduces in each
    update's forward and backward must number ``TP_ALLREDUCES`` (one per
    row product, gather and shared column input). (b) PP training: ten
    updates with ``train.mesh.model=5``, ``pipeline_microbatches=5`` and
    ``model_spans_processes`` (TP off, as JAX turns it off) on five gloo
    ranks on ``cuda:0``: S = 5 stages of the DiffNet's 20 blocks (the
    only S > 1 its dilation cycle allows) over batches of 30 rows, against
    the unpipelined process on the same batches at the same bars, the
    later-updates bar on updates 2-3 (the one process run again drifts
    from itself by up to about 1e-2 by the tenth update: printed beside
    it), and one stage in 5 microbatches in one process held alike.
    (c) PP serving: ``Synthesizer(decode_pipelined=True, mesh=Mesh([[cuda:0]
    * 5]))``, one request at 1 microbatch and a batch of two at 2 (and,
    where there are two GPUs or more, one request over the GPUs in turn):
    the mel within 1e-5 of the unpipelined eager decode's, the wav through
    K1 and K2-bf16 (launch counts set to 0 just before and read just
    after), the pipelined decode's time beside the graph decode's. (d)
    ``tools/dryrun_multichip.py``'s three checks (DP x TP, SP, DP x PP on
    four ranks: gloo on ``cuda:0``, or NCCL over four GPUs).
14. The model's remaining config switches and the ESPnet transformer
    suite, about 50 s: (a) the variant of ``variant_config`` (each switch
    the flagship sets away from JAX's default at JAX's default, and the
    energy branch) at the flagship's widths, its duration head biased to
    10 frames per phone, serving three two-phase requests of 64 phones and
    a 32-token prompt (640 frames): the walls, RTF and a device-time
    profile, K1 once and K2-bf16 72 times per request (counts set to 0
    just before and read just after), the graph decode against the eager
    decode bit for bit, and its ``infer_cond`` on the card against the
    CPU's within 1e-4 of the largest magnitude; (b) one update of the
    variant (dropout rates 0, the diffusion steps and noise given, the
    learning rate at its peak from the first update) on the largest
    ``max_tokens=10000`` batch of a synthetic training corpus under
    ``build/chip_smoke/variant/``, on the card and on the CPU from the same
    weights: the losses, ``energy`` included, and grad_norm at phase 10
    (a)'s bars, the parameters after it within a tenth of what the update
    moved them (L2, as phase 12 holds them), the card's update time; (c)
    the ESPnet suite at its modules' default widths (attention_dim 256, 4
    heads, linear_units 2048, 6 blocks), batch 8:
    ``TransformerEncoder`` (conv2d) on 80-dim features of 1,000 frames,
    ``Decoder`` with each of ``selfattn``, ``lightconv``, ``lightconv2d``,
    ``dynamicconv`` and ``dynamicconv2d`` over its output on 101 target
    tokens, and 20 steps of ``forward_one_step`` each, every output on the
    card against the CPU's within 1e-4 of the largest magnitude, and each
    module's time. None of these modules holds a hand-written kernel; the
    requests of (a) launch K1 and K2-bf16 through the vocoder.
15. The experimental nets and the data-prep command line, under 60 s:
    each net built from a seed, its weights and injected inputs the same
    on the card and on the CPU, in float32 without TF32 (the samplers
    and Glow set it themselves and run with TF32 switched on, so that the
    comparison holds their setting), at the widths of the published model
    it comes from (``AUX``): ``ConvNeXt1d`` (256
    channels, 1024 hidden, 8 layers), ``MRFNet`` (HiFi-GAN's kernels 3, 7,
    11 and dilations 1, 3, 5 at 256 channels, with ``g``), the local
    ``Conformer`` (4 layers, 256 channels, 2 heads, kernel 7, with and
    without ``g``), the VITS ``Transformer`` (VITS's text encoder: 192
    channels, 2 heads, 6 layers, relative with window 4 and absolute),
    ``Unet1d`` (Grad-TTS's estimator: dim 64, mults 1, 2, 4, 80 mels, the
    conditioning at the flagship encoder's 256 channels), ``Glow`` on a
    [2, 1, 256] style vector (256 channels, 4 flows, 2 blocks; its reverse
    of its forward must return z within 1e-4 on the card),
    ``GaussianDiffusionCFG`` over ``DiffNetG`` at its JAX defaults with a
    256-wide style vector and guidance 2.0 (a training forward, 100
    ancestral steps and PLMS-10 from an injected x_T without noise),
    ``CNF`` around the U-Net (a training forward, 10 Euler and 10 RK4
    steps with guidance) and ``ScoreSDE`` around a U-Net conditioned on
    the mel prior (its loss and 50 RK4 steps), on batch 2 of 640 frames:
    a forward within 1e-5 of the largest magnitude of the CPU's, a sampled
    output within 1e-4; the card's CUDA-event time per call, its peak
    memory, the parameter count and the CPU's time. Then
    ``data_prep/compute_utt_stats.py`` over a raw tree of 8 utterances of
    2-6 s with YIN on the card and on the CPU: every statistic within one
    rounding step (0.0101), the F0 tracks at phase 11's bars. No kernel
    lies on this path: the launch counts are set to 0 before the phase and
    read (all 0) after it.
16. Print the ``kernels`` JSON line, the GPU line and the result line.

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

import contextlib
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
# phase 10 (d): the bf16 step on the card against the CPU's, at the bars of
# tests/test_torch_train_bf16.py (losses absolute, grad_norm relative); the
# corpus of the four settings' epochs (about 12 updates each), two turns
# (the settings in order, then reversed), the first profiled update
TRAIN_BF16_LOSS_ATOL, TRAIN_BF16_GRAD_NORM_RTOL = 1.5e-3, 2e-3
TRAIN_D_UTTS, TRAIN_D_PROFILE_STEP = 340, 3
# phase 11: the preprocessing shape of conf/preprocess.yaml (batch 16 of
# 3-15 s utterances at 24 kHz, 2-s sample buckets), the raw corpus of the
# recipe (utterances per training speaker; the eval speaker 121 of
# conf/preprocess.yaml with 3-9 s utterances) and alternated timing turns
RECIPE_BATCH, RECIPE_SECONDS, RECIPE_TURNS = 16, (3.0, 15.0), 3
RECIPE_TRAIN_SPEAKERS = {19: 8, 100: 8, 1001: 8, 26: 8, 103: 8}
RECIPE_EVAL_SPEAKERS, RECIPE_EVAL_SECONDS = {121: 2}, (3.0, 9.0)
# the card's YIN and mel against the port's CPU path: the bars of
# tests/test_torch_f0.py and tests/test_torch_preprocess.py
RECIPE_VUV_AGREEMENT, RECIPE_F0_RTOL, RECIPE_MEL_ATOL = 0.995, 1e-3, 1e-4
# phase 12: fixed batches of PARALLEL_BATCH rows (the config's
# train.batch_size, conf/train/noam.yaml; it divides by 2 and 4 ranks),
# PARALLEL_UPDATES of them (one epoch), 2 gloo ranks. The updates run at
# the config's peak rate (optimizer.lr 1e-3) from the first
# (PARALLEL_WARMUP), so AdamW moves the parameters by up to about 3e-3.
# Against one process on the same global batches:
# - the first update (the same parameters enter it) computes the global
#   step: its losses and grad_norm within 1e-5 relative, its gradient
#   within 0.1 relative (L2) in every tensor. The sums run in another
#   order, and a ReLU input that rounding puts on the other side of 0
#   passes another gradient back (one such element on the CPU moved the
#   tiny model's gradient by 3e-3 in the worst tensor, 9e-4 in all); a
#   BatchNorm backward that skipped its all-reduce moved 3 tensors by 1.5
#   and grad_norm by only 9e-6. A tensor whose gradient is 0 but for
#   rounding (an attention's key bias: the softmax ignores a constant per
#   query) is held relative to 1e-6 of the whole gradient's norm;
# - the later updates and the parameters: AdamW's first steps are about
#   lr whatever a gradient element's size, so an element near 0 that
#   rounding moves across 0 steps its parameter the other way (the later
#   losses within 1e-2 relative; the parameters' and statistics'
#   difference under a tenth of what the updates moved them, L2)
PARALLEL_BATCH, PARALLEL_UPDATES, GLOO_RANKS = 32, 3, 2
PARALLEL_WARMUP = "train.lr_scheduler.warmup_steps=1"
PARALLEL_LOSS_RTOL, PARALLEL_LATER_RTOL = 1e-5, 1e-2
PARALLEL_GRAD_RTOL, PARALLEL_GRAD_FLOOR, PARALLEL_PARAM_RTOL = 0.1, 1e-6, 0.1
# the sharded decode's mel against the unsharded eager decode's; timed
# turns
SHARDED_MEL_ATOL, PARALLEL_TURNS = 1e-5, 3
# the train CLI in this process, timed from here: on a machine with more
# than one GPU it would otherwise spawn one worker per GPU
ONE_PROCESS = "+train.distributed.num_processes=1"
# phase 13: TP over 2 ranks at phase 12's batches; PP of the DiffNet's 20
# blocks in 5 stages of one dilation cycle (4 blocks), 5 microbatches of 6
# rows (30: the multiple of 5 nearest the config's 32), PP_UPDATES
# updates; the serving mesh's stages
TP_RANKS, PP_STAGES, PP_MICRO, PP_BATCH, PP_UPDATES = 2, 5, 5, 30, 10
# the model group's all-reduces in a TP update's forward and backward: one
# after each row product (4 conformer blocks x 3, 12 BERT layers x 2, 20
# DiffNet blocks and mlp.2, the GST's linear_out: 58), the adaptor's gather
# (1), and one in the backward per distinct input of the column products
# that takes a gradient (4 conformer blocks x (q|k|v + 2 w_1), the GST's
# query and k|v, 20 dilated_conv and one cond for every conditioner
# projection, adaptor.0, the last BERT layer's intermediate.dense: 37)
TP_ALLREDUCES = 96
# phase 14: the variant (``variant_config``) against the CPU, relative to
# the largest magnitude; the ESPnet suite at its modules' default widths
# (ESPnet's: attention_dim 256, 4 heads, linear_units 2048, 6 blocks):
# the batch, the encoder's input frames and features, the decoder's
# target tokens and its one-step decoding steps, and the decoders'
# self-attention types. The variant's update runs at the peak rate from
# the first step, so AdamW moves every parameter with a gradient by about
# lr = 1e-3 and the update is held as phase 12's are (PARALLEL_PARAM_RTOL
# of its L2 norm): an update that skipped the optimizer or stepped the
# wrong way misses by 1 or 2 of it
VARIANT_RTOL = 1e-4
ESP_BATCH, ESP_FRAMES, ESP_FEATS, ESP_TOKENS, ESP_STEPS = 8, 1000, 80, 100, 20
ESP_VOCAB = 500
ESP_DECODERS = ("selfattn", "lightconv", "lightconv2d", "dynamicconv",
                "dynamicconv2d")
# the convolutions' kernel per decoder block (ESPnet reads one size per
# block from the string, so its one-entry default fits one block only)
ESP_CONV_KERNELS = "11_13_15_17_19_21"
# the corpus of the variant's update: enough rows for one max_tokens batch
VARIANT_UTTS = 80


# phase 15: the experimental nets at the widths of the published models
# they come from (or the flagship's), on a 640-frame request of batch 2;
# the conditioning at the flagship encoder's 256 channels, a style vector
# at its style width (phoneme_embedding.channels); and compute_utt_stats
# over a raw tree of 8 utterances of 2-6 s. A CPU rehearsal shrinks these
# with mock.patch.dict.
AUX = dict(
    batch=2, frames=640, mels=80, cond=256, style=256,
    convnext=(256, 1024, 8),            # channels, hidden, layers
    mrf=(256, (3, 7, 11), (1, 3, 5)),   # HiFi-GAN's MRF
    conformer=(4, 256, 2, 7),           # layers, channels, heads, kernel
    vits=(192, 2, 6, 3, 4, 4),          # VITS's text encoder
    unet_dim=64,                        # Grad-TTS's estimator, (1, 2, 4)
    glow=(256, 4, 2),                   # channels, flows, blocks
    diffnet=(256, 20, 256, 4),          # DiffNetG's JAX defaults
    anc_steps=100, plms=10, cnf_steps=10, sde_steps=50,
    utts=8, seconds=(2.0, 6.0))
# card against CPU: one forward within 1e-5 of the largest magnitude, a
# sampled mel within 1e-4; Glow's reverse of its forward returns z within
# 1e-4 on the card
AUX_FORWARD_RTOL, AUX_SAMPLE_RTOL, GLOW_INVERSE_ATOL = 1e-5, 1e-4, 1e-4
AUX_SPEAKERS = (19, 100, 1001, 26)  # in metadata/libritts_r_f0_stats.yaml
# compute_utt_stats rounds each statistic to 2 decimals: YIN on the card
# may move one by a rounding step
UTT_STATS_ATOL = 0.0101


def energy_branch(va):
    """The energy predictor and embedding of a variance adaptor config
    ``va``, as JAX's aliases build them (``Predictor``; ``torch.nn.Conv1d``
    -> ``PitchEmb``): the pitch predictor's widths with one output, and a
    1x1 Conv1d 1 -> C like the pitch embedding."""
    return dict(energy_predictor=dict(va["pitch_predictor"], out_channels=1),
                energy_emb=dict(va["pitch_emb"]))


def variant_config(model_cfg):
    """``model_cfg`` with each switch the flagship sets away from JAX's
    default at JAX's default, and the energy branch: style vectors not
    normalized, both MDN heads in the training dtype (``mdn_disable_amp``
    false, as the YAML's interpolation gives the duration head), the
    phoneme embedding scaled by sqrt(C), the conformer at JAX's
    ``ConformerEncoder`` defaults at the config's widths (its switch keys
    left out: Linear FFN, absolute positions, plain attention, no macaron,
    no conv module), one GMM of diagonal components in the style MDN, and
    ``energy_branch``."""
    import copy

    cfg = copy.deepcopy(model_cfg)
    cfg.update(norm_style_emb=False, mdn_disable_amp=False)
    cfg["phoneme_embedding"]["do_scale"] = True
    for key in ("positionwise_layer_type", "positionwise_conv_kernel_size",
                "pos_enc_layer_type", "selfattention_layer_type",
                "macaron_style", "use_cnn_module", "cnn_module_kernel",
                "rel_pos_type"):
        cfg["encoder"].pop(key, None)
    cfg["style_mdn"]["dim_wise"] = False
    va = cfg["variance_adaptor"]
    va["duration_predictor"]["disable_amp"] = False
    va.update(energy_branch(va))
    return cfg


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
        reports = _build.build((*_build.KERNELS, *_build.HOST_LIBRARIES))
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
    seqs, prompts = request_inputs()
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
    phase_train_options(k1, k2, vocoder, dev, gpu, failures)

    # -- phase 11: the recipe ------------------------------------------------
    print(f"phase 11 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase_recipe(k1, k2, vocoder, dev, gpu, failures)

    # -- phase 12: parallelism -------------------------------------------------
    print(f"phase 12 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase_parallel(k1, k2, model, vocoder, seqs, prompts, dev, gpu, failures)

    # -- phase 13: the model axis ----------------------------------------------
    print(f"phase 13 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    piped = phase_model_axis(k1, k2, model, vocoder, seqs, prompts, dev,
                             gpu, failures)

    # -- phase 14: the model's remaining switches, the ESPnet suite ---------
    print(f"phase 14 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    del model
    torch.cuda.empty_cache()
    variant = phase_variant(k1, k2, vocoder, dev, gpu, failures)

    # -- phase 15: the experimental nets, the data-prep command line ------
    print(f"phase 15 starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    aux = phase_aux_nets(k1, k2, dev, gpu, failures)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    per_request = f"sum over the 36 AMPLayers of one {FRAMES}-frame request"
    kernels = [
        dict(name="antialias_snake", route="cuda",
             source="promptttspp_tpu_torch/csrc/antialias_snake.cu",
             replaces="promptttspp_tpu/ops/pallas/snake.py:248",
             launches=launches["antialias_snake"], max_abs_err=k1_err,
             launches_pipelined_request=piped["antialias_snake"],
             launches_variant_requests=variant["antialias_snake"],
             launches_aux_nets=aux["antialias_snake"],
             ms=k1_row["ms"], plain_ms=k1_row["plain_ms"],
             bound_ms=k1_row["bound_ms"], bound_by=k1_row["bound_by"],
             library_ms=None, shape=k1_row["shape"]),
        dict(name="amp_layer_bf16", route="cuda",
             source="promptttspp_tpu_torch/csrc/amp_layer_wgmma.cu",
             replaces="promptttspp_tpu/ops/pallas/amp.py:332",
             launches=launches["amp_layer_bf16"],
             launches_pipelined_request=piped["amp_layer_bf16"],
             launches_variant_requests=variant["amp_layer_bf16"],
             launches_aux_nets=aux["amp_layer_bf16"],
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
    with tf32_on(), mock.patch.object(diffusion, "float32_math",
                                      contextlib.nullcontext):
        tf32_ms = decode_ms(tf32)
        g = torch.Generator(device=dev).manual_seed(0)
        mel_tf32 = decode_graph.decode(tf32, cond, generator=g)
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


def _no_dropout(model_cfg, bert_config):
    """-> (model config, BERT config) with every dropout rate 0."""
    import copy
    import dataclasses

    cfg0 = copy.deepcopy(model_cfg)
    cfg0["encoder"].update(dropout_rate=0.0, positional_dropout_rate=0.0)
    va = cfg0["variance_adaptor"]
    for name in ("duration_predictor", "pitch_predictor",
                 "energy_predictor"):
        if va.get(name) is not None:
            va[name]["dropout"] = 0.0
    va["frame_prior_network"].update(p_dropout=0.0, pos_enc_p_dropout=0.0)
    return cfg0, dataclasses.replace(bert_config, hidden_dropout=0.0,
                                     attention_dropout=0.0)


def phase_train(k1, k2, vocoder, dev, gpu, failures, model_cfg=None,
                bert_config=None, train_overrides=(), synth_overrides=()):
    """Training on the card (see phase 10 of the module docstring).
    ``model_cfg`` (default the flagship's), ``bert_config`` (default
    bert-base) and the overrides appended to the train and synthesize
    CLIs' command lines exist to rehearse the phase at a smaller size."""
    import copy
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
    cfg0, bert0 = _no_dropout(model_cfg, bert_config)
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
            f"+train.profile_steps={PROFILE_STEP}", ONE_PROCESS,
            *train_overrides]
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


def phase_train_options(k1, k2, vocoder, dev, gpu, failures, model_cfg=None,
                        bert_config=None, train_overrides=(),
                        synth_overrides=()):
    """Training's options on the card (see phase 10 (d) of the module
    docstring); the arguments as ``phase_train``'s."""
    import copy
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

    # (d) one float32 and one bf16 step on the card, a bf16 step on the CPU
    cfg0, bert0 = _no_dropout(model_cfg, bert_config)
    cpu = flagship.build_model(cfg0, "cpu", seed=3, bert_config=bert0)
    batch = train_batch(np.random.RandomState(4), [24, 17], mel_dim)
    outs, peaks, walls = {}, {}, {}
    for name, d, bf16 in (("card float32", dev, False),
                          ("card bf16", dev, True), ("CPU bf16", "cpu", True)):
        model = copy.deepcopy(cpu).to(d) if d == dev else cpu
        if d == dev:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state = TrainState(model, seed=0, bf16=bf16)
        tb = {k: torch.from_numpy(np.asarray(v)).to(d)
              for k, v in batch.items()}
        t0 = time.perf_counter()
        outs[name] = {k: v.item() for k, v in state.train_step(tb).items()}
        walls[name] = time.perf_counter() - t0
        if d == dev:
            peaks[name] = torch.cuda.max_memory_allocated()
            dtypes = ({p.dtype for p in model.parameters()},
                      {p.dtype for p in state.shadow.parameters()}
                      if bf16 else None)
            if dtypes[0] != {torch.float32} or \
                    dtypes[1] not in (None, {torch.bfloat16}):
                failures.append(f"{name} step: parameter dtypes {dtypes}")
        del model, state
        torch.cuda.empty_cache()
    got, ref = outs["card bf16"], outs["CPU bf16"]
    finite = all(np.isfinite(v) for o in outs.values() for v in o.values())
    loss_diff = max(abs(got[k] - ref[k]) for k in got if k != "grad_norm")
    norm_diff = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    for name, o in outs.items():
        print(f"[{gpu}] phase 10 (d): one flagship train step, {name}, "
              f"batch {list(batch['mel'].shape)}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in o.items())
              + (f"; peak memory allocated {peaks[name] / 2**30:.2f} GiB"
                 if name in peaks else "")
              + f"; step wall {walls[name]:.2f} s (the first)", flush=True)
    print(f"phase 10 (d): the card's bf16 step against the CPU's: largest "
          f"loss difference {loss_diff:.3g} (bar {TRAIN_BF16_LOSS_ATOL}), "
          f"grad_norm {norm_diff:.3g} relative (bar "
          f"{TRAIN_BF16_GRAD_NORM_RTOL})", flush=True)
    if not finite or not loss_diff <= TRAIN_BF16_LOSS_ATOL \
            or not norm_diff <= TRAIN_BF16_GRAD_NORM_RTOL:
        failures.append(f"bf16 train step card vs CPU: finite {finite}, "
                        f"losses {loss_diff:.3g}, grad_norm {norm_diff:.3g}")
    del cpu
    print(f"phase 10 (d): the steps took {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)

    # the four settings of the train CLI, in two turns
    root = OUT_DIR / "train_options"
    shutil.rmtree(root, ignore_errors=True)
    meta = ROOT / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    rows = training_rows(TRAIN_D_UTTS, cands, spk, TRAIN_PHONES, TRAIN_FPP,
                         valid_every=40, seed=7)
    eval_rows = [dict(spk_id=r["spk_id"], item_name=f"eval_{i}",
                      seq=r["seq"][:24], style_prompt_key=r[
                          "style_prompt_key"])
                 for i, r in enumerate(rows[:1])]
    write_corpus(root, eval_rows, cands, wav_seconds=3.0, mel_mean=-5.0,
                 mel_std=2.0)
    write_training_corpus(root, rows, cands, spk, n_mels=mel_dim,
                          mel_mean=-5.0, mel_std=2.0, seed=8)
    settings = {"sync": ["+train.input_pipeline=sync"],
                "prefetch": ["+train.input_pipeline=prefetch"],
                "sync_native": ["+train.input_pipeline=sync_native"],
                "prefetch bf16": ["+train.input_pipeline=prefetch",
                                  "train.bf16=true"]}
    turns = list(settings) + list(settings)[::-1]
    served = max(i for i, n in enumerate(turns) if n == "prefetch bf16")
    step_fn = TrainState.train_step
    runs = {name: [] for name in settings}
    cwd = os.getcwd()
    first = TRAIN_D_PROFILE_STEP
    for turn, name in enumerate(turns):
        starts, losses, frames, sums = [], [], [], []

        def timed_step(self, b):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            frames.append(b["frame_lengths"])
            sums.append(torch.stack([b[k].double().sum() for k in sorted(b)]))
            out = step_fn(self, b)
            losses.append(torch.stack(list(out.values())))
            return out

        out_dir = root / f"out_{turn}"
        # seeded prompt draws, so every run sees the same batches; the
        # second turn profiles (reading a profile takes seconds)
        profiled = turn >= len(settings)
        argv = [f"path.root={root}", f"output_dir={out_dir}",
                f"hydra.run.dir={root / 'run'}", "train.num_epochs=1",
                f"dataset.max_tokens={MAX_TOKENS}", "+dataset.train.seed=1",
                "+dataset.valid.seed=2", ONE_PROCESS, *settings[name],
                *train_overrides]
        if profiled:
            argv.append(f"+train.profile_steps={first}")
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
        step_ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:]
                                                     + [end])]
        # the warm-up and the profiled updates out, and the last, whose
        # interval holds the end of the epoch (validation, checkpoint)
        keep = range(first + 3 if profiled else TRAIN_WARMUP,
                     len(step_ms) - 1)
        runs[name].append(dict(
            ms=[step_ms[i] for i in keep],
            frames=sum(int(frames[i].sum()) for i in keep),
            peak=torch.cuda.max_memory_allocated(), wall=wall,
            busy=profile_busy(trainer.profile, trainer.profile_wall_s)
            if profiled else None,
            losses=torch.stack(losses).cpu(),
            sums=torch.stack(sums).cpu(), ckpt=out_dir / "ckpt/last"))
        print(f"phase 10 (d): turn {turn}, {name}: {len(step_ms)} updates, "
              f"{wall:.1f} s in all" + (f"; {runs[name][-1]['busy']}"
                                       if profiled else ""), flush=True)
        del trainer
        if turn != served:  # 1.3 GB of checkpoint each
            shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()

    ref = runs["sync"][0]
    for name, rs in runs.items():
        ms = [m for r in rs for m in r["ms"]]
        fps = sum(r["frames"] for r in rs) / (sum(ms) / 1e3)
        vals = torch.cat([r["losses"] for r in rs])
        print(f"[{gpu}] phase 10 (d): {name}: update time median "
              f"{np.median(ms):.1f} ms over {len(ms)} updates of 2 turns "
              f"(min {min(ms):.1f}, max {max(ms):.1f}), {fps:.0f} frames/s "
              f"({sum(r['frames'] for r in rs)} frames in {sum(ms):.1f} "
              "ms); peak memory allocated "
              + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in rs)
              + " GiB; " + rs[-1]["busy"]
              + f"; loss first {vals[0][0]:.4f}, last {vals[-1][0]:.4f}",
              flush=True)
        for r in rs:
            if not torch.equal(r["sums"], ref["sums"]):
                failures.append(f"train CLI {name}: its device batches' "
                                "checksums differ from sync's")
            if not bool(torch.isfinite(r["losses"]).all()):
                failures.append(f"train CLI {name}: a loss is not finite")
            if "bf16" not in name and not torch.equal(r["losses"][0],
                                                      ref["losses"][0]):
                failures.append(f"train CLI {name}: first-update losses "
                                f"{r['losses'][0].tolist()} != sync's "
                                f"{ref['losses'][0].tolist()}")
    print(f"phase 10 (d): {len(ref['sums'])} updates per epoch; batch "
          "checksums and first-update losses held against sync's (failures "
          "below if any)", flush=True)

    print(f"phase 10 (d): the train CLI's runs done at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # the bf16 ckpt/last served by the synthesize CLI
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    wavs = root / "wavs"
    _zero_counts(k1, k2)
    try:
        synth_cli.main([
            f"path.root={root}",
            f"model_ckpt={runs['prefetch bf16'][-1]['ckpt']}",
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
    print(f"[{gpu}] phase 10 (d): the bf16-trained ckpt/last served by the "
          f"synthesize CLI: wav lengths {lengths}; 2 requests, launches "
          f"{launches} (expected {expect})", flush=True)
    if launches != expect:
        failures.append(f"bf16-trained checkpoint: launch counts {launches}"
                        f" != {expect}")
    if len(files) != 2 or not all(lengths):
        failures.append(f"bf16-trained checkpoint: wavs {files} {lengths}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 10 (d): {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)


def recipe_batch(stats, seed=11):
    """Phase 11's batch: ``RECIPE_BATCH`` rows of 3-15 s (the first 15 s)
    zero-padded to one 2-s bucket, speech-like rows of the first speakers
    of the F0 stats at their ``f0_center`` (±10%), a row of noise and a
    silent row -> (wav [B, Ts] float32, seconds [B], floors, ceilings)."""
    import numpy as np

    from promptttspp_tpu_torch.data.batching import bucket_shape
    from promptttspp_tpu_torch.tools.synthetic_corpus import speech_like

    rng = np.random.RandomState(seed)
    spks = sorted(stats, key=int)[:RECIPE_BATCH]
    secs = rng.uniform(*RECIPE_SECONDS, RECIPE_BATCH)
    secs[0] = RECIPE_SECONDS[1]
    n = (secs * 24000).astype(int)
    wav = np.zeros((RECIPE_BATCH, bucket_shape(int(n.max()), 48000)),
                   np.float32)
    for i, spk in enumerate(spks[:-2]):
        wav[i, :n[i]] = speech_like(secs[i], stats[spk]["f0_center"]
                                    * rng.uniform(0.9, 1.1), seed=seed + i)
    wav[-2, :n[-2]] = 0.1 * rng.randn(n[-2])
    lo = np.asarray([stats[s]["f0_floor"] for s in spks], np.float32)
    hi = np.asarray([stats[s]["f0_ceil"] for s in spks], np.float32)
    return wav, secs, lo, hi


def _f0_agreement(f0_a, vuv_a, f0_b, vuv_b):
    """(voicing agreement, largest relative F0 error on frames both
    voice)."""
    import numpy as np

    both = (vuv_a > 0) & (vuv_b > 0)
    rel = np.abs(f0_a[both] - f0_b[both]) / f0_b[both]
    return float((vuv_a == vuv_b).mean()), float(rel.max(initial=0.0))


def phase_recipe(k1, k2, vocoder, dev, gpu, failures, cli_overrides=(),
                 model_overrides=(), synth_overrides=()):
    """The recipe on the card (see phase 11 of the module docstring).
    The overrides appended to the CLIs' command lines (``cli_overrides`` to
    every CLI, ``model_overrides`` to the train, synthesize and eval CLIs,
    ``synth_overrides`` to the last two) exist to rehearse the phase at a
    smaller size."""
    import os
    import shutil

    import numpy as np
    import torch
    from scipy.io import wavfile

    from promptttspp_tpu_torch.bin import compute_mel, filter_eval
    from promptttspp_tpu_torch.bin import eval as eval_cli
    from promptttspp_tpu_torch.bin import preprocess, split_df
    from promptttspp_tpu_torch.bin import synthesize as synth_cli
    from promptttspp_tpu_torch.bin import train as train_cli
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
    from promptttspp_tpu_torch.data import yaml_lite
    from promptttspp_tpu_torch.data.dataset import (
        read_prompt_candidate, read_spk_prompt_candidate)
    from promptttspp_tpu_torch.data_prep.stats import compute_utt_stats
    from promptttspp_tpu_torch.ops.f0 import extract_f0
    from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
    from promptttspp_tpu_torch.preprocess.pipeline import (
        BatchedFeatureExtractor, read_wav)
    from promptttspp_tpu_torch.preprocess.world_f0 import fix_f0_contour
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        raw_rows, raw_textgrid, write_raw_corpus)

    t_phase = time.perf_counter()
    root = OUT_DIR / "recipe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    f0_stats_file = ROOT / "metadata/libritts_r_f0_stats.yaml"
    stats = yaml_lite.load(f0_stats_file)
    to_mel = MelSpectrogramTransform()

    # (a) YIN and the mel on the card against the CPU
    wav, secs, lo, hi = recipe_batch(stats)
    B, Ts = wav.shape

    def features(device):
        w = torch.from_numpy(wav).to(device)
        with torch.inference_mode():
            f0, vuv = extract_f0(w, f0_floor=torch.from_numpy(lo).to(device),
                                 f0_ceil=torch.from_numpy(hi).to(device))
            mel = to_mel(w)
        return f0.cpu().numpy(), vuv.cpu().numpy(), mel.cpu().numpy()

    t0 = time.perf_counter()
    f0_c, vuv_c, mel_c = features("cpu")
    cpu_s = time.perf_counter() - t0
    f0_g, vuv_g, mel_g = features(dev)
    agree, f0_err = _f0_agreement(f0_g, vuv_g, f0_c, vuv_c)
    mel_err = float(np.abs(mel_g - mel_c).max())
    print(f"[{gpu}] phase 11 (a): YIN + mel of {B} utterances of "
          f"{secs.min():.1f}-{secs.max():.1f} s in a {Ts / 24000:.0f}-s "
          f"bucket [{B}, {Ts}] (f0 {list(f0_g.shape)}, mel "
          f"{list(mel_g.shape)}), card vs the port's CPU path: voicing "
          f"agreement {agree:.6f} (bar {RECIPE_VUV_AGREEMENT}; voiced "
          f"{vuv_g.mean():.3f} card, {vuv_c.mean():.3f} CPU), largest "
          f"relative F0 error on frames both voice {f0_err:.3g} (bar "
          f"{RECIPE_F0_RTOL}), mel max abs err {mel_err:.3g} (bar "
          f"{RECIPE_MEL_ATOL}); silent row voiced {int(vuv_g[-1].sum())} "
          f"frames, noise row {int(vuv_g[-2].sum())}; CPU path "
          f"{cpu_s:.2f} s", flush=True)
    if not (agree >= RECIPE_VUV_AGREEMENT and f0_err <= RECIPE_F0_RTOL
            and mel_err <= RECIPE_MEL_ATOL and not vuv_g[-1].any()):
        failures.append(f"recipe YIN/mel card vs CPU: voicing {agree}, F0 "
                        f"{f0_err}, mel {mel_err}, silent row "
                        f"{vuv_g[-1].sum()}")
    tg = root / "utt.TextGrid"
    tg.write_text(raw_textgrid(secs[0], np.random.RandomState(0)))
    utt = {d: compute_utt_stats(wav[0, :int(secs[0] * 24000)], 24000, tg,
                                device=d) for d in ("cpu", dev)}
    diff = max(abs(utt[dev][k] - v) for k, v in utt["cpu"].items())
    print(f"[{gpu}] phase 11 (a): compute_utt_stats of a {secs[0]:.0f}-s "
          f"utterance (YIN at a 5-ms hop): card {utt[dev]}; largest "
          f"difference from the CPU {diff:.3g} (2-decimal rounding: bar "
          f"0.0101)", flush=True)
    if not diff <= 0.0101:
        failures.append(f"compute_utt_stats card vs CPU: {utt}")

    # (b) one bucket in alternated turns: the device pass alone, then the
    # whole bucket from files to files
    extractor = BatchedFeatureExtractor(device=dev)
    bench = root / "bench"
    bench.mkdir()
    lens = (secs * 24000).astype(int)
    for i in range(B):
        wavfile.write(bench / f"{i}.wav", 24000,
                      np.round(wav[i, :lens[i]] * 32767).astype(np.int16))
    w_dev = torch.from_numpy(wav).to(dev)
    lo_dev, hi_dev = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(
        dev)
    dev_ms, walls, reads, fixes, writes, peaks = [], [], [], [], [], []
    for _ in range(RECIPE_TURNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            f0_d, _ = extract_f0(w_dev, f0_floor=lo_dev, f0_ceil=hi_dev)
            to_mel(w_dev)
            end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated() - base)
        rows = f0_d.cpu().numpy()
        t0 = time.perf_counter()
        for i, row in enumerate(rows):
            fix_f0_contour(row, float(lo[i]), float(hi[i]))
        fixes.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        wavs = [read_wav(bench / f"{i}.wav")[0].astype(np.float32)
                for i in range(B)]
        t1 = time.perf_counter()
        feats = extractor(wavs, lo, hi)
        t2 = time.perf_counter()
        for i, ft in enumerate(feats):
            for k in ("cf0", "vuv"):
                np.save(bench / f"{i}_{k}.npy", ft[k][None, :])
            np.save(bench / f"{i}_mel.npy", np.ascontiguousarray(ft["mel"].T))
        t3 = time.perf_counter()
        reads.append(t1 - t0)
        writes.append(t3 - t2)
        walls.append(t3 - t0)
    med = lambda v: float(np.median(v))  # noqa: E731
    print(f"[{gpu}] phase 11 (b): one bucket of {B} utterances "
          f"({secs.sum():.1f} s of audio), {RECIPE_TURNS} alternated turns: "
          f"device time of YIN + mel {med(dev_ms):.3f} ms (turns "
          f"{[round(v, 3) for v in dev_ms]}), peak memory above the inputs "
          f"{max(peaks) / 2**30:.3f} GiB; host: fix_f0_contour "
          f"{med(fixes) * 1e3:.1f} ms, {B} wav reads {med(reads) * 1e3:.1f} "
          f"ms, {3 * B} npy writes {med(writes) * 1e3:.1f} ms; the whole "
          f"bucket from files to files {med(walls) * 1e3:.1f} ms: "
          f"{B / med(walls):.1f} utterances/s, "
          f"{secs.sum() / med(walls):.1f} s of audio per second (the "
          f"device pass alone {secs.sum() / (med(dev_ms) / 1e3):.0f})",
          flush=True)
    del w_dev, f0_d, extractor
    torch.cuda.empty_cache()

    # (c) the CLIs on a raw corpus
    t0 = time.perf_counter()
    meta = ROOT / "metadata"
    prompts = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk_all = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    speakers = {**RECIPE_TRAIN_SPEAKERS, **RECIPE_EVAL_SPEAKERS}
    rows = raw_rows(RECIPE_TRAIN_SPEAKERS, prompts, RECIPE_SECONDS, stats,
                    seed=1) + raw_rows(RECIPE_EVAL_SPEAKERS, prompts,
                                       RECIPE_EVAL_SECONDS, stats, seed=2)
    corpus = root / "corpus"
    write_raw_corpus(corpus, rows, prompts,
                     {s: spk_all.get(s, ["calm", "clear"]) for s in speakers},
                     f0_stats_file=f0_stats_file, seed=3)
    audio_s = sum(r["seconds"] for r in rows)
    print(f"phase 11 (c): wrote {len(rows)} raw utterances ({audio_s:.1f} s "
          f"of audio) of speakers {sorted(speakers)} under {corpus} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cwd = os.getcwd()
    run_dir = f"hydra.run.dir={root / 'run'}"
    eval_ids = "eval_ids=[" + ",".join(map(str, RECIPE_EVAL_SPEAKERS)) + "]"
    args = [f"path.root={corpus}", eval_ids, run_dir, *cli_overrides]
    stage_s = {}
    try:
        for name, stage in (("preprocess", preprocess),
                            ("split_df", split_df),
                            ("compute_mel", compute_mel),
                            ("split_df again", split_df),
                            ("filter_eval", filter_eval)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage.main(args)
            torch.cuda.synchronize()
            stage_s[name] = round(time.perf_counter() - t0, 3)
            os.chdir(cwd)
        dump = corpus / "dump/libritts_r_per_spk_cleaned"
        n_rows = {f: len((dump / f).read_text().splitlines()) - 1 for f in (
            "df/data.csv", "df_filtered/trn.csv", "df_filtered/val.csv",
            "df_filtered/eval_filtered.csv")}
        print(f"[{gpu}] phase 11 (c): preprocess CLIs in {stage_s} s "
              f"(preprocess: {audio_s / stage_s['preprocess']:.1f} s of "
              f"audio per second); rows {n_rows}; stats.yaml "
              f"{yaml_lite.load(dump / 'mel63/stats.yaml')}", flush=True)
        if n_rows["df/data.csv"] != len(rows) or \
                not n_rows["df_filtered/eval_filtered.csv"]:
            failures.append(f"recipe preprocess: rows {n_rows}")

        out_dir = root / "out"
        t0 = time.perf_counter()
        trainer = train_cli.main([
            f"path.root={corpus}", f"output_dir={out_dir}", run_dir,
            "train.num_epochs=1", f"dataset.max_tokens={MAX_TOKENS}",
            ONE_PROCESS, *cli_overrides, *model_overrides])
        os.chdir(cwd)
        losses = (out_dir / "logs/loss.csv").read_text().splitlines()
        print(f"[{gpu}] phase 11 (c): train CLI, one epoch on the "
              f"preprocessed tree in {time.perf_counter() - t0:.1f} s: "
              f"{trainer.state.step} updates; loss.csv {losses}", flush=True)
        finite = all(np.isfinite(float(v)) for ln in losses[1:]
                     for v in ln.split(","))
        if trainer.state.step < 1 or not finite or \
                not (out_dir / "ckpt/last").exists():
            failures.append(f"recipe train: {trainer.state.step} updates, "
                            f"losses {losses}")
        del trainer
        torch.cuda.empty_cache()

        torch.save({"generator": to_reference_state_dict(
            vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
        n_eval = n_rows["df_filtered/eval_filtered.csv"]
        synth_args = [f"path.root={corpus}", f"output_dir={root / 'synth'}",
                      run_dir, f"num_eval_utts={n_eval}", *cli_overrides,
                      *model_overrides, *synth_overrides]
        _zero_counts(k1, k2)
        t0 = time.perf_counter()
        synth_cli.main(synth_args + [
            f"model_ckpt={out_dir / 'ckpt/last'}",
            f"vocoder_ckpt={root / 'vocoder.ckpt'}", "noise_scale=0"])
        os.chdir(cwd)
        launches = _counts(k1, k2)
        synth_s = time.perf_counter() - t0
        expect = {"antialias_snake": 2 * n_eval,
                  "amp_layer_bf16": 2 * 72 * n_eval, "amp_layer": 0,
                  "amp_block": 0}
        print(f"[{gpu}] phase 11 (c): synthesize CLI on ckpt/last for "
              f"{n_eval} eval_filtered utterances (ref + prompt) in "
              f"{synth_s:.1f} s; launches {launches} (expected {expect}: K1 "
              f"1 and K2-bf16 72 per request)", flush=True)
        if launches != expect:
            failures.append(f"recipe synthesize: launch counts {launches} "
                            f"!= {expect}")

        t0 = time.perf_counter()
        report = eval_cli.main(synth_args)
        os.chdir(cwd)
        means = {m: r["mean"] for m, r in report.items()}
        print(f"[{gpu}] phase 11 (c): eval CLI in "
              f"{time.perf_counter() - t0:.1f} s: "
              + json.dumps({m: {"n_utts": r["n_utts"], **r["mean"]}
                            for m, r in report.items()}), flush=True)
        per_utt = [u for r in report.values() for u in r["utts"]]
        if sorted(report) != ["prompt", "ref"] or len(per_utt) != 2 * n_eval \
                or not all(np.isfinite(u["mcd"]) and np.isfinite(u["mel_l1"])
                           for u in per_utt):
            failures.append(f"recipe eval: {means}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)


def _timed_train(argv):
    """``bin/train.py``'s ``main(argv)`` with CUDA events around each
    update (from its first launch to its last: the update's span on the
    card) and each gradient all-reduce -> its numbers, the model's state
    dict before the first update and after the last, and the first
    update's global gradient (all on the CPU)."""
    import os

    import numpy as np
    import torch

    from promptttspp_tpu_torch.bin import train as train_cli
    from promptttspp_tpu_torch.parallel import distributed
    from promptttspp_tpu_torch.parallel.distributed import DataGroup
    from promptttspp_tpu_torch.train.state import TrainState

    spans, losses, reduces, nbytes, keys = [], [], [], [], []
    init, grad, calls = {}, [], []
    # where an all-reduce is made: in the model's forward and backward
    # ("layers"), in the update's gradient sums and norm ("update"), or in
    # joining the first gradient for the comparison ("probe", not counted)
    where = ["layers"]
    step_fn, reduce_fn = TrainState.train_step, DataGroup.reduce_grads
    norm_fn, all_reduce_fn = TrainState._global_norm, distributed._all_reduce
    update_fn = TrainState._update

    def timed_step(self, b):
        if not spans:  # on the host, out of the peak memory
            init.update({k: v.detach().to("cpu", copy=True) for k, v in
                         self.model.state_dict().items()})
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        evs[0].record()
        out = step_fn(self, b)
        evs[1].record()
        spans.append(evs)
        losses.append(torch.stack(list(out.values())))
        keys[:] = list(out)
        return out

    def timed_reduce(self, grads, *a, **kw):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        evs[0].record()
        n = reduce_fn(self, grads, *a, **kw)
        evs[1].record()
        reduces.append(evs)
        nbytes.append(n)
        return n

    def update(self, step_losses):
        where[0] = "update"
        try:
            return update_fn(self, step_losses)
        finally:
            where[0] = "layers"

    def first_norm(self, tensors):
        # the gradient the clip and AdamW see: after the all-reduces, the
        # tensors sharded over a model group joined (a collective there)
        if not grad:
            shards = getattr(self.model, "tp_shards", None) or {}
            where[0] = "probe"
            grad.append([
                (self.model.tp_group.gather_dim(
                    t, shards[n].dim, shards[n].interleave)
                 if n in shards else t).detach().to("cpu", copy=True)
                for n, t in zip(self.trainable, tensors)])
            where[0] = "update"
        return norm_fn(self, tensors)

    def timed_all_reduce(x, group=None):
        # every all-reduce, with its group, update and place (the model
        # group's "layers" ones are TP's collectives in the forward and
        # backward, or the pipeline's)
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        evs[0].record()
        out = all_reduce_fn(x, group)
        evs[1].record()
        calls.append((len(spans), group, evs, x.numel() * x.element_size(),
                      where[0]))
        return out

    cwd = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(TrainState, "train_step", timed_step), \
                mock.patch.object(DataGroup, "reduce_grads", timed_reduce), \
                mock.patch.object(TrainState, "_global_norm", first_norm), \
                mock.patch.object(TrainState, "_update", update), \
                mock.patch.object(distributed, "_all_reduce",
                                  timed_all_reduce):
            trainer = train_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    group = getattr(trainer.model_group, "group", False)
    model_ms, model_bytes = [0.0] * len(spans), [0] * len(spans)
    model_calls = {"layers": [0] * len(spans), "update": [0] * len(spans)}
    for i, g, (a, b), n, at in calls:  # i: the update the call was in
        if g is group and i < len(spans) and at != "probe":
            model_ms[i] += a.elapsed_time(b)
            model_bytes[i] += n
            model_calls[at][i] += 1
    out = dict(
        model_allreduce_ms=model_ms, model_allreduce_bytes=model_bytes,
        model_allreduce_calls=model_calls,
        wall_s=time.perf_counter() - t0,
        update_ms=[a.elapsed_time(b) for a, b in spans],
        allreduce_ms=[a.elapsed_time(b) for a, b in reduces],
        allreduce_bytes=nbytes,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        losses=torch.stack(losses).cpu().numpy().tolist(), loss_keys=keys,
        device=str(trainer.device), world=trainer.world,
        tensors=dict(
            state_dict={k: v.detach().cpu().clone() for k, v in
                        trainer.state.model.state_dict().items()},
            init=init, grad=dict(zip(trainer.state.trainable, grad[0]))))
    out["finite"] = bool(np.isfinite(out["losses"]).all())
    del trainer, init, grad
    torch.cuda.empty_cache()
    return out


def _timed_train_in_group(argv):
    """``_timed_train`` in this process under torchrun's environment for a
    group of one rank (NCCL on the card)."""
    import os

    from promptttspp_tpu_torch.bin.train import free_port

    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _timed_train(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _train_rank(rank, world, backend, argv, address, out_dir):
    """One spawned rank of phase 12 (a): torchrun's environment, then
    ``_timed_train``; writes its numbers and parameters to ``out_dir``."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(rank % torch.cuda.device_count())
    host, port = address.rsplit(":", 1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR=host,
                      MASTER_PORT=port)
    stats = _timed_train([*argv, f"+train.distributed.backend={backend}",
                          f"+train.distributed.num_processes={world}"])
    torch.save(stats.pop("tensors"), Path(out_dir) / f"rank{rank}.pt")
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(stats))


def _spawn_ranks(world, backend, argv, out_dir):
    """``world`` ranks of ``_train_rank`` -> their numbers by rank, each
    with its ``tensors``."""
    import torch
    import torch.multiprocessing as mp

    from promptttspp_tpu_torch.bin.train import free_port

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    mp.start_processes(_train_rank, args=(
        world, backend, argv, f"localhost:{free_port()}", str(out_dir)),
        nprocs=world, join=True, start_method="spawn")
    return [dict(json.loads((Path(out_dir) / f"rank{r}.json").read_text()),
                 tensors=torch.load(Path(out_dir) / f"rank{r}.pt"))
            for r in range(world)]


def _param_gap(sd, ref, init=None):
    """The parameters and statistics ``sd`` against one process's ``ref``
    (both from ``init``): the largest difference and the L2 norm of the
    difference over the floating tensors, the largest magnitude in
    ``ref``, the L2 norm and the largest element of ``ref``'s update (ref
    - init; 0 without ``init``), and whether the other tensors are
    equal."""
    import torch

    out = dict(diff=0.0, l2=0.0, scale=0.0, update_l2=0.0, moved=0.0,
               exact=True)
    for k, v in ref.items():
        if v.is_floating_point():
            d = (sd[k] - v).double()
            u = (v - (v if init is None else init[k])).double()
            out["diff"] = max(out["diff"], float(d.abs().max()))
            out["l2"] += float(d.square().sum())
            out["scale"] = max(out["scale"], float(v.abs().max()))
            out["update_l2"] += float(u.square().sum())
            out["moved"] = max(out["moved"], float(u.abs().max()))
        else:
            out["exact"] &= bool(torch.equal(sd[k], v))
    out["l2"], out["update_l2"] = out["l2"] ** 0.5, out["update_l2"] ** 0.5
    return out


def _agreement(st, ref, ckpts=None, held=None):
    """Run ``st`` against one process's run ``ref`` on the same global
    batches -> (its gaps, the failures among them). ``ckpts``: the two
    runs' ``ckpt/last`` (whole files), whose parameters are compared in
    place of ``st``'s own (a model sharded over a model group holds
    slices). ``held``: the later-updates bar holds the first ``held``
    updates only (the rest are reported)."""
    import numpy as np
    import torch

    a, b = np.asarray(st["losses"]), np.asarray(ref["losses"])
    rel = np.abs(a - b) / np.abs(b) if a.shape == b.shape else \
        np.full((2, 1), np.inf)
    grad, grad_ref = st["tensors"]["grad"], ref["tensors"]["grad"]
    norm = lambda ts: float(torch.stack([t.norm() for t in ts]).norm())
    whole = norm(grad_ref.values())
    tensor_rel = sorted(((float((grad[k] - g).norm())
                          / (float(g.norm()) + PARALLEL_GRAD_FLOOR * whole),
                          k) for k, g in grad_ref.items()), reverse=True)
    grad_rel = tensor_rel[0][0]
    if ckpts is None:
        gap = _param_gap(st["tensors"]["state_dict"],
                         ref["tensors"]["state_dict"], ref["tensors"]["init"])
    else:
        gap = _param_gap(*(torch.load(c, weights_only=True)["model"]
                           for c in ckpts))
        gap["update_l2"] = _param_gap(
            ref["tensors"]["state_dict"], ref["tensors"]["state_dict"],
            ref["tensors"]["init"])["update_l2"]
    gap.update(first_rel=float(rel[0].max()),
               later_rel=float(rel[1:held].max()) if len(rel) > 1
               else 0.0,
               grad_rel=grad_rel, param_rel=gap["l2"] / gap["update_l2"],
               whole_grad_rel=norm(grad[k] - g for k, g in grad_ref.items())
               / whole, loss_rel=[float(r[0]) for r in rel],
               worst=[(ref["loss_keys"][int(np.argmax(r))], float(r.max()))
                      for r in rel], worst_tensors=tensor_rel[:3])
    bad = []
    if not gap["first_rel"] <= PARALLEL_LOSS_RTOL:
        bad.append(f"first update's losses and grad_norm "
                   f"{gap['first_rel']:.3g} relative")
    if not gap["later_rel"] <= PARALLEL_LATER_RTOL:
        bad.append(f"later updates' losses and grad_norm "
                   f"{gap['later_rel']:.3g} relative")
    if not grad_rel <= PARALLEL_GRAD_RTOL:
        bad.append(f"first-update gradient {grad_rel:.3g} relative")
    if not (gap["param_rel"] <= PARALLEL_PARAM_RTOL and gap["exact"]):
        bad.append(f"parameters {gap['l2']:.3g} against the update's "
                   f"{gap['update_l2']:.3g}, integers equal {gap['exact']}")
    return gap, bad


def _gap_text(gap):
    return (f"the first update's losses and grad_norm "
            f"{gap['first_rel']:.3g} relative (bar {PARALLEL_LOSS_RTOL}), the "
            f"later updates' {gap['later_rel']:.3g} (bar "
            f"{PARALLEL_LATER_RTOL}); the first update's gradient "
            f"{gap['grad_rel']:.3g} relative, L2, in its worst tensor (bar "
            f"{PARALLEL_GRAD_RTOL}; the worst three "
            + ", ".join(f"{k} {r:.3g}" for r, k in gap["worst_tensors"])
            + f"); parameters and statistics: L2 "
            f"{gap['l2']:.3g} from one process's against the updates' "
            f"{gap['update_l2']:.3g} ({gap['param_rel']:.3g}, bar "
            f"{PARALLEL_PARAM_RTOL}), largest difference {gap['diff']:.3g} "
            f"(largest value {gap['scale']:.3g}, largest change "
            f"{gap['moved']:.3g}); the worst loss or grad_norm per update "
            + str([f"{k} {r:.3g}" for k, r in gap["worst"]]))


def _train_line(gpu, label, st):
    import numpy as np

    red = (f"gradient all-reduce {np.median(st['allreduce_ms']):.3f} ms "
           f"median for {st['allreduce_bytes'][0] / 2**20:.1f} MiB"
           if st["allreduce_ms"] else "no gradient all-reduce")
    return (f"[{gpu}] phase 12 (a): {label} on {st['device']}: "
            f"{len(st['update_ms'])} updates, update ms "
            f"{[round(t, 1) for t in st['update_ms']]}, {red}, peak "
            f"{st['peak_gib']:.2f} GiB, losses finite {st['finite']}, "
            f"wall {st['wall_s']:.1f} s")


def phase_parallel(k1, k2, model, vocoder, seqs, prompts, dev, gpu,
                   failures, model_cfg=None, train_overrides=()):
    """Data-parallel training and frame-parallel serving on the card (see
    phase 12 of the module docstring). ``model_cfg`` (default the
    flagship's) and ``train_overrides`` exist to rehearse the phase at a
    smaller size."""
    import copy
    import os
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import train as train_cli
    from promptttspp_tpu_torch.data.dataset import (
        read_prompt_candidate, read_spk_prompt_candidate)
    from promptttspp_tpu_torch.infer import Synthesizer
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.parallel import make_mesh
    from promptttspp_tpu_torch.parallel.sp import decode_frames_sharded
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_training_corpus)
    from promptttspp_tpu_torch.vocoders.streaming import vocode_sharded

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    model_cfg = copy.deepcopy(model_cfg or flagship.MODEL)
    one_card = ("" if count > 1 else
                "; only one GPU is present, so NCCL runs at world size 1 "
                "and the multi-rank run is gloo's on cuda:0")

    # (a) three updates: one process, NCCL, two gloo ranks
    root = OUT_DIR / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    meta = ROOT / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    n_train = PARALLEL_BATCH * PARALLEL_UPDATES
    rows = training_rows(n_train + 2, cands, spk, TRAIN_PHONES, TRAIN_FPP,
                         valid_every=(n_train + 2) // 2, seed=12)
    write_training_corpus(root, rows, cands, spk,
                          n_mels=model_cfg["decoder"]["out_dim"],
                          mel_mean=-5.0, mel_std=2.0, seed=13)

    def argv(name):
        return [f"path.root={root}", f"output_dir={root / name}",
                f"hydra.run.dir={root / 'run'}", "train.num_epochs=1",
                "dataset.dynamic_batch=false",
                f"train.batch_size={PARALLEL_BATCH}", "train.seed=5",
                "+dataset.train.seed=1", "+dataset.valid.seed=2",
                "+train.input_pipeline=sync", PARALLEL_WARMUP,
                *train_overrides]

    # deterministic algorithms for the two runs held bit for bit: else
    # the backward's float atomics (index_add, cuDNN's weight gradients)
    # sum in another order in any two runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        single = _timed_train([*argv("single"), ONE_PROCESS])
        if count == 1:
            nccl = _timed_train_in_group(argv("nccl"))
    finally:
        torch.use_deterministic_algorithms(False)
    print(_train_line(gpu, "one process, no process group, deterministic "
                      "algorithms", single), flush=True)
    if len(single["update_ms"]) != PARALLEL_UPDATES or not single["finite"]:
        failures.append(f"phase 12 (a): {len(single['update_ms'])} updates, "
                        f"finite {single['finite']}")
    ref = single["tensors"]

    if count == 1:
        same = (nccl["losses"] == single["losses"]
                and all(torch.equal(nccl["tensors"][part][k], v)
                        for part in ("grad", "state_dict")
                        for k, v in ref[part].items()))
        print(_train_line(gpu, "NCCL, world size 1, in this process, "
                          "deterministic algorithms", nccl)
              + f"; losses, gradient and parameters equal the run without "
              f"a group bit for bit: {same}{one_card}", flush=True)
        if not same:
            failures.append("phase 12 (a): the NCCL step at world size 1 "
                            "differs from the step without a group")
        del nccl
    else:
        ranks = _spawn_ranks(count, "nccl", argv("nccl"), root / "nccl_out")
        for r, st in enumerate(ranks):
            print(_train_line(gpu, f"NCCL rank {r} of {count}", st),
                  flush=True)
        gap, bad = _agreement(ranks[0], single)
        print(f"[{gpu}] phase 12 (a): NCCL at world size {count}, rank 0 "
              f"against one process: {_gap_text(gap)}", flush=True)
        failures.extend(f"phase 12 (a): NCCL ranks: {b}" for b in bad)
        del ranks

        # bin/train.py as a user runs it: no distributed keys, so it
        # spawns one NCCL worker per visible GPU and returns None
        t0 = time.perf_counter()
        spawned = train_cli.main(argv("spawn"))
        wall = time.perf_counter() - t0
        ckpt = root / "spawn/ckpt/last"
        line = (f"[{gpu}] phase 12 (a): bin/train.py with no distributed "
                f"keys over {count} GPUs: returned {spawned!r}, "
                f"ckpt/last {ckpt.exists()}, wall {wall:.1f} s")
        if spawned is not None or not ckpt.exists():
            failures.append(line)
        else:
            # the checkpoints hold the reference's names: the update's
            # norm is the one process's, in the model's names
            gap = _param_gap(
                torch.load(ckpt, weights_only=True)["model"],
                torch.load(root / "single/ckpt/last",
                           weights_only=True)["model"])
            update_l2 = _param_gap(ref["state_dict"], ref["state_dict"],
                                   ref["init"])["update_l2"]
            line += (f"; parameters: largest difference {gap['diff']:.3g} "
                     f"from one process's (largest {gap['scale']:.3g}), L2 "
                     f"{gap['l2']:.3g} against the update's {update_l2:.3g}")
            if not (gap["l2"] <= PARALLEL_PARAM_RTOL * update_l2
                    and gap["exact"]):
                failures.append(line)
        print(line, flush=True)

    gloo = _spawn_ranks(GLOO_RANKS, "gloo", argv("gloo"), root / "gloo_out")
    equal = all(torch.equal(gloo[0]["tensors"]["state_dict"][k], v)
                for k, v in gloo[1]["tensors"]["state_dict"].items())
    for r, st in enumerate(gloo):
        print(_train_line(gpu, f"gloo rank {r} of {GLOO_RANKS}", st),
              flush=True)
    gap, bad = _agreement(gloo[0], single)
    print(f"[{gpu}] phase 12 (a): {GLOO_RANKS} gloo ranks on "
          f"{[st['device'] for st in gloo]}: the ranks' parameters equal: "
          f"{equal}; rank 0 against one process: {_gap_text(gap)}",
          flush=True)
    if not (equal and all(st["finite"] for st in gloo)):
        bad.append(f"the ranks' parameters equal {equal}")
    failures.extend(f"phase 12 (a): gloo ranks: {b}" for b in bad)
    del gloo, single, ref
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) a 640-frame request over [cuda:0, cuda:0] (and cuda:0, cuda:1)
    meshes = [[dev, dev]] + ([[dev, torch.device("cuda", 1)]]
                             if count > 1 else [])
    kw = dict(tokenizer=FixedTokenizer(PROMPT_LEN), device=dev,
              chunk_frames=CHUNK, halo_frames=HALO)
    req = dict(use_max=True, noise_scale=0.0, seed=4)
    plain = Synthesizer(model, vocoder, **kw)
    with mock.patch.object(decode_graph, "decode", _eager_decode):
        ref_wav, ref_mel = plain.synthesize(seqs, prompts, **req)
    margin = HALO * 240
    for devices in meshes:
        mesh = make_mesh(devices=devices)
        sharded = Synthesizer(model, vocoder, frame_sharded_decode=True,
                              vocoder_mode="sharded", mesh=mesh, **kw)
        sharded.synthesize(seqs, prompts, **req)  # the replicas' warm-up
        _zero_counts(k1, k2)
        t0 = time.perf_counter()
        wav, mel = sharded.synthesize(seqs, prompts, **req)
        wall = time.perf_counter() - t0
        launches = _counts(k1, k2)
        mel_err = float(np.abs(mel[0] - ref_mel[0]).max())
        wav_err = float(np.abs(wav[0][margin:-margin]
                               - ref_wav[0][margin:-margin]).max())
        n_shards = len(devices)
        chunks = -(-(-(-FRAMES // CHUNK)) // n_shards) * n_shards
        expect = {"antialias_snake": n_shards,
                  "amp_layer_bf16": 72 * n_shards, "amp_layer": 0,
                  "amp_block": 0}
        print(f"[{gpu}] phase 12 (b): {FRAMES}-frame request, "
              f"frame_sharded_decode over {[str(d) for d in devices]}, "
              f"sharded vocoder ({chunks} chunks of {CHUNK}): wall "
              f"{wall * 1e3:.1f} ms; mel {mel_err:.3g} from the unsharded "
              f"eager decode's (bar {SHARDED_MEL_ATOL}); wav interior "
              f"{wav_err:.3g} from the batched path's (bar {STREAM_ATOL}); "
              f"launches {launches} (expected {expect})"
              + (one_card if devices[1] == devices[0] else ""), flush=True)
        if not (mel[0].shape == ref_mel[0].shape
                and mel_err <= SHARDED_MEL_ATOL and wav_err <= STREAM_ATOL
                and launches == expect):
            failures.append(f"phase 12 (b) {devices}: mel {mel_err:.3g}, "
                            f"wav {wav_err:.3g}, launches {launches}")

        # the decode and the vocoder alone, each path in alternated turns
        _, _, rq = plain._request(seqs, prompts, None, None, True, 0.0, 4)
        with torch.inference_mode():
            cond, _, fmask, log_cf0, vuv, _ = model.infer_cond(
                rq["phoneme"], rq["plens"], FRAMES, rq["prompt_ids"],
                rq["prompt_mask"], use_max=True, noise_scale=0.0,
                style_generator=plain._generator(4))
            f0, mel_denorm = plain._postprocess(
                plain._decoder.inference(cond, generator=plain._generator(5))
                * fmask[:, :, None], log_cf0, vuv)
        paths = {
            "graph decode": lambda: decode_graph.decode(
                plain._decoder, cond, None, False, plain._generator(5)),
            "sharded eager decode": lambda: decode_frames_sharded(
                mesh, plain._decoder, cond, generator=plain._generator(5),
                denoiser=sharded._sharded_denoiser),
            "batched vocoder": lambda: vocoder(mel_denorm, f0,
                                               deterministic=True),
            "sharded vocoder": lambda: vocode_sharded(
                mesh, vocoder, mel_denorm, f0, chunk_frames=CHUNK,
                halo_frames=HALO, replicas=sharded._voc_replicas,
                deterministic=True)}
        times = {name: [] for name in paths}
        with torch.inference_mode():
            for turn in range(PARALLEL_TURNS):
                order = list(paths) if turn % 2 == 0 else list(paths)[::-1]
                for name in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    paths[name]()
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        print(f"[{gpu}] phase 12 (b): over {[str(d) for d in devices]}, "
              f"median of {PARALLEL_TURNS} alternated turns (host clock, "
              "synchronized): " + ", ".join(
                  f"{name} {np.median(t):.1f} ms" for name, t in
                  times.items()), flush=True)
        del sharded, cond, f0, mel_denorm
        torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)


def _model_axis_line(gpu, label, st):
    import numpy as np

    calls = st["model_allreduce_calls"]
    return (f"[{gpu}] phase 13 {label} on {st['device']}: update ms "
            f"{[round(t, 1) for t in st['update_ms']]}; model group "
            f"all-reduces per update: {calls['layers']} in the forward and "
            f"backward, {calls['update']} in the update, "
            f"{np.median(st['model_allreduce_ms']):.1f} ms median "
            f"(CUDA events around each), "
            f"{np.median(st['model_allreduce_bytes']) / 2**20:.1f} MiB; "
            f"data group gradient all-reduce "
            + (f"{np.median(st['allreduce_ms']):.1f} ms"
               if st["allreduce_ms"] else "none")
            + f"; peak {st['peak_gib']:.2f} GiB; wall {st['wall_s']:.1f} s")


def phase_model_axis(k1, k2, model, vocoder, seqs, prompts, dev, gpu,
                     failures):
    """Tensor and pipeline parallelism at the flagship's widths (see phase
    13 of the module docstring) -> the launch counts of the pipelined
    single request."""
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.data.dataset import (
        read_prompt_candidate, read_spk_prompt_candidate)
    from promptttspp_tpu_torch.infer import Synthesizer
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.parallel.mesh import Mesh
    from promptttspp_tpu_torch.tools import dryrun_multichip
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_training_corpus)

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    root = OUT_DIR / "model_axis"
    shutil.rmtree(root, ignore_errors=True)
    meta = ROOT / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    # phase 12's corpus: PARALLEL_UPDATES batches of PARALLEL_BATCH rows
    # (TP), and PP_UPDATES of PP_BATCH (PP)
    for name, n_train in (("corpus_tp", PARALLEL_BATCH * PARALLEL_UPDATES),
                          ("corpus_pp", PP_BATCH * PP_UPDATES)):
        rows = training_rows(n_train + 2, cands, spk, TRAIN_PHONES,
                             TRAIN_FPP, valid_every=(n_train + 2) // 2,
                             seed=12)
        write_training_corpus(root / name, rows, cands, spk,
                              n_mels=flagship.MODEL["decoder"]["out_dim"],
                              mel_mean=-5.0, mel_std=2.0, seed=13)

    def argv(name, batch=PARALLEL_BATCH, corpus="corpus_tp"):
        return [f"path.root={root / corpus}", f"output_dir={root / name}",
                f"hydra.run.dir={root / 'run'}", "train.num_epochs=1",
                "dataset.dynamic_batch=false", f"train.batch_size={batch}",
                "train.seed=5", "+dataset.train.seed=1",
                "+dataset.valid.seed=2", "+train.input_pipeline=sync",
                PARALLEL_WARMUP]

    # (a) TP=2 against one process on phase 12's batches
    backend = "nccl" if count >= TP_RANKS else "gloo"
    single = _timed_train([*argv("single"), ONE_PROCESS])
    tp = _spawn_ranks(TP_RANKS, backend, [*argv("tp"),
                                          f"+train.mesh.model={TP_RANKS}"],
                      root / "tp_out")
    where = ("" if backend == "nccl" else
             f"; {count} GPU, so the {TP_RANKS} ranks are gloo's on cuda:0")
    for r, st in enumerate(tp):
        print(_model_axis_line(gpu, f"(a): TP={TP_RANKS} {backend} rank {r}",
                               st) + where, flush=True)
    layer_calls = [st["model_allreduce_calls"]["layers"] for st in tp]
    print(_train_line(gpu, "one process", single).replace(
        "phase 12 (a)", "phase 13 (a)"), flush=True)
    gap, bad = _agreement(tp[0], single, (root / "tp/ckpt/last",
                                          root / "single/ckpt/last"))
    print(f"[{gpu}] phase 13 (a): TP={TP_RANKS} rank 0 against one process: "
          f"{_gap_text(gap)}; whole first-update gradient "
          f"{gap['whole_grad_rel']:.3g} relative (L2 over every tensor); the "
          f"loss per update {[f'{r:.3g}' for r in gap['loss_rel']]} "
          "relative", flush=True)
    if not all(st["finite"] for st in tp):
        bad.append("a loss is not finite")
    if any(n != TP_ALLREDUCES for calls in layer_calls for n in calls):
        bad.append(f"model-group all-reduces in the forward and backward "
                   f"{layer_calls}, not {TP_ALLREDUCES} per update")
    failures.extend(f"phase 13 (a): {b}" for b in bad)
    del tp

    # (b) PP: S stages, M microbatches, TP off, against one process; the
    # same process again (the card's own spread: its backward's atomics)
    # and one stage in M microbatches in one process (the split alone)
    single_pp = _timed_train([*argv("single_pp", PP_BATCH, "corpus_pp"),
                              ONE_PROCESS])
    again = _timed_train([*argv("again_pp", PP_BATCH, "corpus_pp"),
                          ONE_PROCESS])
    split = _timed_train([*argv("split_pp", PP_BATCH, "corpus_pp"),
                          ONE_PROCESS,
                          f"+train.mesh.pipeline_microbatches={PP_MICRO}"])
    pp_argv = [*argv("pp", PP_BATCH, "corpus_pp"),
               f"+train.mesh.model={PP_STAGES}",
               f"+train.mesh.pipeline_microbatches={PP_MICRO}",
               "+train.mesh.model_spans_processes=true"]
    pp = _spawn_ranks(PP_STAGES, "gloo" if count < PP_STAGES else "nccl",
                      pp_argv, root / "pp_out")
    for r, st in enumerate(pp):
        print(_model_axis_line(gpu, f"(b): PP stage {r} of {PP_STAGES}", st),
              flush=True)
    gap, _ = _agreement(again, single_pp)
    print(f"[{gpu}] phase 13 (b): the unpipelined process again against "
          f"itself: {_gap_text(gap)}", flush=True)
    gap, bad = _agreement(split, single_pp, held=PARALLEL_UPDATES)
    print(f"[{gpu}] phase 13 (b): one stage in {PP_MICRO} microbatches in "
          f"one process against the unpipelined process (the later-updates "
          f"bar on updates 2-{PARALLEL_UPDATES}): {_gap_text(gap)}",
          flush=True)
    failures.extend(f"phase 13 (b), one stage: {b}" for b in bad)
    n_up = len(single_pp["update_ms"])
    gap, bad = _agreement(pp[0], single_pp, (root / "pp/ckpt/last",
                                             root / "single_pp/ckpt/last"),
                          held=PARALLEL_UPDATES)
    blocks = flagship.MODEL["decoder"]["denoise_fn"]["residual_layers"]
    print(f"[{gpu}] phase 13 (b): PP over {PP_STAGES} stages of "
          f"{blocks // PP_STAGES} blocks, {PP_MICRO} microbatches of "
          f"{PP_BATCH // PP_MICRO} rows, "
          f"{n_up} updates, against the unpipelined process (update ms "
          f"{[round(t, 1) for t in single_pp['update_ms']]}; the "
          f"later-updates bar on updates 2-{PARALLEL_UPDATES}): "
          f"{_gap_text(gap)}; whole first-update gradient "
          f"{gap['whole_grad_rel']:.3g} relative; the loss per update "
          f"{[f'{r:.3g}' for r in gap['loss_rel']]} relative", flush=True)
    if not all(st["finite"] for st in pp):
        bad.append("a loss is not finite")
    failures.extend(f"phase 13 (b): {b}" for b in bad)
    del pp, single, single_pp, split, again
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) PP serving over [[cuda:0] * S] (and over every GPU, in turn)
    kw = dict(tokenizer=FixedTokenizer(PROMPT_LEN), device=dev)
    req = dict(use_max=True, noise_scale=0.0, seed=4)
    plain = Synthesizer(model, vocoder, **kw)
    runs = [(1, 1, [dev] * PP_STAGES), (2, 2, [dev] * PP_STAGES)]
    if count > 1:
        runs.append((1, 1, [torch.device("cuda", i % count)
                            for i in range(PP_STAGES)]))
    single_launches = None
    for n_items, m, devices in runs:
        mesh = Mesh([devices])
        s_, p_ = seqs * n_items, prompts * n_items
        with mock.patch.object(decode_graph, "decode", _eager_decode):
            ref_wav, ref_mel = plain.synthesize(s_, p_, **req)
        piped = Synthesizer(model, vocoder, decode_pipelined=True,
                            pipeline_microbatches=m, mesh=mesh, **kw)
        piped.synthesize(s_, p_, **req)  # warm-up
        _zero_counts(k1, k2)
        t0 = time.perf_counter()
        wav, mel = piped.synthesize(s_, p_, **req)
        wall = time.perf_counter() - t0
        launches = _counts(k1, k2)
        mel_err = max(float(np.abs(a - b).max())
                      for a, b in zip(mel, ref_mel))
        wav_err = max(float(np.abs(a - b).max())
                      for a, b in zip(wav, ref_wav))
        expect = {"antialias_snake": 1, "amp_layer_bf16": 72,
                  "amp_layer": 0, "amp_block": 0}
        _, _, rq = plain._request(s_, p_, None, None, True, 0.0, 4)
        with torch.inference_mode():
            cond = model.infer_cond(
                rq["phoneme"], rq["plens"], FRAMES, rq["prompt_ids"],
                rq["prompt_mask"], use_max=True, noise_scale=0.0,
                style_generator=plain._generator(4))[0]
            paths = {"graph decode": lambda: decode_graph.decode(
                         plain._decoder, cond, None, False,
                         plain._generator(5)),
                     "pipelined eager decode": lambda: piped._decoder
                     .inference(cond, generator=plain._generator(5))}
            times = {name: [] for name in paths}
            for turn in range(PARALLEL_TURNS):
                order = list(paths) if turn % 2 == 0 else list(paths)[::-1]
                for name in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    paths[name]()
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        print(f"[{gpu}] phase 13 (c): {n_items} x {FRAMES}-frame request, "
              f"decode pipelined over {PP_STAGES} stages on "
              f"{[str(d) for d in devices]} in {m} microbatches: wall {wall * 1e3:.1f} ms; mel {mel_err:.3g} "
              f"from the unpipelined eager decode's (bar "
              f"{SHARDED_MEL_ATOL}); wav {wav_err:.3g} from it (bar "
              f"{WAV_BF16_ATOL}); launches {launches} (expected {expect}); "
              f"median of {PARALLEL_TURNS} alternated turns (host clock, "
              "synchronized): " + ", ".join(
                  f"{name} {np.median(t):.1f} ms"
                  for name, t in times.items()), flush=True)
        if not (len(mel) == n_items and mel_err <= SHARDED_MEL_ATOL
                and wav_err <= WAV_BF16_ATOL and launches == expect):
            failures.append(f"phase 13 (c) batch {n_items} over "
                            f"{[str(d) for d in devices]}: mel "
                            f"{mel_err:.3g}, wav {wav_err:.3g}, launches "
                            f"{launches}")
        if single_launches is None:
            single_launches = launches
        del piped, cond
        torch.cuda.empty_cache()

    # (d) the dry run of every axis
    t0 = time.perf_counter()
    out = dryrun_multichip.dryrun(4, 2, dev.type)
    for line in out["lines"]:
        print(f"[{gpu}] phase 13 (d): {line}", flush=True)
    print(f"phase 13 (d): {time.perf_counter() - t0:.1f} s", flush=True)
    if not out["ok"]:
        failures.append("phase 13 (d): the dry run failed")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)
    return single_launches


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (float tensors on any device)."""
    want = want.detach().float().cpu()
    got = got.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_variant(k1, k2, vocoder, dev, gpu, failures):
    """The model's remaining switches and the ESPnet suite (phase 14 of the
    module docstring): ``variant_config`` of the flagship, and the ESPnet
    modules at their own default widths. Returns the launch counts of the
    variant's requests."""
    import copy
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import conf
    from promptttspp_tpu_torch.data.batching import batch_by_size
    from promptttspp_tpu_torch.data.collate import PromptTTSCollator
    from promptttspp_tpu_torch.data.dataset import (
        AllWithSpkPromptNormDataset, read_prompt_candidate,
        read_spk_prompt_candidate)
    from promptttspp_tpu_torch.infer import Synthesizer
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.nn.decoder import Decoder
    from promptttspp_tpu_torch.nn.transformer_encoder import (
        TransformerEncoder)
    from promptttspp_tpu_torch.ops.masks import (
        add_sos_eos, subsequent_mask, target_mask)
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_training_corpus)
    from promptttspp_tpu_torch.train.state import TrainState
    from promptttspp_tpu_torch.train.trainer import model_batch_keys

    t_phase = time.perf_counter()
    cfg = variant_config(flagship.MODEL)
    bert_config = flagship.bert_config_of(cfg["prompt_encoder"])
    mel_dim = cfg["decoder"]["out_dim"]

    # (a) the variant at full width, served
    model = flagship.bias_duration_head(
        flagship.build_model(cfg, dev, 0, bert_config), 10.0)
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    synth = Synthesizer(model, vocoder, tokenizer=FixedTokenizer(PROMPT_LEN),
                        device=dev)
    seqs, prompts = request_inputs()
    samples = FRAMES * 240
    audio_s = samples / flagship.VOCODER["sampling_rate"]
    kw = dict(use_max=True, noise_scale=0.0)
    _zero_counts(k1, k2)
    walls = []
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        wavs, _ = synth.synthesize(seqs, prompts, seed=i, **kw)
        walls.append(time.perf_counter() - t0)
        w = wavs[0]
        if w.shape != (samples,) or not np.isfinite(w).all():
            failures.append(f"variant request {i}: wav shape {w.shape}, "
                            f"finite {bool(np.isfinite(w).all())}")
    launches = _counts(k1, k2)
    expect = {"antialias_snake": N_REQUESTS,
              "amp_layer_bf16": 72 * N_REQUESTS, "amp_layer": 0,
              "amp_block": 0}
    if launches != expect:
        failures.append(f"variant requests: launch counts {launches} != "
                        f"{expect}")
    steady = float(np.median(walls[1:]))
    print(f"[{gpu}] phase 14 (a): the variant ({n_params:.1f} M params: "
          "norm_style_emb and mdn_disable_amp false, scaled phoneme "
          "embedding, the conformer at JAX's defaults, one style GMM, the "
          f"energy branch): {N_REQUESTS} two-phase requests, walls "
          f"{[round(x * 1e3, 1) for x in walls]} ms for {audio_s:.1f} s of "
          f"audio (RTF {steady / audio_s:.5f} at the median of the last "
          f"{N_REQUESTS - 1}); launches {launches} (expected {expect}: K1 1 "
          "and K2-bf16 72 per request)", flush=True)
    prof = profile_request(synth, seqs, prompts, gpu, steady, "variant")
    if prof is not None:
        print(f"[{gpu}] phase 14 (a): device {prof['device_ms']:.1f} ms of "
              f"the {steady * 1e3:.1f} ms median wall", flush=True)
    got = synth.synthesize(seqs, prompts, seed=5, **kw)
    with mock.patch.object(decode_graph, "decode", _eager_decode):
        want = synth.synthesize(seqs, prompts, seed=5, **kw)
    same = all(np.array_equal(x, y) for x, y in zip(got[0] + got[1],
                                                    want[0] + want[1]))
    if not same:
        failures.append("variant: graph decode differs from eager")
    cpu = flagship.build_model(cfg, "cpu", 0, bert_config)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    _, _, req = synth._request(seqs, prompts, None, None, True, 0.0, 0)
    args = (req["phoneme"], req["plens"], FRAMES, req["prompt_ids"],
            req["prompt_mask"])
    with torch.inference_mode():
        on_card = model.infer_cond(*args, **kw)
        on_cpu = cpu.infer_cond(*(a.cpu() if torch.is_tensor(a) else a
                                  for a in args), **kw)
    errs = {name: _rel_err(a, b) for name, a, b in zip(
        ("cond", "log_cf0", "vuv"), (on_card[0], on_card[3], on_card[4]),
        (on_cpu[0], on_cpu[3], on_cpu[4]))}
    lengths_equal = bool(torch.equal(on_card[1].cpu(), on_cpu[1]))
    print(f"[{gpu}] phase 14 (a): graph decode vs eager decode "
          f"{'equal bit for bit' if same else 'DIFFER'} (mel and wav); "
          f"infer_cond on the card vs the CPU: max error relative to the "
          f"largest magnitude {errs} (tol {VARIANT_RTOL}), frame lengths "
          f"equal: {lengths_equal}", flush=True)
    if max(errs.values()) > VARIANT_RTOL or not lengths_equal:
        failures.append(f"variant infer_cond card vs CPU: {errs}, lengths "
                        f"equal {lengths_equal}")
    del synth, model, cpu, on_card, on_cpu, req
    torch.cuda.empty_cache()

    # (b) one training update of the variant against the CPU's
    root = OUT_DIR / "variant"
    shutil.rmtree(root, ignore_errors=True)
    meta = ROOT / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    write_training_corpus(root, training_rows(
        VARIANT_UTTS, cands, spk, TRAIN_PHONES, TRAIN_FPP, valid_every=20,
        seed=5), cands, spk, n_mels=mel_dim, mel_mean=-5.0, mel_std=2.0,
        seed=6)
    tcfg = conf.compose("train", [f"path.root={root}",
                                  f"dataset.max_tokens={MAX_TOKENS}"])
    ds = AllWithSpkPromptNormDataset(**tcfg["dataset"]["train"])
    idx = max(batch_by_size(ds.ordered_indices(), ds.num_tokens,
                            max_tokens=MAX_TOKENS), key=len)
    batch = PromptTTSCollator(WordPieceTokenizer.from_vocab_file(
        tcfg["path"]["bert_vocab_file"]))([ds[i] for i in idx])
    cfg0, bert0 = _no_dropout(cfg, bert_config)
    cpu = flagship.build_model(cfg0, "cpu", seed=3, bert_config=bert0)
    batch = {k: batch[k] for k in model_batch_keys(cpu) if k in batch}
    rng = np.random.RandomState(12)
    B, Tf = batch["mel"].shape[:2]
    batch["diffusion_t"] = rng.randint(0, cfg["decoder"].get("K_step", 100),
                                       B)
    batch["diffusion_noise"] = rng.randn(B, Tf, mel_dim).astype(np.float32)
    card = copy.deepcopy(cpu).to(dev)
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    outs, states = [], []
    for m, d in ((cpu, "cpu"), (card, dev)):
        states.append(TrainState(m, warmup_steps=1, seed=0))
        tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                  if np.asarray(v).dtype.kind in "iu"
                                  else np.asarray(v)).to(d)
              for k, v in batch.items()}
        t0 = time.perf_counter()
        outs.append({k: v.item() for k, v in states[-1].train_step(
            tb).items()})
        if d == "cpu":
            cpu_s = time.perf_counter() - t0
    gap = _param_gap({k: v.cpu() for k, v in card.state_dict().items()},
                     cpu.state_dict(), init)
    param_ok = gap["l2"] <= PARALLEL_PARAM_RTOL * gap["update_l2"]
    loss_ok = set(outs[0]) == set(outs[1]) and "energy" in outs[0] and all(
        np.isclose(outs[1][k], v, **TRAIN_LOSS_TOL)
        for k, v in outs[0].items())
    step_ms = []
    for _ in range(2):  # the same batch again: the update's steady time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[1].train_step(tb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[{gpu}] phase 14 (b): one update of the variant "
          f"({sum(p.numel() for p in cpu.parameters()) / 1e6:.1f} M params) "
          f"on a max_tokens={MAX_TOKENS} batch {list(batch['mel'].shape)} "
          f"({int(np.sum(batch['frame_lengths']))} frames) of a synthetic "
          "corpus: card " + ", ".join(f"{k} {v:.6g}"
                                      for k, v in outs[1].items())
          + "; CPU " + ", ".join(f"{k} {v:.6g}" for k, v in outs[0].items())
          + f" (tol {TRAIN_LOSS_TOL}); parameters and BatchNorm statistics "
          f"after the update at the peak rate: difference L2 "
          f"{gap['l2']:.4g} of the update's {gap['update_l2']:.4g} (tol "
          f"{PARALLEL_PARAM_RTOL} of it), largest difference "
          f"{gap['diff']:.3g}, largest move {gap['moved']:.3g}, other "
          f"tensors equal: {gap['exact']}; update time on the card "
          f"{[round(x, 1) for x in step_ms]} ms (synchronized, after the "
          f"first), CPU {cpu_s:.1f} s", flush=True)
    if not (loss_ok and param_ok and gap["exact"]):
        failures.append(f"variant update card vs CPU: losses {outs}, params "
                        f"{gap}")
    del cpu, card, states, init
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) the ESPnet suite at its modules' default widths
    rng = np.random.RandomState(13)
    B, T, F, L = ESP_BATCH, ESP_FRAMES, ESP_FEATS, ESP_TOKENS
    lens = np.concatenate([[T], rng.randint(T // 2, T + 1, B - 1)])
    x = torch.from_numpy(rng.randn(B, T, F).astype(np.float32))
    x_mask = torch.from_numpy(np.arange(T)[None, None] < lens[:, None, None])
    torch.manual_seed(14)
    enc = TransformerEncoder(F, input_layer="conv2d").eval()
    enc_card = copy.deepcopy(enc).to(dev)
    with torch.inference_mode():
        memory, mem_mask = enc(x, x_mask)
        out, out_mask = enc_card(x.to(dev), x_mask.to(dev))
        enc_ms = cuda_ms(lambda: enc_card(x.to(dev), x_mask.to(dev)),
                         iters=3, kernel=False)
    valid = mem_mask[:, 0]
    errs = {"encoder": _rel_err(out[valid.to(dev)], memory[valid])}
    masks_equal = bool(torch.equal(out_mask.cpu(), mem_mask))
    times = {"encoder": enc_ms}
    V = ESP_VOCAB
    ylens = np.concatenate([[L], rng.randint(L // 2, L + 1, B - 1)])
    ys = rng.randint(1, V - 1, (B, L))
    ys[np.arange(L)[None] >= ylens[:, None]] = -1
    ys_in, _ = add_sos_eos(torch.from_numpy(ys), V - 1, V - 1, -1)
    tgt_mask = target_mask(ys_in, -1)
    rows = (np.arange(L + 1)[None] <= ylens[:, None])
    card_args = (ys_in.to(dev), tgt_mask.to(dev), memory.to(dev),
                 mem_mask.to(dev))
    for kind in ESP_DECODERS:
        torch.manual_seed(15)
        dec = Decoder(V, selfattention_layer_type=kind,
                      conv_kernel_length=ESP_CONV_KERNELS).eval()
        dec_card = copy.deepcopy(dec).to(dev)
        with torch.inference_mode():
            want, _ = dec(ys_in, tgt_mask, memory, mem_mask)
            got, _ = dec_card(*card_args)
            times[kind] = cuda_ms(lambda: dec_card(*card_args), iters=3,
                                  kernel=False)
            errs[kind] = _rel_err(got[torch.from_numpy(rows).to(dev)],
                                  want[torch.from_numpy(rows)])
            steps = {}
            for d, m in ((dev, dec_card), ("cpu", dec)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache, mem, steps[d] = None, memory.to(d), []
                for t in range(1, ESP_STEPS + 1):
                    lp, cache = m.forward_one_step(
                        ys_in[:, :t].to(d), subsequent_mask(t)[None].to(d),
                        mem, None, cache=cache)
                    steps[d].append(lp)
                torch.cuda.synchronize()
                if d == dev:
                    times[f"{kind} {ESP_STEPS} steps"] = (
                        time.perf_counter() - t0) * 1e3
            errs[f"{kind} one-step"] = max(
                _rel_err(a, b) for a, b in zip(steps[dev], steps["cpu"]))
        del dec, dec_card
    print(f"[{gpu}] phase 14 (c): the ESPnet suite at batch {B} "
          "(ESPnet's default widths): TransformerEncoder "
          f"(conv2d) on [{B}, {T}, {F}] -> {list(out.shape)}, Decoder over "
          f"it on {L + 1} target tokens (vocabulary {V}, kernels "
          f"{ESP_CONV_KERNELS}) for each of {list(ESP_DECODERS)}, and "
          f"{ESP_STEPS} steps of forward_one_step each; card vs CPU, max "
          f"error relative to the largest magnitude: "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
          f"{VARIANT_RTOL}), masks equal: {masks_equal}; time per call "
          "(CUDA events; the one-step loops synchronized wall): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()),
          flush=True)
    if max(errs.values()) > VARIANT_RTOL or not masks_equal:
        failures.append(f"ESPnet suite card vs CPU: {errs}, masks equal "
                        f"{masks_equal}")
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)
    return launches


def aux_net_entries():
    """Phase 15's entries: (name, kind, build, run) with build() -> a
    module on the CPU (seeded) and run(module, inputs) -> its output(s);
    ``inputs(device)`` comes with each entry. ``kind`` "forward" or
    "sample" picks the bar."""
    import numpy as np
    import torch

    from promptttspp_tpu_torch.models.cnf import CNF
    from promptttspp_tpu_torch.models.glow import Glow
    from promptttspp_tpu_torch.models.nnsvs_diffusion import (
        DiffNetG, GaussianDiffusionCFG)
    from promptttspp_tpu_torch.models.score_sde import ScoreSDE
    from promptttspp_tpu_torch.models.unet import Unet1d
    from promptttspp_tpu_torch.nn.conformer_local import Conformer
    from promptttspp_tpu_torch.nn.convnext import ConvNeXt1d
    from promptttspp_tpu_torch.nn.mrf import MRFNet
    from promptttspp_tpu_torch.nn.transformer import Transformer

    a = AUX
    B, T, M, H, S = a["batch"], a["frames"], a["mels"], a["cond"], a["style"]
    rng = np.random.RandomState(15)

    def arr(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    mask = np.ones((B, T, 1), np.float32)
    mask[1, T - T // 5:] = 0.0  # a shorter second row
    conv_ch, conv_h, conv_n = a["convnext"]
    mrf_ch, mrf_k, mrf_d = a["mrf"]
    cf_n, cf_ch, cf_h, cf_k = a["conformer"]
    v_ch, v_h, v_n, v_k, v_scale, v_w = a["vits"]
    dim = a["unet_dim"]
    g_ch, g_flows, g_blocks = a["glow"]
    d_res, d_layers, d_rc, d_cycle = a["diffnet"]
    t_unit = np.asarray([0.31, 0.77][:B] + [0.5] * (B - 2), np.float32)
    steps = np.asarray([7, 93][:B] + [50] * (B - 2), np.int64) % \
        a["anc_steps"]

    def glow():
        # the couplings' end layers start at zero (an identity coupling
        # and a log-determinant of rounding noise): drawn small, as a
        # trained flow's
        flow = Glow(g_ch, g_ch, g_flows, g_blocks)
        for coupling in flow.flows[1::2]:
            torch.nn.init.normal_(coupling.end.weight, std=0.02)
            torch.nn.init.normal_(coupling.end.bias, std=0.02)
        return flow

    def cfg_diffusion(pndm=None):
        return GaussianDiffusionCFG(
            H, M, DiffNetG(M, H, d_layers, d_rc, d_cycle, gin_channels=S),
            K_step=a["anc_steps"], norm_scale=6.0, pndm_speedup=pndm,
            do_classifier_free_guidance=True, guidance_scale=2.0)

    x_conv, x_mrf = arr(B, T, conv_ch), arr(B, T, mrf_ch)
    x_cf, x_v = arr(B, T, cf_ch), arr(B, T, v_ch)
    g_mrf, g_cf = arr(B, 1, mrf_ch, scale=0.3), arr(B, 1, cf_ch, scale=0.3)
    mel, cond, style = arr(B, T, M, scale=2.0), arr(B, T, H), arr(B, 1, S)
    x_T, x0 = arr(B, T, M), arr(B, T, M)
    mu = arr(B, T, M, scale=2.0)
    z_glow = arr(B, 1, g_ch)
    return [
        ("ConvNeXt1d", "forward", lambda: ConvNeXt1d(conv_ch, conv_h, conv_n),
         lambda m, i: m(i[0], i[1]), (x_conv, mask)),
        ("MRFNet+g", "forward",
         lambda: MRFNet(M, mrf_ch, M, mrf_k, mrf_d),
         lambda m, i: m(i[0], i[1], g=i[2]), (x_mrf, mask, g_mrf)),
        ("Conformer(local)+g", "forward",
         lambda: Conformer(cf_n, cf_ch, cf_h, cf_k, 0.0),
         lambda m, i: m(i[0], i[1], g=i[2]), (x_cf, mask, g_cf)),
        ("Conformer(local)", "forward",
         lambda: Conformer(cf_n, cf_ch, cf_h, cf_k, 0.0),
         lambda m, i: m(i[0], i[1]), (x_cf, mask)),
        ("Transformer(VITS, relative)", "forward",
         lambda: Transformer(v_ch, v_h, v_n, v_k, 0.0, v_scale, v_w, True),
         lambda m, i: m(i[0], i[1]), (x_v, mask)),
        ("Transformer(VITS, absolute)", "forward",
         lambda: Transformer(v_ch, v_h, v_n, v_k, 0.0, v_scale),
         lambda m, i: m(i[0], i[1]), (x_v, mask)),
        ("Unet1d", "forward", lambda: Unet1d(M, H, M, dim),
         lambda m, i: m(i[0], i[1], i[2], i[3]), (mel, t_unit, cond, mask)),
        ("Glow", "forward", glow, lambda m, i: m(i[0]), (z_glow,)),
        ("GaussianDiffusionCFG training forward", "forward", cfg_diffusion,
         lambda m, i: m(i[0], i[1], g=i[2], t=i[3], noise=i[4])[1],
         (cond, mel, style, steps, x_T)),
        (f"GaussianDiffusionCFG {a['anc_steps']}-step ancestral", "sample",
         cfg_diffusion,
         lambda m, i: m.inference(i[0], g=i[1], x_T=i[2], zero_noise=True),
         (cond, style, x_T)),
        (f"GaussianDiffusionCFG PLMS-{a['plms']}", "sample",
         lambda: cfg_diffusion(a["plms"]),
         lambda m, i: m.inference(i[0], g=i[1], x_T=i[2], zero_noise=True),
         (cond, style, x_T)),
        ("CNF training forward", "forward",
         lambda: CNF(Unet1d(M, H, M, dim), M),
         lambda m, i: m(i[0], i[1], i[2], t=i[3], x0=i[4])[1],
         (mel, cond, mask, t_unit, x0)),
        (f"CNF {a['cnf_steps']} Euler steps, CFG", "sample",
         lambda: CNF(Unet1d(M, H, M, dim), M),
         lambda m, i: m.sample(i[0], a["cnf_steps"] + 1, "euler", True,
                               x0=i[1]), (cond, x0)),
        (f"CNF {a['cnf_steps']} RK4 steps, CFG", "sample",
         lambda: CNF(Unet1d(M, H, M, dim), M),
         lambda m, i: m.sample(i[0], a["cnf_steps"] + 1, "rk4", True,
                               x0=i[1]), (cond, x0)),
        ("ScoreSDE loss", "forward",
         lambda: ScoreSDE(M, Unet1d(M, M, M, dim)),
         lambda m, i: m.compute_loss(i[0], i[1], i[2], t=i[3], z=i[4]),
         (mel, mu, mask, t_unit, x0)),
        (f"ScoreSDE {a['sde_steps']} RK4 steps", "sample",
         lambda: ScoreSDE(M, Unet1d(M, M, M, dim)),
         lambda m, i: m(i[0], i[1], i[2], a["sde_steps"] + 1),
         (x_T, mu, mask)),
    ]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@contextlib.contextmanager
def tf32_on():
    """TF32 switched on for cuDNN and cuBLAS, as torch's default leaves
    cuDNN; off again after, as this script runs."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_aux_nets(k1, k2, dev, gpu, failures):
    """The experimental nets and the data-prep command line on the card
    (phase 15 of the module docstring). Returns the launch counts of the
    phase, which holds no kernel."""
    import copy
    import os
    import shutil

    import numpy as np
    import torch

    from promptttspp_tpu_torch.data import yaml_lite
    from promptttspp_tpu_torch.data_prep import compute_utt_stats
    from promptttspp_tpu_torch.data_prep.common import read_wav_any
    from promptttspp_tpu_torch.models.diffusion import float32_math
    from promptttspp_tpu_torch.ops.f0 import extract_f0
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        raw_rows, write_raw_corpus)

    t_phase = time.perf_counter()
    _zero_counts(k1, k2)
    a = AUX
    for name, kind, build, run, inputs in aux_net_entries():
        torch.manual_seed(0)
        cpu_mod = build().eval().requires_grad_(False)
        dev_mod = copy.deepcopy(cpu_mod).to(dev)
        n_params = sum(p.numel() for p in cpu_mod.parameters())
        to = lambda d: tuple(torch.from_numpy(v).to(d) for v in inputs)
        cpu_in, dev_in = to("cpu"), to(dev)
        # the samplers and Glow set float32 themselves: they run with TF32
        # on, so that the comparison holds their own setting; the nets
        # under float32_math
        own = kind == "sample" or name == "Glow"
        with torch.no_grad(), (tf32_on() if own else float32_math()):
            t0 = time.perf_counter()
            want = _outputs(run(cpu_mod, cpu_in))
            cpu_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
            if kind == "sample":
                # hundreds of denoiser calls: the compared run is timed
                # (its first call meets the shapes an earlier entry ran)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                got = _outputs(run(dev_mod, dev_in))
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                got = _outputs(run(dev_mod, dev_in))
                ms = cuda_ms(lambda: run(dev_mod, dev_in), iters=3,
                             warmup=0, kernel=False)
            peak = torch.cuda.max_memory_allocated(dev)
            inverse = None
            if name == "Glow":
                zr, _ = dev_mod.reverse(got[0])
                inverse = float((zr - dev_in[0]).abs().max())
        bar = AUX_FORWARD_RTOL if kind == "forward" else AUX_SAMPLE_RTOL
        errs = [_rel_err(g_, w) for g_, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
        ok = max(errs) <= bar and finite and \
            [g_.shape for g_ in got] == [w.shape for w in want]
        extra = ""
        if inverse is not None:
            ok = ok and inverse <= GLOW_INVERSE_ATOL
            extra = (f"; reverse of its forward within {inverse:.3g} of z "
                     f"(bar {GLOW_INVERSE_ATOL})")
        print(f"[{gpu}] phase 15: {name} ({n_params / 1e6:.3f} M params) "
              f"{list(got[0].shape)}: card vs CPU {max(errs):.3g} of the "
              f"largest magnitude (bar {bar}){extra}; card {ms:.3f} ms per "
              f"call, peak {peak / 2**20:.1f} MiB; CPU {cpu_s * 1e3:.1f} ms "
              f"({'ok' if ok else 'FAIL'})", flush=True)
        if not ok:
            failures.append(f"phase 15 {name}: card vs CPU {errs}, finite "
                            f"{finite}{extra}")
        del cpu_mod, dev_mod
    torch.cuda.empty_cache()

    # the data-prep command line: compute_utt_stats with YIN on the card
    # and on the CPU over one raw tree
    root = OUT_DIR / "aux_nets"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    f0_stats_file = ROOT / "metadata/libritts_r_f0_stats.yaml"
    f0_stats = yaml_lite.load(f0_stats_file)
    spks = AUX_SPEAKERS
    per_spk = -(-a["utts"] // len(spks))
    prompts = {"M_p-normal_s-normal_e-normal": ["a calm male voice"],
               "F_p-high_s-fast_e-normal": ["a bright female voice"]}
    rows = raw_rows({s: per_spk for s in spks}, prompts,
                    seconds=a["seconds"], f0_stats=f0_stats, seed=15)
    rows = rows[:a["utts"]]
    write_raw_corpus(root, rows, prompts, {s: ["calm"] for s in spks},
                     f0_stats_file=f0_stats_file, seed=15)
    cleaned = root / "data_prep/out/libritts_r_per_spk_cleaned"
    (root / "speakers.tsv").write_text("READER\tGENDER\tSUBSET\tNAME\n"
                                       + "".join(
        f"{s}\t{'MF'[i % 2]}\ttrain-clean-100\tr{s}\n"
        for i, s in enumerate(spks)))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        walls = {}
        card_type = torch.device(dev).type
        for device in (card_type, "cpu"):
            t0 = time.perf_counter()
            compute_utt_stats.main([
                str(cleaned), str(f0_stats_file), "--out_filename",
                str(root / f"utt_{device}.yaml"), "--num_jobs", "8",
                "--speakers_tsv", str(root / "speakers.tsv"), "--device",
                device])
            walls[device] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    card = yaml_lite.load(root / f"utt_{card_type}.yaml")
    host = yaml_lite.load(root / "utt_cpu.yaml")
    worst = max(abs(card[u][k] - v) for u, st in host.items()
                for k, v in st.items()) if host else 0.0
    # the F0 tracks under the statistics, as phase 11 holds YIN
    agree, f0_err = 1.0, 0.0
    for row in rows:
        spk = str(row["spk_id"])
        wav, sr = read_wav_any(cleaned / spk / "wav24k"
                               / f"{row['item_name']}.wav")
        st = f0_stats[spk]
        tracks = []
        for d in (dev, "cpu"):
            with torch.inference_mode():
                f0, vuv = extract_f0(
                    torch.from_numpy(wav.astype(np.float32)[None]).to(d),
                    sample_rate=sr, hop_length=int(sr * 0.005),
                    f0_floor=st["f0_floor"], f0_ceil=st["f0_ceil"])
            tracks += [f0[0].cpu().numpy(), vuv[0].cpu().numpy()]
        ag, err = _f0_agreement(*tracks)
        agree, f0_err = min(agree, ag), max(f0_err, err)
    ok = (sorted(card) == sorted(host) and len(host) == len(rows)
          and worst <= UTT_STATS_ATOL and agree >= RECIPE_VUV_AGREEMENT
          and f0_err <= RECIPE_F0_RTOL)
    secs = [r["seconds"] for r in rows]
    print(f"[{gpu}] phase 15: compute_utt_stats over {len(rows)} utterances "
          f"of {min(secs):.1f}-{max(secs):.1f} s: card "
          f"{walls[card_type]:.2f} s, CPU {walls['cpu']:.2f} s (host walls "
          "of the command line); "
          f"statistics card vs CPU within {worst:.3g} (bar "
          f"{UTT_STATS_ATOL}), F0 voicing agreement {agree:.4f} (bar "
          f"{RECIPE_VUV_AGREEMENT}), F0 rel err {f0_err:.3g} (bar "
          f"{RECIPE_F0_RTOL}) ({'ok' if ok else 'FAIL'})", flush=True)
    if not ok:
        failures.append(f"phase 15 compute_utt_stats: {sorted(card)} vs "
                        f"{sorted(host)}, worst {worst}, voicing {agree}, "
                        f"F0 {f0_err}")
    shutil.rmtree(root, ignore_errors=True)
    launches = _counts(k1, k2)
    total = time.perf_counter() - t_phase
    print(f"[{gpu}] phase 15: {total:.1f} s in all; launches {launches} (no "
          "kernel lies on this phase's path)", flush=True)
    return launches


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


def request_inputs():
    """The main path's request: one utterance of PHONES phones and its
    style prompt."""
    import numpy as np

    rng = np.random.RandomState(3)
    return ([list(rng.randint(1, 90, PHONES))],
            ["a deep calm male voice speaking slowly"])


def phase_only(phase: int) -> int:
    """Build the kernels and run phase 12, 13, 14 or 15 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.ops.kernels import _build
    from promptttspp_tpu_torch.ops.kernels import amp as k2
    from promptttspp_tpu_torch.ops.kernels import snake as k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    failures = []
    if phase == 15:
        phase_aux_nets(k1, k2, dev, gpu_line(), failures)
        if failures:
            print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
            return 1
        return 0
    vocoder = flagship.build_vocoder(dev, seed=1)
    if phase == 14:
        phase_variant(k1, k2, vocoder, dev, gpu_line(), failures)
    else:
        model = flagship.build_flagship_model(dev, seed=0,
                                              frames_per_phone=10.0)
        seqs, prompts = request_inputs()
        run = phase_parallel if phase == 12 else phase_model_axis
        run(k1, k2, model, vocoder, seqs, prompts, dev, gpu_line(), failures)
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:] in (["--phase12"], ["--phase13"], ["--phase14"],
                        ["--phase15"]):
        sys.exit(phase_only(int(sys.argv[1][-2:])))
    sys.exit(main())
