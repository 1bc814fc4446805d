"""The port's CUDA kernels on a GPU: each against its plain PyTorch version,
the wrappers' checks and launch counts, and a tiny request with the kernels
against the same request with every kernel replaced by its plain version.

Every test here carries the ``cuda`` marker and skips without a GPU (the
decision is made in a fixture). This file imports neither JAX nor the JAX
package, so it runs on a machine without them; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import contextlib
import copy
import dataclasses
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.infer import Synthesizer
from promptttspp_tpu_torch.models.bert import BertConfig
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.ops.kernels import snake as k1
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from promptttspp_tpu_torch.tools import k2_bits

K1_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_snake.py:34
K2_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_pallas_amp.py:51
# K2-bf16 against the bf16 plain version: both round AA's output to bf16,
# but AA computed in another order can round to the neighbouring bf16 value
# (one 2^-8 relative step); such flips move an output by up to ~1.5e-3 at
# gain-1 weights
K2_BF16_TOL = dict(atol=1e-2, rtol=1e-3)
K2_BF16_F32_TOL = dict(atol=3e-2, rtol=1e-2)  # tests/test_pallas_amp.py:70
# K3-bf16 against the bf16 plain block: a chain compounds K2_BF16_TOL's
# flips (a flipped operand moves the next layer's AA inputs by ~1e-3, where
# many of its bf16 operands then round the other way), and the chain of
# K2-bf16 launches itself leaves K2_BF16_TOL at the flagship's widths; so
# the block is held at the JAX package's bf16 bar, and bit for bit to that
# chain
K3_BF16_TOL = K2_BF16_F32_TOL

pytestmark = pytest.mark.cuda

# Under pytest-xdist the workers share the machine's cores, but torch's
# intra-op pool takes all of them in every worker, and the pools' threads
# then starve one another: a train-CLI test of two epochs took 78.7 s
# beside seven busy processes on 8 cores, 11.7 s with one thread. Every
# worker collects (imports) this module before it runs a test, so each
# takes its share of the cores for the whole session.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

C, MEL = 32, 20  # tests/test_train.py widths
TINY_BERT = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                       num_attention_heads=2, intermediate_size=32,
                       max_position_embeddings=32)


def tiny_model_config():
    """The port's counterpart of tests/test_train.py::tiny_model (the CPU
    parity tests hold it to that JAX twin)."""
    cfg = copy.deepcopy(flagship.MODEL)
    cfg["phoneme_embedding"]["channels"] = C
    cfg["encoder"].update(idim=C, attention_dim=C, linear_units=64,
                          num_blocks=1)
    va = cfg["variance_adaptor"]
    va["duration_predictor"].update(channels=C, num_layers=1,
                                    num_gaussians=2)
    va["pitch_predictor"].update(channels=C, num_layers=2)
    va["pitch_emb"]["out_channels"] = C
    va["frame_prior_network"].update(hidden_channels=C, out_channels=C,
                                     n_layers=1)
    cfg["prompt_encoder"].update(in_channels=32, mid_channels=32,
                                 out_channels=C)
    cfg["style_mdn"].update(in_dim=C, out_dim=C, num_gaussians=2)
    cfg["reference_encoder"].update(
        idim=MEL, gst_tokens=4, gst_heads=2, conv_layers=2,
        conv_chans_list=[4, 8], gru_units=C, gst_token_dim=C)
    cfg["decoder"].update(in_dim=C, out_dim=MEL, K_step=10)
    cfg["decoder"]["denoise_fn"].update(
        in_dim=MEL, encoder_hidden_dim=C, residual_layers=2,
        residual_channels=16, dilation_cycle_length=2)
    return cfg


def zero_dropout_config():
    """``tiny_model_config`` with every dropout rate 0."""
    cfg = tiny_model_config()
    cfg["encoder"].update(dropout_rate=0.0, positional_dropout_rate=0.0)
    va = cfg["variance_adaptor"]
    va["duration_predictor"]["dropout"] = 0.0
    va["pitch_predictor"]["dropout"] = 0.0
    va["frame_prior_network"].update(p_dropout=0.0, pos_enc_p_dropout=0.0)
    return cfg


ZERO_BERT = dataclasses.replace(TINY_BERT, hidden_dropout=0.0,
                                attention_dropout=0.0)
# the optimizer settings of the train-step tests: 1e-4 at the first update
OPT = dict(lr=1e-3, warmup_steps=10, betas=(0.9, 0.98), weight_decay=0.01)


def train_batch(seed=0, B=3, Tp=12, Tf=64, L=16, weights=(1.0, 0.0, 1.0)):
    """A numpy training batch of B rows for the tiny model: ragged phones,
    1-4 frames per phone, the diffusion steps and noise given, and
    ``batch_weight``."""
    rng = np.random.RandomState(seed)
    plens = np.array([Tp, Tp - 3, Tp - 5][:B], np.int32)
    duration = np.zeros((B, Tp), np.int32)
    for b in range(B):
        duration[b, :plens[b]] = rng.randint(1, 5, plens[b])
    flens = duration.sum(1).astype(np.int32)
    assert flens.max() <= Tf
    phoneme = rng.randint(1, 90, (B, Tp)).astype(np.int32)
    phoneme[np.arange(Tp)[None] >= plens[:, None]] = 0
    frame = (np.arange(Tf)[None] < flens[:, None])[:, :, None]
    mask = np.ones((B, L), np.int32)
    mask[1, L - 5:] = 0
    return dict(
        phoneme=phoneme, duration=duration, phone_lengths=plens,
        mel=(rng.randn(B, Tf, MEL) * frame).astype(np.float32),
        log_cf0=(rng.randn(B, Tf, 1) * frame).astype(np.float32),
        vuv=((rng.rand(B, Tf, 1) > 0.3) * frame).astype(np.float32),
        frame_lengths=flens,
        prompt_ids=(rng.randint(1, 60, (B, L)) * mask).astype(np.int32),
        prompt_mask=mask,
        batch_weight=np.asarray(weights, np.float32),
        diffusion_t=rng.randint(0, 10, B).astype(np.int32),
        diffusion_noise=rng.randn(B, Tf, MEL).astype(np.float32))


def torch_batch(batch, device="cpu"):
    """numpy batch -> tensors on ``device`` (integers as int64)."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                if np.asarray(v).dtype.kind in "iu"
                                else np.asarray(v)).to(device)
            for k, v in batch.items()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # the plain versions' convolutions and products in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(g, *shape, scale=1.0):
    return scale * torch.randn(shape, generator=g, device=g.device)


@pytest.mark.parametrize("shape", [
    (1, 153600, 32), (2, 1000, 256), (1, 77, 20), (3, 5, 8), (1, 1, 32),
    # C below a warp and not a multiple of 32, batches, T inside one run
    (2, 300, 4), (1, 1000, 12), (2, 513, 48), (2, 9, 12)])
def test_k1_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(0)
    x, alpha = _randn(g, *shape), _randn(g, shape[-1], scale=0.3)
    before = k1.antialias_snake.launches
    out = k1.antialias_snake(x, alpha)
    torch.cuda.synchronize()
    assert k1.antialias_snake.launches == before + 1
    torch.testing.assert_close(out, k1.antialias_snake_plain(x, alpha),
                               **K1_TOL)


@pytest.mark.parametrize("B,T,C,k,d", [
    (1, 3840, 256, 11, 5), (1, 2000, 32, 3, 1), (2, 777, 64, 7, 3),
    (1, 97, 128, 11, 5), (1, 5, 8, 3, 5), (2, 300, 12, 7, 1),
    (1, 50, 4, 3, 1)])
def test_k2_matches_plain(dev, B, T, C, k, d):
    """The float32 K2 (3xTF32 on the tensor cores) against the float32
    plain version at the JAX package's float32 tolerance, and against
    itself: two launches are equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(1)
    args = (_randn(g, B, T, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=0.05), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=0.05),
            _randn(g, C, scale=0.1), d)
    before = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
    out = k2.amp_layer(*args)
    again = k2.amp_layer(*args)
    torch.cuda.synchronize()
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == (
        before[0] + 4, before[1])
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args), **K2_TOL)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_k2_float32_at_flagship_widths(dev, C, k, d):
    """The float32 K2 at the flagship's (C, k, d) (weights of gain 1 at
    most, as in chip_smoke.py) against the float32 plain version, and two
    launches equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(6)
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    args = (_randn(g, 1, 1500, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=ws), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=ws),
            _randn(g, C, scale=0.1), d)
    out = k2.amp_layer(*args)
    torch.testing.assert_close(out, k2.amp_layer(*args), atol=0, rtol=0)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args), **K2_TOL)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_k2_bf16_matches_plain(dev, C, k, d):
    """K2-bf16 at the flagship's widths and kernel sizes (weights of gain 1
    at most, as in chip_smoke.py) against the bf16 plain version, against
    the float32 one at the JAX package's bf16 tolerance, and against
    itself: two launches are equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(4)
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    args = (_randn(g, 1, 1500, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=ws), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=ws),
            _randn(g, C, scale=0.1), d)
    before = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
    out = k2.amp_layer(*args, bf16=True)
    again = k2.amp_layer(*args, bf16=True)
    torch.cuda.synchronize()
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == (
        before[0], before[1] + 4)
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args, bf16=True),
                               **K2_BF16_TOL)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args),
                               **K2_BF16_F32_TOL)


@pytest.mark.parametrize("B,T,C,k,d", [
    (2, 777, 64, 7, 3), (1, 5, 8, 3, 5), (2, 300, 12, 7, 1),
    (1, 97, 48, 11, 5), (1, 200, 80, 3, 3), (1, 100, 512, 3, 1),
    (1, 1, 4, 3, 1)])
def test_k2_bf16_at_other_shapes(dev, B, T, C, k, d):
    """Batches, ragged and tiny T, and channel counts that the kernel pads
    (C not a multiple of 16, output passes partly empty, C > 256)."""
    g = torch.Generator(device=dev).manual_seed(5)
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    args = (_randn(g, B, T, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=ws), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=ws),
            _randn(g, C, scale=0.1), d)
    out = k2.amp_layer(*args, bf16=True)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args, bf16=True),
                               **K2_BF16_TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,T,C,k,d", [
    (1, 300, 1, 3, 1), (2, 77, 2, 7, 3), (1, 500, 3, 11, 5),
    (2, 129, 6, 3, 5), (1, 64, 12, 7, 1), (1, 200, 5, 3, 3),
    (1, 150, 33, 7, 1), (1, 90, 130, 3, 1)])
def test_k2_takes_every_channel_count(dev, bf16, B, T, C, k, d):
    """F5: both precisions take the odd and small channel counts that the
    JAX ``AMPLayer`` serves (ragged T and batches too), held to their plain
    versions at the usual tolerances; two launches are equal bit for
    bit."""
    g = torch.Generator(device=dev).manual_seed(8)
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    args = (_randn(g, B, T, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=ws), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=ws),
            _randn(g, C, scale=0.1), d)
    out = k2.amp_layer(*args, bf16=bf16)
    torch.testing.assert_close(out, k2.amp_layer(*args, bf16=bf16),
                               atol=0, rtol=0)
    if bf16:
        torch.testing.assert_close(out, k2.amp_layer_plain(*args, bf16=True),
                                   **K2_BF16_TOL)
        torch.testing.assert_close(out, k2.amp_layer_plain(*args),
                                   **K2_BF16_F32_TOL)
    else:
        torch.testing.assert_close(out, k2.amp_layer_plain(*args), **K2_TOL)


@pytest.mark.parametrize("conv_precision", ["default", "highest"])
def test_vocoder_with_a_two_channel_stage(dev, conv_precision):
    """F5: a vocoder whose last upsample stage has 2 channels (the narrow
    vocoder of tests/test_e2e_cli.py) runs its AMPLayers through K2 in
    either precision, within the tolerance of its plain versions."""
    cfg = dict(flagship.VOCODER, in_channel=MEL, upsample_initial_channel=32,
               harmonic_num=3, resblock_kernel_sizes=[3],
               resblock_dilations=[[1, 3]], conv_precision=conv_precision)
    vocoder = flagship.build_vocoder(dev, 3, cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    mel = _randn(g, 1, 24, MEL)
    f0 = torch.full((1, 24, 1), 150.0, device=dev)
    before = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
    with torch.no_grad():
        wav = vocoder(mel, f0, deterministic=True)
        after = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
        with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
                mock.patch.object(k1, "antialias_snake",
                                  k1.antialias_snake_plain):
            ref = vocoder(mel, f0, deterministic=True)
    n = 4 * 2 * 2  # 4 stages x 2 layers x 2 launches
    bf16 = conv_precision == "default"
    assert after == (before[0] + (0 if bf16 else n),
                     before[1] + (n if bf16 else 0))
    assert wav.shape == (1, 24 * 240, 1) and torch.isfinite(wav).all()
    torch.testing.assert_close(wav, ref, atol=1e-2 if bf16 else 1e-4,
                               rtol=0)


def _flagship_layers():
    """(C, T, k, d) of every launch shape of a 640-frame request's
    AMPLayers: each stage's (C, T), kernel size and conv1 dilation."""
    cfg, out, T = flagship.VOCODER, [], 640
    for i, u in enumerate(cfg["upsample_rates"]):
        T *= u
        C = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        out += [(C, T, k, d) for k, dils in zip(cfg["resblock_kernel_sizes"],
                                                cfg["resblock_dilations"])
                for d in dils]
    return out


def _layer_args(g, B, T, C, k, d):
    ws = min(0.05, 1.0 / math.sqrt(k * C))
    return (_randn(g, B, T, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=ws), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=ws),
            _randn(g, C, scale=0.1), d)


@pytest.mark.parametrize("C,T,k,d", _flagship_layers())
def test_k2_bf16_at_the_flagship_layers(dev, C, T, k, d):
    """The wgmma K2-bf16 at each of the 36 AMPLayer shapes of a 640-frame
    request (full T) against the bf16 plain version and the float32 one,
    equal bit for bit to the mma.sync kernel and to itself, with two
    launches per layer counted in ``launches_bf16``."""
    g = torch.Generator(device=dev).manual_seed(11)
    args = _layer_args(g, 1, T, C, k, d)
    before = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
    out = k2.amp_layer(*args, bf16=True)
    again = k2.amp_layer(*args, bf16=True)
    torch.cuda.synchronize()
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == (
        before[0], before[1] + 4)
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    torch.testing.assert_close(out, k2.amp_layer_mma_sync(*args), atol=0,
                               rtol=0)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args, bf16=True),
                               **K2_BF16_TOL)
    torch.testing.assert_close(out, k2.amp_layer_plain(*args),
                               **K2_BF16_F32_TOL)


@pytest.mark.parametrize("B,T,C,k,d", [
    (2, 777, 64, 7, 3), (1, 5, 8, 3, 5), (2, 300, 12, 7, 1),
    (1, 97, 48, 11, 5), (1, 200, 80, 3, 3), (1, 100, 512, 3, 1),
    (2, 1000, 256, 11, 5), (3, 333, 128, 7, 5), (1, 1, 4, 3, 1)])
def test_k2_bf16_equals_the_mma_sync_kernel(dev, B, T, C, k, d):
    """Batches, ragged and tiny T, padded channel counts, several output
    passes: the wgmma kernel sums every output in the mma.sync kernel's
    order, and its output equals that kernel's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(12)
    args = _layer_args(g, B, T, C, k, d)
    torch.testing.assert_close(k2.amp_layer(*args, bf16=True),
                               k2.amp_layer_mma_sync(*args), atol=0, rtol=0)


def test_k2_bf16_in_a_cuda_graph(dev):
    """Two AMPLayers (four launches, one of them a C = 256 layer whose
    weights stream) captured in a CUDA graph and replayed on new inputs
    give the eager launches' output bit for bit: the kernel allocates
    nothing, does not synchronise and launches on the current stream."""
    g = torch.Generator(device=dev).manual_seed(13)
    a = _layer_args(g, 1, 2000, 256, 11, 5)
    b = _layer_args(g, 1, 4000, 32, 7, 3)
    xa, xb = a[0].clone(), b[0].clone()
    k2.amp_layer(xa, *a[1:], bf16=True)  # weight layouts prepared
    k2.amp_layer(xb, *b[1:], bf16=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ya = k2.amp_layer(xa, *a[1:], bf16=True)
        yb = k2.amp_layer(xb, *b[1:], bf16=True)
    for seed in (14, 15):
        g2 = torch.Generator(device=dev).manual_seed(seed)
        xa.copy_(_randn(g2, *xa.shape, scale=0.3))
        xb.copy_(_randn(g2, *xb.shape, scale=0.3))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(ya, k2.amp_layer(xa, *a[1:], bf16=True),
                                   atol=0, rtol=0)
        torch.testing.assert_close(yb, k2.amp_layer(xb, *b[1:], bf16=True),
                                   atol=0, rtol=0)


def test_kernel_weight_wgmma_on_the_card(dev):
    """K2-bf16's weight layout made on the card equals the one made on the
    CPU, is prepared once, and again after an in-place update."""
    w = torch.randn(64, 64, 7, device=dev)
    w_k = k2.kernel_weight_wgmma(w)
    assert k2.kernel_weight_wgmma(w) is w_k
    assert torch.equal(w_k.cpu(), k2.kernel_weight_wgmma(w.cpu()))
    w.mul_(2.0)
    assert k2.kernel_weight_wgmma(w) is not w_k


def test_kernel_weight_bf16_layout(dev):
    """[k, NP, CP] bf16: [tap][out][in], rounded to nearest even, zero in
    the padding, prepared once and again after an in-place update."""
    w = torch.randn(12, 12, 3, device=dev)
    w_k = k2.kernel_weight_bf16(w)
    assert k2.kernel_weight_bf16(w) is w_k
    assert w_k.dtype == torch.bfloat16 and w_k.shape[0] == 3
    assert w_k.shape[1] >= 12 and w_k.shape[2] == 16
    torch.testing.assert_close(w_k[:, :12, :12],
                               w.permute(2, 0, 1).to(torch.bfloat16),
                               atol=0, rtol=0)
    assert not w_k[:, 12:].any() and not w_k[:, :, 12:].any()
    w.mul_(2.0)
    assert k2.kernel_weight_bf16(w) is not w_k


def test_kernel_weight_tf32x3_layout(dev):
    """[k, NP, CP] float32: the bf16 layout's shape, the weights unrounded,
    zero in the padding, prepared once and again after an in-place
    update."""
    w = torch.randn(12, 12, 3, device=dev)
    w_k = k2.kernel_weight_tf32x3(w)
    assert k2.kernel_weight_tf32x3(w) is w_k
    assert w_k.dtype == torch.float32
    assert w_k.shape == k2.kernel_weight_bf16(w).shape
    torch.testing.assert_close(w_k[:, :12, :12], w.permute(2, 0, 1),
                               atol=0, rtol=0)
    assert not w_k[:, 12:].any() and not w_k[:, :, 12:].any()
    w.mul_(2.0)
    assert k2.kernel_weight_tf32x3(w) is not w_k


@pytest.mark.parametrize("case", k2_bits.CASES, ids=str)
def test_k2_bf16_bits_equal_the_earlier_kernel(dev, case):
    """K2-bf16 gives the output bits of its kernel from before its source
    took the float32 K2 as a second mix (``tools/k2_bits.py``)."""
    out = k2.amp_layer(*k2_bits.inputs(case, dev), bf16=True)
    assert k2_bits.fingerprint(out) == k2_bits.EARLIER[case]


def _block_args(g, B, T, C, k, dils):
    """Inputs scaled as in tests/test_pallas_amp.py:85-93, with the conv
    weights capped at gain 1 (scale 1/sqrt(k*C)): at scale 0.05 a C=256,
    k=11 conv has gain 2.65, and the six convs of a block amplify float32
    rounding ~350-fold."""
    w_scale = min(0.05, 1.0 / math.sqrt(k * C))
    x = _randn(g, B, T, C, scale=0.3)
    params = tuple(
        (_randn(g, C, scale=0.2), _randn(g, C, C, k, scale=w_scale),
         _randn(g, C, scale=0.1), _randn(g, C, scale=0.2),
         _randn(g, C, C, k, scale=w_scale), _randn(g, C, scale=0.1))
        for _ in dils)
    return x, params


def _k3_launches():
    return k2.amp_block.launches, k2.amp_block.launches_bf16


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,T,C,k,dils", [
    # tests/test_pallas_amp.py:74-79
    (1, 400, 32, 3, (1, 3, 5)), (1, 200, 64, 7, (1, 3, 5)),
    (1, 300, 128, 3, (1, 3)), (1, 150, 256, 3, (1, 3, 5)),
    # flagship blocks (shorter T), both memory paths, ragged and tiny T
    (1, 3840, 256, 11, (1, 3, 5)), (1, 2000, 128, 7, (1, 3, 5)),
    (2, 777, 64, 11, (1, 3, 5)), (1, 5, 32, 7, (1, 3, 5)),
    # more tiles than resident blocks: each block walks over several
    (1, 153600, 32, 11, (1, 3, 5)), (1, 76800, 64, 7, (1, 3, 5))])
def test_k3_matches_plain(dev, B, T, C, k, dils, bf16):
    g = torch.Generator(device=dev).manual_seed(2)
    x, params = _block_args(g, B, T, C, k, dils)
    before = _k3_launches()
    out = k2.amp_block(x, params, dils, bf16=bf16)
    again = k2.amp_block(x, params, dils, bf16=bf16)
    torch.cuda.synchronize()
    assert _k3_launches() == (before[0] + 2 * (not bf16),
                              before[1] + 2 * bf16)
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    torch.testing.assert_close(
        out, k2.amp_block_plain(x, params, dils, bf16=bf16),
        **(K3_BF16_TOL if bf16 else K2_TOL))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_k3_equals_the_chain_of_k2_launches(dev, C, k, bf16):
    """K3 sums each layer in the order of the K2 of its precision (3xTF32
    or bf16 on the tensor cores), so it equals the chain of K2 launches bit
    for bit, at each of the flagship's widths and kernel sizes."""
    g = torch.Generator(device=dev).manual_seed(2)
    dils = (1, 3, 5)
    x, params = _block_args(g, 1, 1000, C, k, dils)
    chain = x
    for p, d in zip(params, dils):
        chain = k2.amp_layer(chain, *p, d, bf16=bf16)
    torch.testing.assert_close(k2.amp_block(x, params, dils, bf16=bf16),
                               chain, atol=0, rtol=0)


def test_k3_refuses_other_shapes(dev):
    """The shapes K3 refused before it took every shape of JAX's
    ``fused_amp_block`` (C = 48 and 512, k = 5, dilations (1, 2), four
    layers, and a chain longer than one launch takes) compute the plain
    version's result, equal to the chain of K2 launches; an even k,
    mismatched layer and dilation lists and a parameter on another device
    still raise."""
    g = torch.Generator(device=dev).manual_seed(3)
    longest = k2._block_lib().amp_block_max_layers()
    for C, k, dils in ((48, 3, (1, 3, 5)), (32, 5, (1, 3, 5)),
                       (32, 3, (1, 2)), (512, 3, (1, 3, 5, 7)),
                       (16, 3, (1, 2) * longest + (3,))):
        x, params = _block_args(g, 1, 300, C, k, dils)
        for bf16 in (False, True):
            before = _k3_launches()
            out = k2.amp_block(x, params, dils, bf16=bf16)
            launches = -(-len(dils) // longest)
            assert _k3_launches() == (before[0] + launches * (not bf16),
                                      before[1] + launches * bf16)
            chain = x
            for p, d in zip(params, dils):
                chain = k2.amp_layer(chain, *p, d, bf16=bf16)
            torch.testing.assert_close(out, chain, atol=0, rtol=0)
            torch.testing.assert_close(
                out, k2.amp_block_plain(x, params, dils, bf16=bf16),
                **(K3_BF16_TOL if bf16 else K2_TOL))
    x, params = _block_args(g, 1, 64, 32, 4, (1, 3, 5))
    with pytest.raises(ValueError, match="odd k"):
        k2.amp_block(x, params, (1, 3, 5))
    x, params = _block_args(g, 1, 64, 32, 3, (1, 3, 5))
    with pytest.raises(ValueError, match="dilations"):
        k2.amp_block(x, params, (1, 3))
    with pytest.raises(ValueError, match="is on"):
        k2.amp_block(x, params[:1] + ((params[1][0].cpu(),)
                                      + params[1][1:],) + params[2:],
                     (1, 3, 5))


def test_kernel_weight_layout_is_prepared_once(dev):
    """K3 takes the weight layouts of the K2 of its precision, prepared
    once per weight and shared, and again after an in-place update."""
    g = torch.Generator(device=dev).manual_seed(4)
    x, params = _block_args(g, 1, 64, 32, 3, (1,))
    w = params[0][1]
    w_k = {}
    for bf16, layout in ((False, k2.kernel_weight_tf32x3),
                         (True, k2.kernel_weight_wgmma)):
        w_k[bf16] = layout(w)
        k2.amp_block(x, params, (1,), bf16=bf16)
        assert layout(w) is w_k[bf16]
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update prepares it again
    assert k2.kernel_weight_tf32x3(w) is not w_k[False]
    torch.testing.assert_close(k2.kernel_weight_tf32x3(w)[:, :32, :32],
                               w.permute(2, 0, 1), atol=0, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 64, 32, device=dev)
    alpha = torch.zeros(32, device=dev)
    with pytest.raises(TypeError):
        k1.antialias_snake(x.double(), alpha.double())
    with pytest.raises(ValueError, match="contiguous"):
        k1.antialias_snake(x.transpose(1, 2).contiguous().transpose(1, 2),
                           alpha)
    with pytest.raises(ValueError, match="is on"):
        k1.antialias_snake(x, alpha.cpu())
    w = torch.zeros(30, 30, 3, device=dev)
    w4 = torch.zeros(30, 30, 4, device=dev)
    b = torch.zeros(30, device=dev)
    x30 = torch.zeros(1, 64, 30, device=dev)
    for bf16 in (False, True):
        # any C is taken (F5); an even k, another device or dtype is not
        assert k2.amp_layer(x30, b, w, b, b, w, b, 1, bf16=bf16).shape == (
            1, 64, 30)
        with pytest.raises(ValueError, match="odd k"):
            k2.amp_layer(x30, b, w4, b, b, w4, b, 1, bf16=bf16)
        with pytest.raises(ValueError, match="is on"):
            k2.amp_layer(x30, b.cpu(), w, b, b, w, b, 1, bf16=bf16)
        with pytest.raises(TypeError):
            k2.amp_layer(x30.double(), b, w, b, b, w, b, 1, bf16=bf16)


class Tok:
    pad_id = 0

    def batch_encode(self, prompts):
        ids = np.arange(1, 10)[None].repeat(len(prompts), 0)
        return ids, np.ones_like(ids)


def _tiny_synth(dev, conv_precision="default", **kw):
    model = flagship.bias_duration_head(
        flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT), 3.0)
    voc_cfg = dict(flagship.VOCODER, in_channel=MEL,
                   upsample_initial_channel=64,
                   resblock_kernel_sizes=[3, 7],
                   resblock_dilations=[[1, 3], [1, 5]],
                   conv_precision=conv_precision)
    vocoder = flagship.build_vocoder(dev, 1, voc_cfg)
    return Synthesizer(model, vocoder, tokenizer=Tok(), device=dev, **kw)


SEQS, PROMPTS = [[5, 9, 22, 40, 3, 17, 64]], ["a calm voice"]


@pytest.mark.parametrize("conv_precision", ["default", "highest"])
def test_tiny_request_kernels_match_plain_versions(dev, conv_precision):
    """A "default" vocoder launches only K2-bf16, a "highest" one only the
    float32 K2; with the plain versions patched in, ``AMPLayer`` passes the
    same ``bf16`` to ``amp_layer_plain``. The bf16 wav's tolerance covers
    the A rounding flips of K2_BF16_TOL carried through the later layers."""
    synth = _tiny_synth(dev, conv_precision)
    frames = 128  # 7 phones x 3 frames, bucketed
    x_T = torch.randn((1, frames, MEL), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    kw = dict(noise_scale=0.0, x_T=x_T, zero_noise=True)
    n1 = k1.antialias_snake.launches
    n2 = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
    wav_k, mel_k = synth.synthesize(SEQS, PROMPTS, **kw)
    assert k1.antialias_snake.launches == n1 + 1
    per_request = 2 * 2 * 4 * 2  # 2 launches per layer
    bf16 = conv_precision == "default"
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == (
        n2[0] + (0 if bf16 else per_request),
        n2[1] + (per_request if bf16 else 0))
    with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
            mock.patch.object(k1, "antialias_snake",
                              k1.antialias_snake_plain):
        wav_p, mel_p = synth.synthesize(SEQS, PROMPTS, **kw)
    assert wav_k[0].shape == (21 * 240,)
    np.testing.assert_array_equal(mel_k[0], mel_p[0])
    np.testing.assert_allclose(wav_k[0], wav_p[0],
                               atol=1e-2 if bf16 else 1e-4)


def test_async_dispatch_does_not_synchronize(dev):
    """Once the request's shapes have been seen, ``synthesize_async``
    queues a prompted and a reference-wav request without one
    synchronizing CUDA call (torch's sync debug mode raises on any).
    Staging a request's inputs, where all its host -> device copies are
    made, does not wait for the device: a spin kernel queued before still
    runs when it returns. ``result()`` equals ``synthesize``."""
    synth = _tiny_synth(dev, speculative=True, spec_frames_per_phone=4.0,
                        to_mel=MelSpectrogramTransform(n_mels=MEL))
    wav = np.random.RandomState(6).randn(12000).astype(np.float32) * 0.1
    ref = [synth.synthesize(SEQS, PROMPTS, seed=4)[0][0],
           synth.synthesize(SEQS, reference_wavs=[wav], seed=4)[0][0]]
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # about 0.5 s at 1.98 GHz
    spin_done = torch.cuda.Event()
    spin_done.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synth._request(SEQS, PROMPTS, None, None, True, 0.5, 4)
        synth._request(SEQS, None, None, [wav], True, 0.5, 4)
        assert not spin_done.query()
        handles = [synth.synthesize_async(SEQS, PROMPTS, seed=4),
                   synth.synthesize_async(SEQS, reference_wavs=[wav],
                                          seed=4)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for handle, want in zip(handles, ref):
        np.testing.assert_array_equal(handle.result()[0][0], want)
    assert (synth.spec_requests, synth.spec_mispredicts) == (4, 0)


def test_reference_mel_request(dev):
    synth = _tiny_synth(dev)
    ref = np.random.RandomState(0).randn(90, MEL).astype(np.float32)
    wavs, mels = synth.synthesize(SEQS, reference_mels=[ref], seed=1)
    assert wavs[0].shape == (21 * 240,) and np.isfinite(wavs[0]).all()
    assert mels[0].shape == (21, MEL)


def _decode_both(decoder, cond, **kw):
    """(eager, graph) decodes of ``cond``, each from a generator seeded
    alike."""
    from promptttspp_tpu_torch.models import decode_graph

    seed = kw.pop("seed", 5)
    gen = lambda: torch.Generator(device=cond.device).manual_seed(seed)
    with torch.inference_mode():
        eager = decoder.inference(cond, generator=gen(), **kw)
    return eager, decode_graph.decode(decoder, cond, generator=gen(), **kw)


@pytest.mark.parametrize("sampler", ["ancestral", "x_T+zero_noise",
                                     "plms"])
def test_graph_decode_equals_eager(dev, sampler):
    """The decode's CUDA graph gives the eager decode's bits: the
    ancestral sampler with its noise drawn from the generator, with
    ``x_T`` and ``zero_noise``, and PLMS. A second replay at another seed
    equals its own eager decode, so each replay reads its own draws."""
    from promptttspp_tpu_torch.models import decode_graph

    model = flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT)
    decoder = model.decoder.clone(pndm_speedup=5) if sampler == "plms" \
        else model.decoder
    g = torch.Generator(device=dev).manual_seed(3)
    cond = _randn(g, 2, 128, C)
    kw = {}
    if sampler == "x_T+zero_noise":
        kw = dict(x_T=_randn(g, 2, 128, MEL), zero_noise=True)
    eager, graph = _decode_both(decoder, cond, **kw)
    assert graph.shape == (2, 128, MEL) and torch.isfinite(graph).all()
    torch.testing.assert_close(graph, eager, atol=0, rtol=0)
    eager2, graph2 = _decode_both(decoder, cond, seed=6, **kw)
    torch.testing.assert_close(graph2, eager2, atol=0, rtol=0)
    # a fixed x_T and zero noise leave nothing to the seed
    assert (sampler != "x_T+zero_noise") == bool((graph2 != graph).any())
    assert [(c["B"], c["T"]) for c in decode_graph.captured(decoder)] == [
        (2, 128)]


def test_decode_is_float32_whatever_the_tf32_flags(dev):
    """With TF32 switched on for cuDNN and cuBLAS, the decode (eager and
    captured) gives the bits it gives with TF32 off, and the caller's
    flags are as they were after it."""
    model = flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT)
    cond = _randn(torch.Generator(device=dev).manual_seed(4), 1, 256, C)
    off = _decode_both(model.decoder, cond)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = _decode_both(model.decoder.clone(), cond)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_async_requests_on_one_bucket(dev):
    """Two ``synthesize_async`` requests in flight on one frame bucket
    share its graph's buffers; each result equals its two-phase twin."""
    synth = _tiny_synth(dev)
    spec = Synthesizer(synth.model, synth.vocoder, tokenizer=Tok(),
                       device=dev, speculative=True,
                       spec_frames_per_phone=4.0)
    want = [synth.synthesize(SEQS, PROMPTS, seed=s)[0][0] for s in (1, 2)]
    handles = [spec.synthesize_async(SEQS, PROMPTS, seed=s) for s in (1, 2)]
    got = [h.result()[0][0] for h in handles]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], got[1])
    assert spec.spec_mispredicts == 0


def test_decode_span_opens_before_its_device_work(dev):
    """The program's spans and the profiler's device timestamps share one
    clock on the card: under a CUDA-only profiler (which turns recording
    on), every device operation launched inside the ``synth.decode`` span
    of a request that waits for nothing earlier starts after the span's
    start, the graph's replay among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from promptttspp_tpu_torch.utils import trace

    synth = _tiny_synth(dev, speculative=True, spec_frames_per_phone=4.0)
    synth.synthesize(SEQS, PROMPTS, seed=3)  # captures the decode graph
    torch.cuda.synchronize()
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            synth.synthesize(SEQS, PROMPTS, seed=3)
        (decode,) = [s for s in trace.spans() if s.name == "synth.decode"]
    finally:
        trace.clear()
    events = list(prof.profiler.kineto_results.events())
    launched = {e.correlation_id() for e in events
                if e.device_type() == DeviceType.CPU
                and e.name().startswith(("cuda", "cu"))
                and decode.start_ns <= e.start_ns() <= decode.end_ns}
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and e.correlation_id() in launched]
    assert any(e.name() == "cudaGraphLaunch" for e in events)
    assert device, "no device operation correlates with a launch in the span"
    assert min(e.start_ns() for e in device) >= decode.start_ns


def test_prewarmed_shape_captures_nothing_new(dev):
    """``prewarm`` captures the decode graph of each grid entry's frame
    bucket; a request on a prewarmed shape then captures nothing."""
    from promptttspp_tpu_torch.models import decode_graph

    synth = _tiny_synth(dev, speculative=True, spec_frames_per_phone=4.0)
    rows = synth.prewarm(prompt_lens=(16,), max_phones=16)
    assert {(r["Tp"], r["Tf"]) for r in rows} == {(16, 128)}
    before = decode_graph.captured(synth.model.decoder)
    assert [(c["B"], c["T"]) for c in before] == [(1, 128)]
    synth.synthesize(SEQS, PROMPTS, seed=3)
    assert decode_graph.captured(synth.model.decoder) == before


def test_failed_capture_raises(dev):
    """A decode whose capture fails (here: an error raised inside the
    captured loop, only while it is captured) raises instead of running
    eagerly, keeps no graph, and leaves the decoder usable."""
    from promptttspp_tpu_torch.models import decode_graph

    model = flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT)
    decoder = model.decoder
    cond = _randn(torch.Generator(device=dev).manual_seed(5), 1, 128, C)
    denorm = decoder._denorm

    def failing(x):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced capture failure")
        return denorm(x)

    with mock.patch.object(decoder, "_denorm", failing):
        with pytest.raises(RuntimeError, match="forced capture failure"):
            decode_graph.decode(decoder, cond)
    assert decode_graph.captured(decoder) == []
    eager, graph = _decode_both(decoder, cond)
    torch.testing.assert_close(graph, eager, atol=0, rtol=0)


# The tiny model and vocoder of the CLI tests, as command-line overrides of
# conf/synthesize.yaml (the model's equal tests/test_e2e_cli.py's
# TINY_MODEL_OVERRIDES; tests/test_torch_cli.py holds them equal). The
# vocoder is that file's too: 16, 8, 4 and 2 channels after its four
# upsamples.
TINY_CLI_MODEL = [
    "model.phoneme_embedding.channels=64",
    "model.encoder.idim=64", "model.encoder.attention_dim=64",
    "model.encoder.linear_units=128", "model.encoder.num_blocks=1",
    "model.decoder.denoise_fn.residual_layers=2",
    "model.decoder.denoise_fn.residual_channels=32",
    "model.variance_adaptor.frame_prior_network.n_layers=1",
    "model.prompt_encoder.in_channels=64",
    "model.prompt_encoder.mid_channels=64",
    "+model.prompt_encoder.bert_num_layers=1",
    "+model.prompt_encoder.bert_num_heads=4",
    "model.reference_encoder.conv_chans_list=[4,4,8,8,16,16]",
    "+model.reference_encoder.gst_token_dim=64",
]
TINY_CLI_VOCODER = ["vocoder.upsample_initial_channel=32",
                    "vocoder.harmonic_num=3",
                    "vocoder.resblock_kernel_sizes=[3]",
                    "vocoder.resblock_dilations=[[1,3]]"]
CLI_PROMPTS = {"K1": ["a man speaks slowly with low voice",
                      "a calm low slow male voice"],
               "K2": ["A woman speaks fast, with a bright voice",
                      "a bright quick female voice", "fast and clear"]}
CLI_ROWS = [dict(spk_id=11, item_name="utt_11_0", style_prompt_key="K1",
                 seq=[5, 17, 33, 45, 8, 61, 29, 74, 5, 50, 12]),
            dict(spk_id=22, item_name="utt_22_1", style_prompt_key="K2",
                 seq=[2, 19, 44, 71, 3, 60, 28, 15, 40, 66, 21, 8, 35, 50]),
            dict(spk_id=22, item_name="utt_22_2", style_prompt_key="K2",
                 seq=[9, 30, 5, 44])]


def tiny_cli_overrides():
    return TINY_CLI_MODEL + TINY_CLI_VOCODER


def write_tiny_cli_setup(root, frames_per_phone=3.0):
    """A synthetic corpus under ``root`` (``tools/synthetic_corpus.py``,
    1.5 s wavs, a 64-token vocabulary) and reference-format checkpoints of
    a seeded tiny model and vocoder (the model's duration head biased to
    about ``frames_per_phone``; the vocoder's convolutions weight-normed) ->
    the CLI's arguments for them, without ``device``."""
    from pathlib import Path

    from promptttspp_tpu_torch.bin import conf
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
    from promptttspp_tpu_torch.tools.synthetic_corpus import write_corpus

    root = Path(root)
    write_corpus(root, CLI_ROWS, CLI_PROMPTS, vocab_size=64,
                 wav_seconds=1.5, mel_mean=-4.2, mel_std=2.3)
    cfg = conf.compose("synthesize", tiny_cli_overrides())
    model = flagship.bias_duration_head(
        flagship.build_model(cfg["model"], "cpu", seed=7), frames_per_phone)
    # durations that vary with the phone and the style (log-duration std
    # about 0.4)
    g = torch.Generator().manual_seed(9)
    head = model.variance_adaptor.duration_predictor.out_layer
    head.mu.weight.copy_(0.05 * torch.randn(head.mu.weight.shape,
                                            generator=g))
    torch.save({"epoch": 3, "model": to_reference_state_dict(model),
                "optimizer": {}}, root / "model.ckpt")
    vocoder = flagship.build_vocoder("cpu", seed=8, cfg=cfg["vocoder"])
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    return [f"path.root={root}", f"model_ckpt={root / 'model.ckpt'}",
            f"vocoder_ckpt={root / 'vocoder.ckpt'}", *tiny_cli_overrides()]


def test_synthesize_cli_on_the_card(dev, tmp_path):
    """The port's synthesize CLI, run in-process on the card (its default
    device) on a tiny corpus and tiny checkpoints: the eval tree, its
    finish marker and finite 24 kHz wavs of 240 samples per frame."""
    import os

    from scipy.io import wavfile

    from promptttspp_tpu_torch.bin import synthesize as cli

    argv = write_tiny_cli_setup(tmp_path / "corpus")
    out = tmp_path / "out"
    cwd = os.getcwd()
    try:
        cli.main(argv + [f"output_dir={out}", f"hydra.run.dir={tmp_path}",
                         "num_eval_utts=2"])
    finally:
        os.chdir(cwd)
    wavs = sorted(p.relative_to(out).as_posix() for p in out.rglob("*.wav"))
    assert wavs == [f"{s}/{m}/wav/{u}.wav" for s, u in
                    (("11", "utt_11_0"), ("22", "utt_22_1"))
                    for m in ("prompt", "ref")]
    assert (out / "finish").read_text() == "finish"
    for p in out.rglob("*.wav"):
        sr, data = wavfile.read(p)
        assert sr == 24000 and data.dtype == np.int16
        assert len(data) > 0 and len(data) % 240 == 0


def test_train_step_on_the_card_equals_the_cpu_step(dev):
    """One ``TrainState.train_step`` of the tiny model (dropout 0, the
    diffusion steps and noise given, a row of weight 0) on the card and on
    the CPU from the same weights: the losses and grad_norm within 1e-4 /
    1e-3, every parameter and BatchNorm statistic after the update within
    1e-5 (cuDNN's backward sums in another order)."""
    from promptttspp_tpu_torch.train.state import TrainState

    cpu = flagship.build_model(zero_dropout_config(), "cpu", 0, ZERO_BERT)
    gpu = flagship.build_model(zero_dropout_config(), dev, 0, ZERO_BERT)
    gpu.load_state_dict(cpu.state_dict())
    outs = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        state = TrainState(model, seed=0, **OPT)
        outs.append(state.train_step(torch_batch(train_batch(), d)))
    for k, v in outs[0].items():
        np.testing.assert_allclose(outs[1][k].item(), v.item(), atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    ref = cpu.state_dict()
    for k, v in gpu.state_dict().items():
        torch.testing.assert_close(v.cpu(), ref[k], atol=1e-5, rtol=0,
                                   msg=k)


def test_weighted_batchnorm_train_mode_on_both_devices(dev):
    """``WeightedBatchNorm`` in train mode with row weights (1, 0, 1) on the
    card and on the CPU: output and the updated running statistics."""
    from promptttspp_tpu_torch.nn.layers import WeightedBatchNorm

    g = torch.Generator().manual_seed(3)
    for shape in ((3, 6, 17), (3, 4, 9, 5)):
        x = torch.randn(shape, generator=g) * 2 + 0.5
        w = torch.tensor([1.0, 0.0, 1.0])
        out = []
        for d in ("cpu", dev):
            bn = WeightedBatchNorm(shape[1]).to(d).train()
            out.append((bn(x.to(d), w.to(d)), bn.running_mean,
                        bn.running_var))
        for a, b in zip(*out):
            torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=1e-5)


# -- training's options: bf16, the prefetching pipeline, the C++ loader ----

def _loader_corpus(root):
    """A 12-utterance training corpus of 20-mel features under ``root``
    -> (dataset factory, collator, batches)."""
    from pathlib import Path

    from promptttspp_tpu_torch.data import dataset
    from promptttspp_tpu_torch.data.collate import PromptTTSCollator
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_training_corpus)

    meta = Path(__file__).resolve().parent.parent / "metadata"
    cands = dataset.read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = dataset.read_spk_prompt_candidate(
        meta / "speaker_prompt_candidates.csv")
    cands = {k: cands[k] for k in sorted(cands)[:8]}
    spk = {k: spk[k] for k in sorted(spk)[:6]}
    write_training_corpus(root, training_rows(
        12, cands, spk, (4, 12), (1, 5), valid_every=100, seed=2), cands,
        spk, vocab_size=4000, n_mels=20, seed=3)
    d = root / "dump/libritts_r_per_spk_cleaned"

    def make_ds():
        return dataset.AllWithSpkPromptNormDataset(
            d / "df_filtered/trn.csv", root / "data_prep", d / "feats",
            d / "mel63", root / "metadata/style_prompt_candidates.csv",
            root / "metadata/speaker_prompt_candidates.csv", seed=7)

    collator = PromptTTSCollator(WordPieceTokenizer.from_vocab_file(
        root / "metadata/bert-base-uncased-vocab.txt"))
    return make_ds, collator, [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9, 10, 11]]


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_prefetch_on_the_card_equals_the_sync_batches(dev, tmp_path,
                                                      native):
    """prefetch_batches onto the card: each batch's device tensors equal the
    inline path's ``to_device`` bit for bit; the native loader writes the
    features into pinned buffers."""
    from promptttspp_tpu_torch.data.prefetch import prefetch_batches
    from promptttspp_tpu_torch.train.trainer import (
        MODEL_BATCH_KEYS, to_device)

    make_ds, collator, batches = _loader_corpus(tmp_path)
    ds = make_ds()
    want = [to_device(collator([ds[i] for i in idx]), dev)
            for idx in batches]
    got = list(prefetch_batches(make_ds(), batches, collator,
                                model_keys=MODEL_BATCH_KEYS, device=dev,
                                num_workers=3, prefetch_depth=2,
                                use_native=native))
    assert len(got) == len(want)
    for (host, staged), ref in zip(got, want):
        assert staged.keys() == ref.keys()
        for k, t in staged.items():
            assert t.device == dev and t.dtype == ref[k].dtype, k
            assert torch.equal(t, ref[k]), k
        assert torch.from_numpy(host["mel"]).is_pinned() == native


def test_prefetched_batch_is_read_after_its_copy(dev, tmp_path):
    """Each batch's copies queue behind a ~25 ms spin on the copy stream;
    a reduction queued on the consumer's stream right after ``next()``
    still reads the copied values, since that stream waits on the copy's
    event."""
    from promptttspp_tpu_torch.data import prefetch
    from promptttspp_tpu_torch.train.trainer import (
        MODEL_BATCH_KEYS, to_device)

    make_ds, collator, batches = _loader_corpus(tmp_path)
    ds = make_ds()
    want = [to_device(collator([ds[i] for i in idx]), "cpu")["mel"].sum()
            for idx in batches]
    stage = prefetch._stage

    def slow_stage(batch, keys, device, stream):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)
        return stage(batch, keys, device, stream)

    with mock.patch.object(prefetch, "_stage", slow_stage):
        sums = [staged["mel"].sum() for _, staged in
                prefetch.prefetch_batches(
                    make_ds(), batches, collator,
                    model_keys=MODEL_BATCH_KEYS, device=dev,
                    num_workers=1, prefetch_depth=1)]
    for got, ref in zip(sums, want):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-4)


def test_bf16_step_on_the_card(dev):
    """One bf16 ``train_step`` of the tiny model on the card: finite losses
    within 1e-2 of the CPU's bf16 step (bf16 rounds at 4e-3 relative), the
    masters float32 and moved, the shadow bf16."""
    from promptttspp_tpu_torch.train.state import TrainState

    cpu = flagship.build_model(zero_dropout_config(), "cpu", 0, ZERO_BERT)
    gpu = flagship.build_model(zero_dropout_config(), dev, 0, ZERO_BERT)
    gpu.load_state_dict(cpu.state_dict())
    init = {k: v.clone() for k, v in gpu.state_dict().items()}
    outs = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        state = TrainState(model, seed=0, bf16=True, **OPT)
        outs.append({k: v.item() for k, v in state.train_step(
            torch_batch(train_batch(), d)).items()})
    assert all(math.isfinite(v) for v in outs[1].values())
    for k, v in outs[0].items():
        np.testing.assert_allclose(outs[1][k], v, atol=1e-2, rtol=1e-2,
                                   err_msg=k)
    assert all(p.dtype == torch.float32 for p in gpu.parameters())
    assert all(p.dtype == torch.bfloat16 and p.device == dev
               for p in state.shadow.parameters())
    assert any(not torch.equal(v, init[k]) for k, v in
               gpu.state_dict().items() if v.is_floating_point())


def test_feature_loader_builds_here(dev, tmp_path):
    """The C++ loader builds through ``_build.py`` with this machine's host
    compiler and reads float32 files as numpy normalizes them."""
    from promptttspp_tpu_torch.data import native_loader
    from promptttspp_tpu_torch.ops.kernels import _build

    _build.build(["featloader"])
    assert _build.library_path("featloader").exists()
    rng = np.random.RandomState(0)
    mel = (rng.randn(80, 37) - 4).astype(np.float32)
    for name, a in (("mel", mel), ("cf0", mel[:1]), ("vuv", mel[:1])):
        np.save(tmp_path / f"{name}.npy", a)
    out = native_loader.load_feature_batch(
        [tmp_path / "mel.npy"], [tmp_path / "cf0.npy"],
        [tmp_path / "vuv.npy"], 64, -4.0, 2.0)
    np.testing.assert_array_equal(out["mel"][0, :37], ((mel + 4.0) / 2.0).T)
    assert out["frame_lengths"][0] == 37


# -- the recipe: batched YIN, interp1d, the mel and the preprocess CLI ------
# the bars of tests/test_torch_f0.py and tests/test_torch_preprocess.py
VUV_AGREEMENT, F0_RTOL, MEL_ATOL = 0.995, 1e-3, 1e-4


def _f0_batch():
    """3 speech-like rows of 1.2-2 s and a silent one, in one buffer,
    with per-row bounds."""
    from promptttspp_tpu_torch.tools.synthetic_corpus import speech_like

    wav = np.zeros((4, 48000), np.float32)
    for i, (sec, f0) in enumerate(((2.0, 110.0), (1.6, 190.0),
                                   (1.2, 260.0))):
        wav[i, :int(24000 * sec)] = speech_like(sec, f0, seed=i)
    lo = np.array([63.0, 97.9, 146.2, 63.0], np.float32)
    hi = np.array([340.8, 510.3, 526.6, 400.0], np.float32)
    return wav, lo, hi


def test_yin_on_the_card_matches_the_cpu(dev):
    from promptttspp_tpu_torch.ops.f0 import extract_pitch

    wav, lo, hi = _f0_batch()
    out = [[t.cpu().numpy() for t in extract_pitch(
        torch.from_numpy(wav).to(d), 24000, 240,
        torch.from_numpy(lo).to(d), torch.from_numpy(hi).to(d))]
        for d in ("cpu", dev)]
    (f0_c, cf0_c, vuv_c), (f0_g, cf0_g, vuv_g) = out
    assert (vuv_g == vuv_c).mean() >= VUV_AGREEMENT
    both = (vuv_g > 0) & (vuv_c > 0)
    assert both.sum() > 100 and not vuv_g[3].any()
    np.testing.assert_allclose(f0_g[both], f0_c[both], rtol=F0_RTOL)
    same = (vuv_g == vuv_c).all(-1)
    np.testing.assert_allclose(cf0_g[same], cf0_c[same], atol=F0_RTOL)


def test_interp1d_on_the_card(dev):
    from promptttspp_tpu_torch.ops.interp import interp1d

    rng = np.random.RandomState(0)
    f0 = np.where(rng.rand(4, 300) > 0.5, 80 + 200 * rng.rand(4, 300),
                  0.0).astype(np.float32)
    f0[2] = 0.0
    f0[3, :40] = f0[3, -50:] = 0.0
    ours = interp1d(torch.from_numpy(f0).to(dev)).cpu().numpy()
    np.testing.assert_allclose(ours, interp1d(torch.from_numpy(f0)).numpy(),
                               atol=1e-6, rtol=0)


def test_feature_extractor_on_the_card(dev):
    """``BatchedFeatureExtractor`` (YIN, the host's contour fix, interp1d
    and the mel) on the card against the CPU, per utterance."""
    from promptttspp_tpu_torch.preprocess.pipeline import (
        BatchedFeatureExtractor)

    wav, lo, hi = _f0_batch()
    wavs = [wav[0, :48000], wav[1, :38400], wav[2, :28800]]
    out = {d: BatchedFeatureExtractor(device=d)(wavs, lo[:3], hi[:3])
           for d in ("cpu", dev)}
    for a, b in zip(out["cpu"], out[dev]):
        assert a["mel"].shape == b["mel"].shape
        np.testing.assert_allclose(b["mel"], a["mel"], atol=MEL_ATOL, rtol=0)
        assert (a["vuv"] == b["vuv"]).mean() >= VUV_AGREEMENT
        both = (a["vuv"] > 0) & (b["vuv"] > 0)
        np.testing.assert_allclose(b["f0"][both], a["f0"][both],
                                   rtol=F0_RTOL)


def test_preprocess_cli_on_the_card(dev, tmp_path):
    """``bin/preprocess.py`` in-process on the card (its default device) on
    a raw synthetic corpus: the CSVs, features and statistics it writes."""
    import os
    from pathlib import Path

    from promptttspp_tpu_torch.bin import preprocess
    from promptttspp_tpu_torch.data.dataset import read_prompt_candidate
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        raw_rows, write_raw_corpus)

    meta = Path(__file__).resolve().parent.parent / "metadata"
    prompts = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    prompts = {k: prompts[k][:1] for k in sorted(prompts)[:3]}
    rows = raw_rows({121: 1, 19: 2}, prompts, seconds=(1.5, 2.5))
    write_raw_corpus(tmp_path, rows, prompts, {121: ["calm"], 19: ["deep"]},
                     f0_stats_file=meta / "libritts_r_f0_stats.yaml",
                     vocab_size=300)
    cwd = os.getcwd()
    try:
        preprocess.main([f"path.root={tmp_path}", "eval_ids=[121]",
                         f"hydra.run.dir={tmp_path / 'run'}"])
    finally:
        os.chdir(cwd)
    dump = tmp_path / "dump/libritts_r_per_spk_cleaned"
    assert len((dump / "df/data.csv").read_text().splitlines()) == 4
    assert len((dump / "df/eval.csv").read_text().splitlines()) == 2
    for r in rows:
        mel = np.load(dump / f"mel63/{r['spk_id']}/{r['item_name']}.npy")
        cf0 = np.load(dump / f"feats/{r['spk_id']}/cf0/{r['item_name']}.npy")
        assert mel.shape[0] == 80 and cf0.shape == (1, mel.shape[1])
        assert np.isfinite(mel).all() and np.isfinite(cf0).all()
    assert (dump / "mel63/stats.yaml").exists()


@pytest.mark.parametrize("C,T,k,d", [(32, 153600, 11, 5), (256, 3840, 3, 1)])
def test_k2_bf16_on_a_second_card_after_the_first(dev, C, T, k, d):
    """K2-bf16 lifts its shared-memory cap per device: a layer launched on
    cuda:1 after cuda:0, at flagship shapes whose plans ask for more than
    the 48 KB default, against the plain version on each card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    assert k2.wgmma_plan(C, k, d)["smem"] > 48 * 1024
    for d_ in (dev, torch.device("cuda", 1)):
        g = torch.Generator(device=d_).manual_seed(12)
        args = _layer_args(g, 1, T, C, k, d)
        out = k2.amp_layer(*args, bf16=True)
        torch.cuda.synchronize(d_)
        assert out.device == d_
        torch.testing.assert_close(out, k2.amp_layer_plain(*args, bf16=True),
                                   **K2_BF16_TOL)


def test_nccl_step_at_world_size_one_equals_the_plain_step(dev,
                                                           monkeypatch):
    """A ``TrainState`` step over an NCCL group of one rank (the global
    counts, the draws at the global shape and the gradient sum all run, as
    identities) equals the step without a group bit for bit, dropout on,
    under deterministic algorithms (else the backward's float atomics sum
    in another order in any two steps)."""
    import torch.distributed as dist

    from promptttspp_tpu_torch.bin.train import free_port
    from promptttspp_tpu_torch.parallel.distributed import DataGroup
    from promptttspp_tpu_torch.train.state import TrainState

    batch = train_batch()
    del batch["diffusion_t"], batch["diffusion_noise"]
    models = [flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT)
              for _ in range(2)]
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        outs = [TrainState(m, seed=0, data=data, **OPT).train_step(
            torch_batch(batch, dev)) for m, data in
            zip(models, (None, DataGroup(0, 1)))]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    for k, v in outs[0].items():
        assert torch.equal(outs[1][k], v), k
    ref = models[0].state_dict()
    for k, v in models[1].state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_sharded_vocoder_on_one_card_equals_chunked(dev):
    """``vocode_sharded`` over the mesh [cuda:0, cuda:0] (5 chunks padded
    to 6, K1 and K2-bf16 launched once per shard's call) against
    ``vocode_chunked`` on the card."""
    from promptttspp_tpu_torch.parallel import make_mesh
    from promptttspp_tpu_torch.vocoders.streaming import (
        vocode_chunked, vocode_sharded)

    synth = _tiny_synth(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    mel = _randn(g, 1, 80, MEL)
    f0 = 150.0 + 20.0 * torch.sin(torch.linspace(0, 6, 80, device=dev))
    kw = dict(chunk_frames=16, halo_frames=4, upsample=240,
              deterministic=True)
    with torch.inference_mode():
        ref = vocode_chunked(synth.vocoder, mel, f0[None, :, None], **kw)
        before = (k1.antialias_snake.launches, k2.amp_layer.launches_bf16)
        out = vocode_sharded(make_mesh(devices=[dev, dev]), synth.vocoder,
                             mel, f0[None, :, None], **kw)
        torch.cuda.synchronize()
    n_layers = (k2.amp_layer.launches_bf16 - before[1]) // 2
    assert k1.antialias_snake.launches - before[0] == 2 and n_layers > 0
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------ model axis
def _model_axis_rank(rank, port, out_dir):
    """One of two gloo ranks on cuda:0: the ring permute of a CUDA tensor
    (forward and back) and a TP=2 step of the tiny model."""
    import torch.distributed as dist

    from promptttspp_tpu_torch.parallel.distributed import process_groups
    from promptttspp_tpu_torch.parallel.tp import (
        gather_state_dict, shard_module)
    from promptttspp_tpu_torch.train.state import TrainState

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        dev = torch.device("cuda", 0)
        _, group = process_groups(2)
        x = torch.full((3, 5), float(rank + 1), device=dev)
        ahead, back = group.permute(x, 1), group.permute(x, -1)
        model = flagship.build_model(zero_dropout_config(), dev, 0,
                                     ZERO_BERT)
        shard_module(model, group)
        state = TrainState(model, seed=0, model_group=group, **OPT)
        out = {k: v.item() for k, v in state.train_step(
            torch_batch(train_batch(), dev)).items()}
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        sd.update({k: v.cpu() for k, v in gather_state_dict(model).items()})
        grads = {n: p.grad for n, p in zip(state.trainable, state.params)}
        grads.update({n: group.gather_dim(grads[n], spec.dim,
                                          spec.interleave)
                      for n, spec in model.tp_shards.items() if n in grads})
        torch.save(dict(permuted=(ahead.cpu(), back.cpu(),
                                  str(ahead.device)), out=out, sd=sd,
                        grads={n: g.cpu() for n, g in grads.items()}),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def model_axis_ranks(tmp_path_factory):
    """Two gloo ranks spawned on cuda:0 (``_model_axis_rank``) -> their
    results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import socket

    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("model_axis")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_model_axis_rank, args=(port, str(out)), nprocs=2,
                       join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


def test_ring_permute_on_the_card(dev, model_axis_ranks):
    """``ModelGroup.permute`` of a CUDA tensor between two gloo ranks on
    cuda:0 (staged through the host): each rank receives the other's,
    around the ring both ways, on the card."""
    for rank, res in enumerate(model_axis_ranks):
        ahead, back, device = res["permuted"]
        assert device == "cuda:0"
        other = float(2 - rank)
        assert torch.equal(ahead, torch.full((3, 5), other))
        assert torch.equal(back, torch.full((3, 5), other))


def test_tp_step_on_the_card(dev, model_axis_ranks):
    """A TP=2 step of the tiny model (dropout 0, draws given) on two gloo
    ranks on cuda:0 against one process on the card: the losses within
    1e-5 relative (grad_norm 1e-4: the squares summed in another order),
    the whole gradient (clipped, as AdamW took it) within 1e-4 relative in
    L2 and every tensor within 1e-2 (chip_smoke.py's phase 12 explains why
    a tensor cannot be held tighter: rounding on the card moves elements
    near 0), and the whole parameters, alike on both ranks, within a tenth
    of the update in L2 (AdamW's first step is about lr whatever a
    gradient element's size, so an element near 0 that rounding moves
    across 0 steps the other way)."""
    from promptttspp_tpu_torch.train.state import TrainState

    model = flagship.build_model(zero_dropout_config(), dev, 0, ZERO_BERT)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, seed=0, **OPT)
    out = state.train_step(torch_batch(train_batch(), dev))
    ref = model.state_dict()
    ref_grads = {n: p.grad for n, p in zip(state.trainable, state.params)}
    r0, r1 = model_axis_ranks
    assert r0["out"] == r1["out"]
    for k, v in out.items():
        np.testing.assert_allclose(r0["out"][k], v.item(),
                                   rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   err_msg=k)
    norm = lambda ts: float(torch.stack([t.norm() for t in ts]).norm())
    whole = norm(g for g in ref_grads.values())
    diffs = {n: float((r0["grads"][n] - g.cpu()).norm())
             for n, g in ref_grads.items()}
    assert norm(torch.tensor(d) for d in diffs.values()) <= 1e-4 * whole
    for n, g in ref_grads.items():
        assert diffs[n] <= 1e-2 * float(g.norm()) + 1e-6 * whole, n
    for k, v in r0["sd"].items():
        assert torch.equal(r1["sd"][k], v), k
    gap = norm((r0["sd"][k] - v.cpu()) for k, v in ref.items()
               if v.is_floating_point())
    moved = norm((v - init[k]).cpu() for k, v in ref.items()
                 if v.is_floating_point())
    assert gap <= 0.1 * moved, (gap, moved)


def test_pipelined_decode_on_the_card(dev):
    """``Synthesizer(decode_pipelined=True)`` over the mesh [[cuda:0,
    cuda:0]] with a 4-block DiffNet in 2 stages and 2 microbatches: a batch
    of two requests' mels within 1e-5 of the unpipelined eager decode's,
    and the vocoder's K1 and K2-bf16 launches those of the plain request."""
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.parallel.mesh import Mesh

    cfg = tiny_model_config()
    cfg["decoder"]["denoise_fn"].update(residual_layers=4,
                                        dilation_cycle_length=2)
    model = flagship.build_model(cfg, dev, 3, TINY_BERT)
    kw = dict(tokenizer=Tok(), device=dev, frame_quantum=64)
    vocoder = _tiny_synth(dev).vocoder
    piped = Synthesizer(model, vocoder, decode_pipelined=True,
                        pipeline_microbatches=2, mesh=Mesh([[dev, dev]]),
                        **kw)
    plain = Synthesizer(model, vocoder, **kw)
    seqs = [[5, 17, 33, 45, 8, 61, 29], [12, 88, 41, 23]]
    req = dict(prompts=["a calm voice", "bright"], use_max=False,
               noise_scale=0.5, seed=3)

    def eager(decoder, cond, x_T=None, zero_noise=False, generator=None):
        return decoder.inference(cond, x_T, zero_noise, generator)

    counts = []
    k1.antialias_snake.launches = k2.amp_layer.launches_bf16 = 0
    with mock.patch.object(decode_graph, "decode", eager):
        _, ref = plain.synthesize(seqs, **req)
    counts.append((k1.antialias_snake.launches, k2.amp_layer.launches_bf16))
    k1.antialias_snake.launches = k2.amp_layer.launches_bf16 = 0
    wavs, mels = piped.synthesize(seqs, **req)
    counts.append((k1.antialias_snake.launches, k2.amp_layer.launches_bf16))
    assert counts[1] == counts[0] and counts[0][0] == 1 and counts[0][1] > 0
    for m, r in zip(mels, ref):
        np.testing.assert_allclose(m, r, rtol=0, atol=1e-5)
    assert all(np.isfinite(w).all() for w in wavs)


def test_one_process_pipelined_training_on_the_card(dev):
    """The trainer's one-process pipeline, ``StageDevices([cuda])`` with
    the device named without its index, on a DiffNet whose parameters lie
    on cuda:0: its blocks take the gradients of the unpipelined step (a
    replica took them before, F9), within 1e-4 relative in every tensor
    (float32, the card's atomics summing in another order)."""
    from promptttspp_tpu_torch.models.diffusion import float32_math
    from promptttspp_tpu_torch.parallel.pp import (
        StageDevices, denoise_pipelined)

    cfg = tiny_model_config()
    cfg["decoder"]["denoise_fn"].update(residual_layers=4,
                                        dilation_cycle_length=2)
    model = flagship.build_model(cfg, dev, 3, TINY_BERT)
    diffnet = model.decoder.denoise_fn.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, MEL, generator=g).to(dev)
    cond = torch.randn(4, 32, C, generator=g).to(dev)
    t = torch.tensor([3, 7, 1, 9], device=dev)
    grads = []
    with float32_math():
        for pipeline in (None, StageDevices([torch.device("cuda")])):
            diffnet.zero_grad()
            eps = diffnet(x, t, diffnet.precompute_cond(cond)) \
                if pipeline is None else denoise_pipelined(
                    pipeline, diffnet, x, t, cond, n_microbatches=2)
            eps.square().sum().backward()
            grads.append({n: p.grad.clone()
                          for n, p in diffnet.named_parameters()})
    for n, v in grads[0].items():
        assert float((grads[1][n] - v).norm()) <= 1e-4 * float(v.norm()), n


@contextlib.contextmanager
def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _experimental_nets():
    """(name, build, run, inputs) of each experimental net at a small
    width, with a guided PLMS decode and Glow's reverse."""
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

    g = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    mask = torch.ones(2, 50, 1)
    mask[1, 40:] = 0.0
    x, cond, mel, style = r(2, 50, 32), r(2, 50, 24), r(2, 50, MEL), \
        r(2, 1, 16)
    t = torch.tensor([0.3, 0.8])
    return [
        ("convnext", lambda: ConvNeXt1d(32, 64, 3),
         lambda m, i: m(*i), (x, mask)),
        ("mrf", lambda: MRFNet(32, 32, 32, (3, 7), (1, 3)),
         lambda m, i: m(i[0], i[1], g=i[2]), (x, mask, r(2, 1, 32))),
        ("conformer_local", lambda: Conformer(2, 32, 2, 7, 0.0),
         lambda m, i: m(i[0], i[1], g=i[2]), (x, mask, r(2, 1, 32))),
        ("vits", lambda: Transformer(32, 2, 2, 3, 0.0, 4, 4, True),
         lambda m, i: m(*i), (x, mask)),
        ("unet", lambda: Unet1d(MEL, 24, MEL, 16),
         lambda m, i: m(*i), (mel, t, cond, mask)),
        ("glow", lambda: Glow(16, 32, 2, 2),
         lambda m, i: m.reverse(m(i[0])[0])[0], (style,)),
        ("nnsvs_plms", lambda: GaussianDiffusionCFG(
            24, MEL, DiffNetG(MEL, 24, 4, 16, 2, gin_channels=16), K_step=20,
            pndm_speedup=5, do_classifier_free_guidance=True,
            guidance_scale=2.0),
         lambda m, i: m.inference(i[0], g=i[1], x_T=i[2], zero_noise=True),
         (cond, style, mel)),
        ("cnf_rk4", lambda: CNF(Unet1d(MEL, 24, MEL, 16), MEL),
         lambda m, i: m.sample(i[0], 4, "rk4", True, x0=i[1]), (cond, mel)),
        ("score_sde", lambda: ScoreSDE(MEL, Unet1d(MEL, MEL, MEL, 16)),
         lambda m, i: m(i[0], i[1], i[2], 4), (mel, mel, mask)),
    ]


@pytest.mark.parametrize("case", range(9))
def test_experimental_net_on_the_card(dev, case):
    """Each experimental net (``chip_smoke.py`` phase 15 at a small width)
    on the card against the CPU within 1e-5 of the largest magnitude,
    float32 without TF32; Glow's reverse of its forward returns z. Glow
    and the samplers set float32 themselves, so they run with TF32
    switched on."""
    from promptttspp_tpu_torch.models.diffusion import float32_math

    name, build, run, inputs = _experimental_nets()[case]
    torch.manual_seed(0)
    cpu = build().eval()
    card = copy.deepcopy(cpu).to(dev)
    own = name in ("glow", "nnsvs_plms", "cnf_rk4", "score_sde")
    with torch.no_grad(), (_tf32_on() if own else float32_math()):
        want = run(cpu, inputs)
        got = run(card, tuple(a.to(dev) for a in inputs)).cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale, name
    if name == "glow":
        torch.testing.assert_close(got, inputs[0], atol=1e-4, rtol=0)


# ---------------------------------------------- the DiffNet's fused blocks
DIFFNET_SHAPES = [(16, 1024), (1, 712), (2, 301)]  # (B, T)


def _diffnet_kernels():
    from promptttspp_tpu_torch.ops.kernels import diffnet as kd

    return kd


@pytest.mark.parametrize("cp_dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("B,T", DIFFNET_SHAPES)
def test_diffnet_gate_matches_plain(dev, B, T, d, cp_dtype):
    """G1 against the plain expression it replaces, bit for bit, at the
    flagship's R = 256: on the dilated convolution's output without its
    bias (the bias added in the kernel) and with it (none given); a
    conditioner projection of float32 or bf16, whole or a window of frames
    of a longer one (the frame-sharded decode's)."""
    kd = _diffnet_kernels()
    R = 256
    g = torch.Generator(device=dev).manual_seed(20 + d)
    u = _randn(g, B, R, T)
    w, bias = _randn(g, 2 * R, R, 3, scale=0.05), _randn(g, 2 * R, scale=0.1)
    c = torch.nn.functional.conv1d(u, w, None, 1, d, d)
    whole = _randn(g, B, T + 9, 2 * R).to(cp_dtype)
    for cp in (whole[:, :T].contiguous(), whole[:, 5:5 + T]):
        before = kd.gate.launches
        got = kd.gate(c, bias, cp)
        with_bias = kd.gate(c + bias[:, None], None, cp)
        torch.cuda.synchronize()
        assert kd.gate.launches == before + 2
        want = kd.gate_plain(c, bias, cp)
        assert got.shape == (B, T, R)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        torch.testing.assert_close(with_bias, want, atol=0, rtol=0)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("B,T", DIFFNET_SHAPES)
def test_diffnet_residual_and_entry_match_plain(dev, B, T, where):
    """G2 (the first block's skip from 0, a later block's sum, the last
    block without a next convolution input) and G0 against the plain
    expressions they replace, bit for bit; G2 updates x and the skip sum
    in place."""
    kd = _diffnet_kernels()
    R = 256
    g = torch.Generator(device=dev).manual_seed(30)
    o, bias = _randn(g, B, T, 2 * R), _randn(g, 2 * R, scale=0.1)
    x, skip, dp = _randn(g, B, T, R), _randn(g, B, T, R), _randn(g, B, R)
    skip = None if where == "first" else skip
    dp = None if where == "last" else dp
    want = kd.residual_plain(o, bias, x, skip, dp)
    x_in = x.clone()
    skip_in = None if skip is None else skip.clone()
    got = kd.residual(o, bias, x_in, skip_in, dp)
    torch.cuda.synchronize()
    assert got[0] is x_in and (skip is None or got[1] is skip_in)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    h, dp0 = _randn(g, B, T, R), _randn(g, B, R)
    h[0, 0, :4] = torch.tensor([0.0, -0.0, float("nan"), -1.0])
    for a, b in zip(kd.entry(h, dp0), kd.entry_plain(h, dp0)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, equal_nan=True)


def _flagship_decoder(dev):
    """The flagship's 100-step decoder (20 blocks of R = 256), seeded
    torch initialisation, on the card."""
    from promptttspp_tpu_torch.models.diffusion import (
        DiffNet, GaussianDiffusion)

    torch.manual_seed(0)
    dn = flagship.MODEL["decoder"]["denoise_fn"]
    net = DiffNet(dn["in_dim"], dn["encoder_hidden_dim"],
                  dn["residual_layers"], dn["residual_channels"],
                  dn["kernel_size"], dn["dilation_cycle_length"])
    return GaussianDiffusion(net, out_dim=80, norm_scale=6.0,
                             K_step=100).to(dev).eval().requires_grad_(False)


def _block_path():
    """The DiffNet's block-by-block path for every call."""
    from promptttspp_tpu_torch.models.diffusion import DiffNet

    return mock.patch.object(DiffNet, "fuses",
                             lambda self, x, mask=None: False)


@pytest.mark.parametrize("B,T", [(16, 1024), (1, 712)])
def test_fused_decode_equals_the_block_path(dev, B, T):
    """The flagship's 100-step graph decode on the fused block path equals
    the graph decode of the block-by-block path bit for bit; every replay
    counts its 2,000 blocks, all fused or none."""
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.utils import trace

    kd = _diffnet_kernels()
    decoder = _flagship_decoder(dev)
    cond = _randn(torch.Generator(device=dev).manual_seed(8), B, T, 256)
    gen = lambda: torch.Generator(device=dev).manual_seed(9)
    outs, counts = [], []
    for path in (contextlib.nullcontext(), _block_path()):
        dec = decoder.clone()
        launches = kd.residual.launches
        with path:
            decode_graph.decode(dec, cond, generator=gen())  # the capture
        fused = kd.residual.launches - launches
        trace.clear()
        with trace.recording():
            outs.append(decode_graph.decode(dec, cond, generator=gen()))
        n = {}
        for c in trace.counts():
            n[c.name] = n.get(c.name, 0) + c.n
        trace.clear()
        counts.append((fused, n.get("decode.blocks_run"),
                       n.get("decode.blocks_fused")))
    assert counts == [(4000, 2000, 2000), (0, 2000, 0)]
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_frame_sharded_decode_on_the_fused_path(dev):
    """The frame-sharded decode over [cuda:0, cuda:0] (flagship widths, its
    replicas' calls on window shapes): on the fused path it equals the
    sharded decode of the block path bit for bit, and the unsharded decode
    within chip_smoke's sharded bar (1e-5)."""
    from promptttspp_tpu_torch.parallel import make_mesh
    from promptttspp_tpu_torch.parallel.sp import decode_frames_sharded

    kd = _diffnet_kernels()
    decoder = _flagship_decoder(dev)
    cond = _randn(torch.Generator(device=dev).manual_seed(10), 1, 512, 256)
    gen = lambda: torch.Generator(device=dev).manual_seed(11)
    mesh = make_mesh(devices=[dev, dev])
    with torch.inference_mode():
        launches = kd.gate.launches
        fused = decode_frames_sharded(mesh, decoder, cond, generator=gen())
        assert kd.gate.launches - launches == 2 * 100 * 20
        with _block_path():
            plain = decode_frames_sharded(mesh, decoder, cond,
                                          generator=gen())
        whole = decoder.inference(cond, generator=gen())
    torch.testing.assert_close(fused, plain, atol=0, rtol=0)
    torch.testing.assert_close(fused, whole, atol=1e-5, rtol=0)


# F5-TTS at a small size (tests/test_torch_f5tts.py's widths)
F5_ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2,
               text_num_embeds=40, text_dim=32, conv_layers=1)


def _f5_tiny(dev, nfe=4):
    cfg = copy.deepcopy(flagship.F5TTS_V1_BASE)
    cfg["arch"] = dict(F5_ARCH)
    cfg["sampler"]["nfe_step"] = nfe
    return flagship.build_f5tts(cfg, dev, seed=0)


def _f5_cond(dev, B=3, T=128):
    from promptttspp_tpu_torch.models.f5tts import F5TTS

    g = torch.Generator(device=dev).manual_seed(2)
    lens, refs = [128, 97, 60][:B], [40, 31, 12][:B]
    ids = torch.randint(1, 40, (B, T), generator=g, device=dev)
    for i, n in enumerate(lens):
        ids[i, n - 20:] = 0
    cond = (_randn(g, B, T, 100), ids, torch.tensor(lens, device=dev),
            torch.tensor(refs, device=dev))
    return cond, F5TTS.draw_y0(lens, [7, 8, 9][:B], T, 100, dev)


def test_f5_graph_replay_equals_the_eager_fp16_sampler(dev):
    """The F5-TTS sampler's CUDA graph (the float16 DiT, 4 guided steps,
    a batch of 3 with padding) gives the eager sampler's bits, twice, and
    each replay records the counters of its shape."""
    from promptttspp_tpu_torch.models import decode_graph
    from promptttspp_tpu_torch.utils import trace

    model = _f5_tiny(dev)
    assert model.dit.dtype == torch.float16
    cond, y0 = _f5_cond(dev)
    with torch.inference_mode():
        eager = model.sample(cond, y0[None])
    trace.clear()
    with trace.recording():
        first = decode_graph.decode(model, cond, y0)
        second = decode_graph.decode(model, cond, y0)
    counts = {}
    for c in trace.counts():
        counts[c.name] = counts.get(c.name, 0) + c.n
    trace.clear()
    assert torch.isfinite(first).all() and first.dtype == torch.float32
    torch.testing.assert_close(first, eager, atol=0, rtol=0)
    torch.testing.assert_close(second, eager, atol=0, rtol=0)
    B, T, nfe, depth = 3, 128, 4, F5_ARCH["depth"]
    assert counts == {
        "decode.passes_run": 2 * 2 * nfe,
        "decode.blocks_run": 2 * 2 * nfe * depth,
        "f5.attn_flops": 2 * 4 * (2 * B) * F5_ARCH["heads"] * T * T
        * F5_ARCH["dim_head"] * depth * nfe}
    assert [(c["B"], c["T"]) for c in decode_graph.captured(model)] == [
        (3, 128)]


def test_f5_serving_on_the_card_returns_the_generated_frames(dev):
    """``Synthesizer.synthesize`` of F5-TTS with Vocos on the card returns
    per request its generated frames x 256 float samples, a batch of two
    the frames of each alone within the float16 DiT's reach."""
    from promptttspp_tpu_torch.ops.mel import VOCOS_MEL
    from promptttspp_tpu_torch.vocoders.vocos import Vocos

    model = _f5_tiny(dev)
    vocoder = flagship.build_vocos(dev, cfg=dict(
        flagship.VOCOS_MEL_24KHZ, dim=32, intermediate_dim=48, num_layers=2))
    assert isinstance(vocoder, Vocos)
    synth = Synthesizer(model, vocoder, to_mel=VOCOS_MEL, upsample=256,
                        device=dev)
    rng = np.random.default_rng(0)
    wavs = [(0.1 * rng.standard_normal(n * 256)).astype(np.float32)
            for n in (40, 23)]
    texts, refs = [[3] * 30, [5] * 11], [[4] * 9, [6] * 7]
    out, mels = synth.synthesize(texts, reference_wavs=wavs,
                                 reference_texts=refs, seed=[1, 2])
    for i, (w, t, r) in enumerate(zip(wavs, texts, refs)):
        T_ref = len(w) // 256 + 1
        gen = int(T_ref / len(r) * len(t))
        assert mels[i].shape == (gen, 100) and out[i].shape == (gen * 256,)
        assert out[i].dtype == np.float32 and np.isfinite(out[i]).all()
        alone, alone_mel = synth.synthesize([t], reference_wavs=[w],
                                            reference_texts=[r],
                                            seed=[i + 1])
        scale = float(np.abs(alone_mel[0]).max())
        assert float(np.abs(mels[i] - alone_mel[0]).max()) <= 2e-2 * scale


def _dp4_batch(seed=11, B=8, Tp=12, Tf=64, L=16):
    """A numpy global batch of ``B`` rows for the tiny model, the
    diffusion draws given, for four ranks of two rows."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(4, Tp + 1, B).astype(np.int32)
    duration = np.zeros((B, Tp), np.int32)
    for b in range(B):
        duration[b, :plens[b]] = rng.randint(1, 5, plens[b])
    flens = duration.sum(1).astype(np.int32)
    phoneme = rng.randint(1, 90, (B, Tp)).astype(np.int32)
    phoneme[np.arange(Tp)[None] >= plens[:, None]] = 0
    frame = (np.arange(Tf)[None] < flens[:, None])[:, :, None]
    mask = (np.arange(L)[None] < rng.randint(6, L + 1, B)[:, None])
    return dict(
        phoneme=phoneme, duration=duration, phone_lengths=plens,
        mel=(rng.randn(B, Tf, MEL) * frame).astype(np.float32),
        log_cf0=(rng.randn(B, Tf, 1) * frame).astype(np.float32),
        vuv=((rng.rand(B, Tf, 1) > 0.3) * frame).astype(np.float32),
        frame_lengths=flens,
        prompt_ids=(rng.randint(1, 60, (B, L)) * mask).astype(np.int32),
        prompt_mask=mask.astype(np.int32),
        batch_weight=np.ones(B, np.float32),
        diffusion_t=rng.randint(0, 10, B).astype(np.int32),
        diffusion_noise=rng.randn(B, Tf, MEL).astype(np.float32))


def _dp4_rank(rank: int, port: int, out_dir: str):
    """One NCCL rank of four, on its own card: one float32 update of the
    tiny model on its two rows of ``_dp4_batch``."""
    import torch.distributed as dist

    from promptttspp_tpu_torch.parallel.distributed import DataGroup
    from promptttspp_tpu_torch.train.state import TrainState

    torch.cuda.set_device(rank)
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        dev = torch.device("cuda", rank)
        data = DataGroup(rank, 4)
        model = flagship.build_model(zero_dropout_config(), dev, 0,
                                     ZERO_BERT)
        state = TrainState(model, seed=0, data=data, **OPT)
        batch = {k: v[data.rows(2)] for k, v in _dp4_batch().items()}
        out = state.train_step(torch_batch(batch, dev))
        torch.save(dict(out={k: float(v) for k, v in out.items()},
                        grads={n: p.grad.cpu() for n, p in
                               zip(state.trainable, state.params)}),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_dp4_update_on_four_cards_matches_one_card(dev, tmp_path):
    """Four NCCL ranks, one card each, two rows each of an 8-row batch:
    their gradient (summed over the ranks, each rank's loss over the
    global counts) is the one card's on the whole batch, as DDP averages
    a batch's gradients over its ranks: the losses within 1e-5 relative,
    the whole gradient within 1e-4 relative in L2; the ranks agree."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import socket

    import torch.multiprocessing as mp

    from promptttspp_tpu_torch.train.state import TrainState

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dp4_rank, args=(port, str(tmp_path)), nprocs=4,
                       join=True, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    model = flagship.build_model(zero_dropout_config(), dev, 0, ZERO_BERT)
    state = TrainState(model, seed=0, **OPT)
    out = state.train_step(torch_batch(_dp4_batch(), dev))
    ref = {n: p.grad.cpu() for n, p in zip(state.trainable, state.params)}
    for r in ranks[1:]:
        assert r["out"] == ranks[0]["out"]
        for n in ref:
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
    np.testing.assert_allclose(ranks[0]["out"]["loss"], float(out["loss"]),
                               rtol=1e-5)
    whole = float(torch.stack([g.norm() for g in ref.values()]).norm())
    gap = float(torch.stack([(ranks[0]["grads"][n] - g).norm()
                             for n, g in ref.items()]).norm())
    assert gap <= 1e-4 * whole, (gap, whole)
