"""The port's CUDA kernels on a GPU: each against its plain PyTorch version,
the wrappers' checks and launch counts, and a tiny request with the kernels
against the same request with every kernel replaced by its plain version.

Every test here carries the ``cuda`` marker and skips without a GPU (the
decision is made in a fixture). This file imports neither JAX nor the JAX
package, so it runs on a machine without them; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import copy
import dataclasses
import math
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

pytestmark = pytest.mark.cuda

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


@pytest.mark.parametrize("B,T,C,k,dils", [
    # tests/test_pallas_amp.py:74-79
    (1, 400, 32, 3, (1, 3, 5)), (1, 200, 64, 7, (1, 3, 5)),
    (1, 300, 128, 3, (1, 3)), (1, 150, 256, 3, (1, 3, 5)),
    # flagship blocks (shorter T), both memory paths, ragged and tiny T
    (1, 3840, 256, 11, (1, 3, 5)), (1, 2000, 128, 7, (1, 3, 5)),
    (2, 777, 64, 11, (1, 3, 5)), (1, 5, 32, 7, (1, 3, 5)),
    # more tiles than resident blocks: each block walks over several
    (1, 153600, 32, 11, (1, 3, 5)), (1, 76800, 64, 7, (1, 3, 5))])
def test_k3_matches_plain(dev, B, T, C, k, dils):
    g = torch.Generator(device=dev).manual_seed(2)
    x, params = _block_args(g, B, T, C, k, dils)
    before = k2.amp_block.launches
    out = k2.amp_block(x, params, dils)
    again = k2.amp_block(x, params, dils)
    torch.cuda.synchronize()
    assert k2.amp_block.launches == before + 2
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    torch.testing.assert_close(out, k2.amp_block_plain(x, params, dils),
                               **K2_TOL)


@pytest.mark.parametrize("C,k", [(256, 11), (32, 7)])
def test_k3_equals_the_chain_of_k2_launches(dev, C, k):
    """K3 (float32 FMAs on the CUDA cores) against the chain of float32 K2
    launches (3xTF32 on the tensor cores): the two sum in other orders, so
    they agree within the float32 tolerance, not bit for bit. The weights
    have gain 1 at most (``_block_args``): at scale 0.05 the block's output
    grows to hundreds, and float32 rounding alone leaves that tolerance."""
    g = torch.Generator(device=dev).manual_seed(2)
    dils = (1, 3, 5)
    x, params = _block_args(g, 1, 1000, C, k, dils)
    chain = x
    for p, d in zip(params, dils):
        chain = k2.amp_layer(chain, *p, d)
    torch.testing.assert_close(k2.amp_block(x, params, dils), chain,
                               **K2_TOL)


def test_k3_refuses_other_shapes(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    for C, k, dils in ((48, 3, (1, 3, 5)), (32, 5, (1, 3, 5)),
                       (32, 3, (1, 2)), (512, 3, (1, 3, 5))):
        x, params = _block_args(g, 1, 64, C, k, dils)
        with pytest.raises(ValueError, match="amp_block kernel takes"):
            k2.amp_block(x, params, dils)
    x, params = _block_args(g, 1, 64, 32, 3, (1, 3, 5))
    with pytest.raises(ValueError, match="dilations"):
        k2.amp_block(x, params, (1, 3))
    with pytest.raises(ValueError, match="is on"):
        k2.amp_block(x, params[:1] + ((params[1][0].cpu(),)
                                      + params[1][1:],) + params[2:],
                     (1, 3, 5))


def test_kernel_weight_layout_is_prepared_once(dev):
    w = torch.randn(32, 32, 3, device=dev)
    w_k = k2.kernel_weight(w)
    assert k2.kernel_weight(w) is w_k
    torch.testing.assert_close(w_k, w.permute(2, 1, 0))
    w.mul_(2.0)  # an in-place update prepares it again
    assert k2.kernel_weight(w) is not w_k
    torch.testing.assert_close(k2.kernel_weight(w), w.permute(2, 1, 0))


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
