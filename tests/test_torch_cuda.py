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
from unittest import mock

import numpy as np
import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.infer import Synthesizer
from promptttspp_tpu_torch.models.bert import BertConfig
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.ops.kernels import snake as k1

K1_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_snake.py:34
K2_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_pallas_amp.py:51

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
    cfg["decoder"].update(in_dim=C, out_dim=MEL, K_step=10)
    cfg["decoder"]["denoise_fn"].update(
        in_dim=MEL, encoder_hidden_dim=C, residual_layers=2,
        residual_channels=16, dilation_cycle_length=2)
    return cfg


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


@pytest.mark.parametrize("shape", [(1, 153600, 32), (2, 1000, 256),
                                   (1, 77, 20), (3, 5, 8), (1, 1, 32)])
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
    (1, 97, 128, 11, 5), (1, 5, 8, 3, 5), (2, 300, 12, 7, 1)])
def test_k2_matches_plain(dev, B, T, C, k, d):
    g = torch.Generator(device=dev).manual_seed(1)
    args = (_randn(g, B, T, C, scale=0.3), _randn(g, C, scale=0.2),
            _randn(g, C, C, k, scale=0.05), _randn(g, C, scale=0.1),
            _randn(g, C, scale=0.2), _randn(g, C, C, k, scale=0.05),
            _randn(g, C, scale=0.1), d)
    before = k2.amp_layer.launches
    out = k2.amp_layer(*args)
    torch.cuda.synchronize()
    assert k2.amp_layer.launches == before + 2
    torch.testing.assert_close(out, k2.amp_layer_plain(*args), **K2_TOL)


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
    b = torch.zeros(30, device=dev)
    x30 = torch.zeros(1, 64, 30, device=dev)
    with pytest.raises(ValueError, match="C % 4"):
        k2.amp_layer(x30, b, w, b, b, w, b, 1)


def test_tiny_request_kernels_match_plain_versions(dev):
    model = flagship.bias_duration_head(
        flagship.build_model(tiny_model_config(), dev, 0, TINY_BERT), 3.0)
    voc_cfg = dict(flagship.VOCODER, in_channel=MEL,
                   upsample_initial_channel=64,
                   resblock_kernel_sizes=[3, 7],
                   resblock_dilations=[[1, 3], [1, 5]])
    vocoder = flagship.build_vocoder(dev, 1, voc_cfg)

    class Tok:
        pad_id = 0

        def batch_encode(self, prompts):
            ids = np.arange(1, 10)[None].repeat(len(prompts), 0)
            return ids, np.ones_like(ids)

    synth = Synthesizer(model, vocoder, tokenizer=Tok(), device=dev)
    seqs, prompts = [[5, 9, 22, 40, 3, 17, 64]], ["a calm voice"]
    frames = 128  # 7 phones x 3 frames, bucketed
    x_T = torch.randn((1, frames, MEL), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    kw = dict(noise_scale=0.0, x_T=x_T, zero_noise=True)
    n1, n2 = k1.antialias_snake.launches, k2.amp_layer.launches
    wav_k, mel_k = synth.synthesize(seqs, prompts, **kw)
    assert k1.antialias_snake.launches == n1 + 1
    assert k2.amp_layer.launches == n2 + 2 * 2 * 4 * 2  # 2 per layer
    with mock.patch.object(k2, "amp_layer", k2.amp_layer_plain), \
            mock.patch.object(k1, "antialias_snake",
                              k1.antialias_snake_plain):
        wav_p, mel_p = synth.synthesize(seqs, prompts, **kw)
    assert wav_k[0].shape == (21 * 240,)
    np.testing.assert_array_equal(mel_k[0], mel_p[0])
    np.testing.assert_allclose(wav_k[0], wav_p[0], atol=1e-4)
