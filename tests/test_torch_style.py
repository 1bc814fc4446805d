"""Port of the reference-audio branch against the JAX package on the CPU:
the GRU with packed-length semantics, the GST cross-attention, the style
encoder (against the reference's golden and against the JAX module with
perturbed weights), the STFT, the slaney mel filterbank and the log-mel
transform, down to wavs shorter than the STFT's reflect pad."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.models.style_encoder import StyleEncoder as JaxStyle
from promptttspp_tpu.nn.attention import GSTCrossAttention as JaxGST
from promptttspp_tpu.nn.gru import GRU as JaxGRU
from promptttspp_tpu.ops import mel as jax_mel
from promptttspp_tpu.ops import stft as jax_stft
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.models.style_encoder import StyleEncoder
from promptttspp_tpu_torch.nn.attention import GSTCrossAttention
from promptttspp_tpu_torch.nn.gru import GRU
from promptttspp_tpu_torch.ops import mel, stft
from tests.test_torch_acoustic import perturbed

GOLDENS = Path(__file__).parent / "goldens"
# float32 on both sides, sums in another order
TOL = dict(atol=2e-5, rtol=1e-4)


def _jax_params(module, *args, seed=0):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    return perturbed(jax.device_get(variables), seed)


@pytest.mark.parametrize("layers,lengths", [(1, [9, 4, 1]), (2, [9, 9, 3]),
                                            (1, None)])
def test_gru_matches_jax(layers, lengths):
    rng = np.random.RandomState(layers)
    xs = rng.randn(3, 9, 6).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jgru = JaxGRU(6, 5, layers)
    variables = _jax_params(jgru, jnp.asarray(xs))
    ref = jgru.apply({"params": variables["params"]}, jnp.asarray(xs),
                     None if lens is None else jnp.asarray(lens))
    gru = GRU(6, 5, layers)
    load_jax_variables(gru, {"params": variables["params"]})
    with torch.no_grad():
        out = gru(torch.from_numpy(xs),
                  None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gst_cross_attention_matches_jax():
    rng = np.random.RandomState(0)
    ref_emb = rng.randn(2, 1, 12).astype(np.float32)
    tokens = rng.randn(2, 5, 4).astype(np.float32)
    jgst = JaxGST(n_head=4, n_feat=16)
    variables = _jax_params(jgst, jnp.asarray(ref_emb), jnp.asarray(tokens))
    ref = jgst.apply({"params": variables["params"]}, jnp.asarray(ref_emb),
                     jnp.asarray(tokens))
    gst = GSTCrossAttention(4, 12, 4, 16)
    load_jax_variables(gst, {"params": variables["params"]})
    with torch.no_grad():
        out = gst(torch.from_numpy(ref_emb), torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_style_encoder_matches_golden():
    """The reference's torch state dict loads by name; tolerance of
    tests/test_parity.py:163."""
    data = dict(np.load(GOLDENS / "style_encoder.npz"))
    io = {k: data.pop(k) for k in ("mel", "lens", "out")}
    enc = StyleEncoder(idim=80, gst_tokens=10, gst_heads=4, conv_layers=6,
                       conv_chans_list=(8, 8, 16, 16, 32, 32),
                       gru_units=64, gst_token_dim=64).eval()
    enc.load_state_dict({k: torch.from_numpy(np.asarray(v))
                         for k, v in data.items()}, strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(io["mel"].transpose(0, 2, 1).copy()),
                  torch.from_numpy(io["lens"]))
    np.testing.assert_allclose(out.numpy()[:, 0, :], io["out"][:, :, 0],
                               atol=2e-5, rtol=1e-4)


def test_style_encoder_matches_jax_module():
    """Flagship conv widths at a shorter GRU, perturbed weights and
    running statistics, ragged lengths."""
    kw = dict(idim=80, gst_tokens=10, gst_heads=4, conv_layers=6,
              conv_chans_list=(16, 16, 32, 32, 64, 64), gru_units=32,
              gst_token_dim=32)
    rng = np.random.RandomState(1)
    mel_in = rng.randn(3, 300, 80).astype(np.float32)
    lens = np.array([300, 130, 40], np.int32)
    jenc = JaxStyle(**kw)
    variables = jax.jit(lambda k, m, l: jenc.init(k, m, l))(
        jax.random.PRNGKey(0), jnp.asarray(mel_in), jnp.asarray(lens))
    variables = perturbed(jax.device_get(variables), 2, scale=0.1)
    ref = jenc.apply(variables, jnp.asarray(mel_in), jnp.asarray(lens))
    enc = StyleEncoder(**kw).eval()
    load_jax_variables(enc, variables)
    with torch.no_grad():
        out = enc(torch.from_numpy(mel_in), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)


def test_mel_filterbank_and_window_match_jax():
    np.testing.assert_array_equal(
        mel.mel_filterbank(24000, 512, 80, 63.0, 12000.0),
        jax_mel.mel_filterbank(24000, 512, 80, 63.0, 12000.0))
    np.testing.assert_array_equal(stft.padded_window(480, 512),
                                  jax_stft.padded_window(480, 512))


@pytest.mark.parametrize("n_samples", [300, 7201, 24000 * 3 + 17])
def test_log_mel_matches_jax(n_samples):
    wav = (np.random.RandomState(n_samples).randn(2, n_samples) * 0.3
           ).astype(np.float32)
    ref = jax_mel.MelSpectrogramTransform().to_mel(jnp.asarray(wav))
    out = mel.MelSpectrogramTransform().to_mel(torch.from_numpy(wav))
    assert out.shape == ref.shape == (2, 1 + n_samples // 240, 80)
    # rfft in another order; log of the clamped mel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("n_samples", [1, 2, 100, 256, 257, 1000])
def test_short_wav_frames_stft_and_log_mel_match_jax(n_samples):
    """Wavs up to ``n_fft // 2`` samples and just past it: the centered pad
    reflects as often as it must, as ``jnp.pad`` does, so frames,
    spectrogram and log-mel have JAX's shapes and values."""
    wav = (np.random.RandomState(n_samples).randn(2, n_samples) * 0.3
           ).astype(np.float32)
    frames = np.asarray(jax_stft.frame_signal(jnp.asarray(wav), 512, 240))
    np.testing.assert_array_equal(
        stft.frame_signal(torch.from_numpy(wav), 512, 240).numpy(), frames)
    spec = stft.spectrogram(torch.from_numpy(wav), 512, 240, 480)
    ref = jax_stft.spectrogram(jnp.asarray(wav), 512, 240, 480)
    assert spec.shape == ref.shape == (2, 1 + n_samples // 240, 257)
    np.testing.assert_allclose(spec.numpy(), np.asarray(ref), **TOL)
    out = mel.MelSpectrogramTransform().to_mel(torch.from_numpy(wav))
    ref = jax_mel.MelSpectrogramTransform().to_mel(jnp.asarray(wav))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_200_sample_reference_style_embedding_matches_jax():
    """A 200-sample reference wav through the reference branch, log-mel
    (one frame) then the style encoder, gives JAX's embedding."""
    kw = dict(idim=80, gst_tokens=10, gst_heads=4, conv_layers=6,
              conv_chans_list=(16, 16, 32, 32, 64, 64), gru_units=32,
              gst_token_dim=32)
    wav = (np.random.RandomState(200).randn(1, 200) * 0.3).astype(np.float32)
    jmel = jax_mel.MelSpectrogramTransform().to_mel(jnp.asarray(wav))
    lens = np.array([jmel.shape[1]], np.int32)
    assert lens[0] == 1
    jenc = JaxStyle(**kw)
    variables = jax.jit(lambda k, m, l: jenc.init(k, m, l))(
        jax.random.PRNGKey(0), jmel, jnp.asarray(lens))
    variables = perturbed(jax.device_get(variables), 3, scale=0.1)
    ref = jenc.apply(variables, jmel, jnp.asarray(lens))
    enc = StyleEncoder(**kw).eval()
    load_jax_variables(enc, variables)
    with torch.no_grad():
        out = enc(mel.MelSpectrogramTransform().to_mel(torch.from_numpy(wav)),
                  torch.from_numpy(lens))
    assert out.shape == ref.shape and np.isfinite(out.numpy()).all()
    # tolerance of test_style_encoder_matches_jax_module
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)
