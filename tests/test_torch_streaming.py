"""Port of chunked and streaming vocoding (``vocoders/streaming.py``) and of
the NSF ``phase0`` offset against the JAX package, on the CPU, with the
tiny vocoders of tests/test_streaming.py (the same weights on both sides
through ``compat/from_jax.py``). Mirrors tests/test_streaming.py (its
sharded cases excepted): the port against JAX's own chunked and streaming
output, and the port's stitched waveform against its batched one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.vocoders import streaming as jax_streaming
from promptttspp_tpu.vocoders.bigvgan import BigVGAN as JaxBigVGAN
from promptttspp_tpu.vocoders.bigvgan_f0 import F0AwareBigVGAN as JaxF0Voc
from promptttspp_tpu.vocoders.nsf import SineGen as JaxSineGen
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.vocoders import streaming
from promptttspp_tpu_torch.vocoders.bigvgan import BigVGAN
from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN
from promptttspp_tpu_torch.vocoders.nsf import SineGen

# tolerance of tests/test_torch_vocoder.py:20 (tests/test_vocoder.py:57)
TOL = dict(atol=5e-5, rtol=1e-3)
HALO, UP = 12, 8
MARGIN = HALO * UP  # halo_frames * upsample: edge context
SMALL = dict(in_channel=12, upsample_initial_channel=16,
             upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),))


@pytest.fixture(scope="module")
def small():
    """tests/test_streaming.py::small_vocoder and its port."""
    jvoc = JaxBigVGAN(**SMALL)
    variables = jvoc.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 12)))
    voc = BigVGAN(**SMALL)
    load_jax_variables(voc, jax.device_get(variables))
    return jvoc, variables, voc.eval()


@pytest.fixture(scope="module")
def f0voc():
    """tests/test_streaming.py::f0_vocoder and its port."""
    kw = dict(sampling_rate=24000, harmonic_num=2, **SMALL)
    jvoc = JaxF0Voc(**kw)
    variables = jvoc.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 12)),
                          jnp.zeros((1, 16, 1)), deterministic=True)
    voc = F0AwareBigVGAN(**kw)
    load_jax_variables(voc, jax.device_get(variables))
    return jvoc, variables, voc.eval()


def _vibrato(T, base=150.0, depth=20.0, span=6.0):
    return (base + depth * np.sin(np.linspace(0, span, T)))[
        None, :, None].astype(np.float32)


def _stream(gen):
    return np.concatenate([w.numpy() for w in gen], axis=1)


def test_sine_gen_phase0_matches_jax():
    rng = np.random.RandomState(0)
    f0 = np.where(rng.rand(2, 300, 1) > 0.2, 90 + 200 * rng.rand(2, 300, 1),
                  0.0).astype(np.float32)
    phase0 = np.array([[0.37], [0.91]], np.float32)
    ref, _, _ = JaxSineGen(24000, 8).apply(
        {}, jnp.asarray(f0), deterministic=True, phase0=jnp.asarray(phase0))
    with torch.no_grad():
        out, _, _ = SineGen(24000, 8)(torch.from_numpy(f0),
                                      deterministic=True,
                                      phase0=torch.from_numpy(phase0))
        base, _, _ = SineGen(24000, 8)(torch.from_numpy(f0),
                                       deterministic=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert np.abs(out.numpy() - base.numpy()).max() > 0.05


@pytest.mark.parametrize("T,first", [(12, None), (19, 8), (70, 8),
                                     (96, None), (100, 4)])
def test_chunk_grid_and_phase0_match_jax(T, first):
    spans, Tp = streaming._chunk_grid(T, 32, first)
    assert (spans, Tp) == jax_streaming._chunk_grid(T, 32, first)
    f0 = _vibrato(Tp + 2 * HALO)
    starts = [s for s, _ in spans]
    ref = jax_streaming._chunk_phase0(jnp.asarray(f0), np.array(starts),
                                      HALO, UP, 24000)
    out = streaming._chunk_phase0(torch.from_numpy(f0), starts, HALO, UP,
                                  24000)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_pad_to_matches_jax():
    x = np.random.RandomState(1).randn(2, 5, 3).astype(np.float32)
    for n in (3, 5, 9):
        np.testing.assert_array_equal(
            streaming._pad_to(torch.from_numpy(x), n).numpy(),
            np.asarray(jax_streaming._pad_to(jnp.asarray(x), n)))


def test_chunked_matches_jax_and_full(small):
    jvoc, variables, voc = small
    mel = np.random.RandomState(0).randn(2, 100, 12).astype(np.float32)
    ref = jax_streaming.vocode_chunked(jvoc, variables, jnp.asarray(mel),
                                       chunk_frames=32, halo_frames=HALO,
                                       upsample=UP)
    with torch.no_grad():
        out = streaming.vocode_chunked(voc, torch.from_numpy(mel),
                                       chunk_frames=32, halo_frames=HALO,
                                       upsample=UP).numpy()
        full = voc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    assert out.shape == full.shape
    err = np.abs(out - full)[:, MARGIN:-MARGIN]
    assert err.max() < 1e-4, err.max()


@pytest.mark.parametrize("first", [None, 8])
def test_streaming_matches_jax_and_chunked(small, first):
    """Streaming concatenates to the chunked waveform; a smaller first
    chunk (the time-to-first-audio ramp) changes nothing in the interior."""
    jvoc, variables, voc = small
    mel = np.random.RandomState(1).randn(1, 70, 12).astype(np.float32)
    kw = dict(chunk_frames=32, halo_frames=HALO, upsample=UP,
              first_chunk_frames=first)
    ref = np.concatenate([np.asarray(w) for w in
                          jax_streaming.vocode_streaming(
                              jvoc, variables, jnp.asarray(mel), **kw)],
                         axis=1)
    with torch.no_grad():
        parts = list(streaming.vocode_streaming(voc, torch.from_numpy(mel),
                                                **kw))
        chunked = streaming.vocode_chunked(
            voc, torch.from_numpy(mel), chunk_frames=32, halo_frames=HALO,
            upsample=UP).numpy()
        full = voc(torch.from_numpy(mel)).numpy()
    stream = np.concatenate([p.numpy() for p in parts], axis=1)
    if first is not None:
        assert parts[0].shape[1] == first * UP  # first audio after 8 frames
    np.testing.assert_allclose(stream, ref, **TOL)
    assert stream.shape == chunked.shape == full.shape
    if first is None:
        np.testing.assert_allclose(stream, chunked, atol=1e-5)
    err = np.abs(stream - full)[:, MARGIN:-MARGIN]
    assert err.max() < 1e-4, err.max()


def test_f0_chunked_phase_continuity(f0voc, monkeypatch):
    """The NSF phase offsets make chunked synthesis of a voiced utterance
    match full synthesis; with the offsets zeroed (a phase reset at every
    chunk) it does not."""
    jvoc, variables, voc = f0voc
    mel = np.random.RandomState(4).randn(1, 96, 12).astype(np.float32)
    f0 = _vibrato(96)
    kw = dict(chunk_frames=16, halo_frames=HALO, upsample=UP,
              deterministic=True)
    ref = jax_streaming.vocode_chunked(jvoc, variables, jnp.asarray(mel),
                                       jnp.asarray(f0), **kw)
    args = (voc, torch.from_numpy(mel), torch.from_numpy(f0))
    with torch.no_grad():
        out = streaming.vocode_chunked(*args, **kw).numpy()
        full = voc(*args[1:], deterministic=True).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    err = np.abs(out - full)[:, MARGIN:-MARGIN].max()
    assert err < 2e-3, err

    monkeypatch.setattr(streaming, "_chunk_phase0",
                        lambda f0_p, starts, *a: torch.zeros(
                            f0_p.shape[0], len(list(starts))))
    with torch.no_grad():
        broken = streaming.vocode_chunked(*args, **kw).numpy()
    assert np.abs(broken - full)[:, MARGIN:-MARGIN].max() > 10 * err


def test_f0_streaming_ramp_matches_jax_and_full(f0voc):
    """The ramp's irregular chunk grid keeps the NSF phase continuous."""
    jvoc, variables, voc = f0voc
    mel = np.random.RandomState(7).randn(1, 96, 12).astype(np.float32)
    f0 = _vibrato(96)
    kw = dict(chunk_frames=32, halo_frames=HALO, upsample=UP,
              first_chunk_frames=8, deterministic=True)
    ref = np.concatenate([np.asarray(w) for w in
                          jax_streaming.vocode_streaming(
                              jvoc, variables, jnp.asarray(mel),
                              jnp.asarray(f0), **kw)], axis=1)
    args = (voc, torch.from_numpy(mel), torch.from_numpy(f0))
    with torch.no_grad():
        stream = _stream(streaming.vocode_streaming(*args, **kw))
        full = voc(*args[1:], deterministic=True).numpy()
    np.testing.assert_allclose(stream, ref, **TOL)
    assert stream.shape == full.shape
    err = np.abs(stream - full)[:, MARGIN:-MARGIN]
    assert err.max() < 2e-3, err.max()
