"""The port's serving paths on the CPU (tiny model and tiny vocoder): the
reference-audio modes against the JAX ``Synthesizer`` with the same
weights, bucket, ``x_T`` and zero diffusion noise; speculative serving, its
mispredict re-dispatch, ``synthesize_async``, streaming and chunked
vocoding against the port's own two-phase batched path (mirroring
tests/test_infer.py:185-370)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.infer import Synthesizer as JaxSynthesizer
from promptttspp_tpu.ops.mel import MelSpectrogramTransform as JaxMel
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.infer import Synthesizer
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from tests.test_torch_acoustic import MEL
from tests.test_torch_synth import (MEAN, PROMPTS, SEQS, STD, UPSAMPLE,
                                    synths)  # noqa: F401 (fixture)

HALO = 12
MARGIN = HALO * UPSAMPLE  # edge context of chunked / streamed vocoding


@pytest.fixture(scope="module")
def port_kw(synths):  # noqa: F811
    jsynth, psynth = synths
    return dict(model=psynth.model, vocoder=psynth.vocoder,
                tokenizer=psynth.tokenizer,
                mel_stats={"mean": MEAN, "std": STD}, max_frames_cap=512,
                upsample=UPSAMPLE, device="cpu")


def _raw_refs():
    """Reference log-mels of unequal length in the denormalized domain."""
    rng = np.random.RandomState(7)
    return [rng.randn(37, MEL).astype(np.float32) * STD + MEAN,
            rng.randn(25, MEL).astype(np.float32) * STD + MEAN]


def _ref_wavs():
    rng = np.random.RandomState(8)
    t = np.arange(9000) / 24000.0
    return [(0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.01 * rng.randn(n)
             ).astype(np.float32) for f, n in ((180.0, 9000), (240.0, 6100))]


def _x_T(psynth, refs):
    ref_mel, ref_lens = psynth._pad_ref_mels(refs)
    phoneme, plens = psynth._pad_phonemes(SEQS)
    with torch.no_grad():
        flens = psynth.model.infer_frame_lengths(
            phoneme, plens, reference_mel=ref_mel, ref_lengths=ref_lens)
    frames = bucket_shape(int(flens.max()), psynth.frame_quantum)
    return np.random.RandomState(9).randn(len(SEQS), frames, MEL).astype(
        np.float32)


def _assert_match_jax(out, ref):
    (wavs, mels), (jwavs, jmels) = out, ref
    assert [m.shape for m in mels] == [m.shape for m in jmels]
    assert [w.shape for w in wavs] == [w.shape for w in jwavs]
    for m, jm in zip(mels, jmels):
        # tests/test_torch_synth.py:88
        np.testing.assert_allclose(m, jm, atol=2e-3, rtol=0)
    for w, jw in zip(wavs, jwavs):
        # tests/test_torch_synth.py:93
        np.testing.assert_allclose(w, jw, atol=1e-4, rtol=0)


def test_reference_mels_match_jax(synths):  # noqa: F811
    jsynth, psynth = synths
    refs = _raw_refs()
    x_T = _x_T(psynth, refs)
    kw = dict(use_max=True, noise_scale=0.0, seed=11, zero_noise=True)
    ref = jsynth.synthesize(SEQS, reference_mels=refs, x_T=jnp.asarray(x_T),
                            **kw)
    out = psynth.synthesize(SEQS, reference_mels=refs, x_T=x_T, **kw)
    _assert_match_jax(out, ref)


def test_reference_wavs_match_jax(synths, port_kw):  # noqa: F811
    jsynth, _ = synths
    jmel = JaxSynthesizer(
        jsynth.model, jsynth.variables, vocoder=jsynth.vocoder,
        vocoder_variables=jsynth.vocoder_variables,
        tokenizer=jsynth.tokenizer, to_mel=JaxMel(n_mels=MEL),
        mel_stats={"mean": MEAN, "std": STD}, frame_quantum=64,
        max_frames_cap=512, upsample=UPSAMPLE)
    pmel = Synthesizer(frame_quantum=64,
                       to_mel=MelSpectrogramTransform(n_mels=MEL), **port_kw)
    wavs = _ref_wavs()
    for w in wavs:
        np.testing.assert_allclose(pmel.wav_to_mel(w), jmel.wav_to_mel(w),
                                   atol=2e-5, rtol=1e-4)
    x_T = _x_T(pmel, [pmel.wav_to_mel(w) for w in wavs])
    kw = dict(use_max=True, noise_scale=0.0, seed=3, zero_noise=True)
    ref = jmel.synthesize(SEQS, reference_wavs=wavs, x_T=jnp.asarray(x_T),
                          **kw)
    out = pmel.synthesize(SEQS, reference_wavs=wavs, x_T=x_T, **kw)
    _assert_match_jax(out, ref)


def test_exactly_one_conditioning(port_kw):
    synth = Synthesizer(**port_kw)
    with pytest.raises(ValueError, match="exactly one"):
        synth.synthesize(SEQS)
    with pytest.raises(ValueError, match="exactly one"):
        synth.synthesize(SEQS, PROMPTS, reference_mels=_raw_refs())
    with pytest.raises(ValueError, match="to_mel"):
        synth.synthesize(SEQS, reference_wavs=_ref_wavs())
    with pytest.raises(ValueError, match="vocoder_mode"):
        Synthesizer(vocoder_mode="streamed", **port_kw)


def _two_phase(port_kw, frame_quantum, seed=2, **cond):
    synth = Synthesizer(frame_quantum=frame_quantum, **port_kw)
    return synth.synthesize(SEQS, seed=seed, **(cond or {"prompts":
                                                         PROMPTS}))


def _assert_same(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cond", ["prompts", "reference_mels"])
def test_speculative_matches_two_phase(port_kw, cond):
    """One dispatch at a predicted bucket that equals the exact bucket
    gives the two-phase result."""
    cond = {"prompts": PROMPTS} if cond == "prompts" \
        else {"reference_mels": _raw_refs()}
    ref = _two_phase(port_kw, 64, **cond)
    exact = bucket_shape(max(m.shape[0] for m in ref[1]), 64)
    spec = Synthesizer(frame_quantum=64, speculative=True,
                       spec_frames_per_phone=exact / max(map(len, SEQS)),
                       **port_kw)
    out = spec.synthesize(SEQS, seed=2, **cond)
    assert (spec.spec_requests, spec.spec_mispredicts) == (1, 0)
    _assert_same(out, ref)


def test_speculative_mispredict_redispatches(port_kw):
    """A too-small bucket is detected from the pass's own unclipped
    duration sums and run again at the true bucket."""
    ref = _two_phase(port_kw, 16)
    assert max(m.shape[0] for m in ref[1]) > 16  # the overflow is real
    spec = Synthesizer(frame_quantum=16, speculative=True,
                       spec_frames_per_phone=0.01, **port_kw)
    out = spec.synthesize(SEQS, PROMPTS, seed=2)
    assert (spec.spec_requests, spec.spec_mispredicts) == (1, 1)
    _assert_same(out, ref)


def test_predict_frames_matches_jax(synths):  # noqa: F811
    jsynth, psynth = synths
    rng = np.random.RandomState(3)
    table, std = rng.uniform(2, 12, 60), rng.uniform(0, 3, 60)
    kw = dict(frame_quantum=32, max_frames_cap=512, speculative=True,
              spec_duration_table=table, spec_duration_std=std)
    jspec = JaxSynthesizer(jsynth.model, jsynth.variables, **kw)
    spec = Synthesizer(psynth.model, device="cpu", **kw)
    for seqs in (SEQS, [[1, 2, 3]], [[59, 61, 70, 0, 4] * 9]):
        phoneme, plens = spec._pad_phonemes_host(seqs)
        assert spec._predict_frames(phoneme, plens) == \
            jspec._predict_frames(phoneme.astype(np.int32),
                                  plens.astype(np.int32))
    plain = Synthesizer(psynth.model, device="cpu", frame_quantum=32,
                        spec_frames_per_phone=7.5)
    phoneme, plens = plain._pad_phonemes_host(SEQS)
    assert plain._predict_frames(phoneme, plens) == 128  # ceil(17 * 7.5)


def test_synthesize_async_resolves_to_synthesize(port_kw):
    synth = Synthesizer(frame_quantum=64, speculative=True,
                        spec_frames_per_phone=8.0, **port_kw)
    jobs = [(SEQS, PROMPTS, 2), (SEQS[::-1], PROMPTS[::-1], 5),
            (SEQS[:1], PROMPTS[:1], 9)]
    refs = [synth.synthesize(s, p, seed=sd) for s, p, sd in jobs]
    handles = [synth.synthesize_async(s, p, seed=sd, return_mels=True)
               for s, p, sd in jobs]  # all three queued before any result
    for h, ref in zip(handles, refs):
        _assert_same(h.result(), ref)
    with pytest.raises(ValueError, match="speculative"):
        Synthesizer(**port_kw).synthesize_async(SEQS, PROMPTS)


def _stream(synth, **kw):
    gen = synth.synthesize_streaming(SEQS, PROMPTS, seed=2, **kw)
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            return chunks, stop.value


@pytest.mark.parametrize("first,speculative", [(None, False), (4, False),
                                               (None, True)])
def test_streaming_matches_batched(port_kw, first, speculative):
    """The stitched stream equals the batched waveform in the interior
    (tests/test_infer.py:334-370), with and without the first-chunk ramp,
    and with the speculative acoustic pass."""
    wav_b, _ = _two_phase(port_kw, 64)
    synth = Synthesizer(frame_quantum=64, chunk_frames=16, halo_frames=HALO,
                        first_chunk_frames=first, speculative=speculative,
                        spec_frames_per_phone=64 / 17, **port_kw)
    chunks, flens = _stream(synth)
    assert len(chunks) >= 2  # incremental
    if first is not None:
        assert chunks[0].shape == (len(SEQS), first * UPSAMPLE)
    stream = np.concatenate(chunks, axis=1)
    for i, a in enumerate(wav_b):
        b = stream[i, : int(flens[i]) * UPSAMPLE]
        assert a.shape == b.shape and len(a) > 2 * MARGIN
        np.testing.assert_allclose(a[MARGIN:-MARGIN], b[MARGIN:-MARGIN],
                                   atol=5e-3)


def test_chunked_vocoder_matches_batched(port_kw):
    wav_b, mel_b = _two_phase(port_kw, 64)
    synth = Synthesizer(frame_quantum=64, vocoder_mode="chunked",
                        chunk_frames=16, halo_frames=HALO, **port_kw)
    wav_c, mel_c = synth.synthesize(SEQS, PROMPTS, seed=2)
    for a, b, ma, mb in zip(wav_b, wav_c, mel_b, mel_c):
        np.testing.assert_array_equal(ma, mb)
        assert a.shape == b.shape
        np.testing.assert_allclose(a[MARGIN:-MARGIN], b[MARGIN:-MARGIN],
                                   atol=5e-3)


def _jax_synth(jsynth, **kw):
    return JaxSynthesizer(
        jsynth.model, jsynth.variables, vocoder=jsynth.vocoder,
        vocoder_variables=jsynth.vocoder_variables,
        tokenizer=jsynth.tokenizer, mel_stats={"mean": MEAN, "std": STD},
        max_frames_cap=512, upsample=UPSAMPLE, **kw)


def _prompt_x_T(psynth):
    phoneme, plens = psynth._pad_phonemes(SEQS)
    ids, mask = psynth._encode_prompts(PROMPTS)
    with torch.no_grad():
        flens = psynth.model.infer_frame_lengths(phoneme, plens, ids, mask)
    frames = bucket_shape(int(flens.max()), psynth.frame_quantum)
    return np.random.RandomState(7).randn(len(SEQS), frames, MEL).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_return_int16_matches_jax(synths, port_kw, mode):  # noqa: F811
    """``return_int16`` quantizes where the JAX ``Synthesizer`` does: the
    batched vocoder (JAX's fused request program), which also serves
    requests with ``x_T`` and ``zero_noise``; chunked vocoding returns
    float32. Same dtype, and values within the wav tolerance of
    ``_assert_match_jax`` (plus one PCM16 step for rounding)."""
    jsynth, _ = synths
    kw = dict(vocoder_mode=mode, chunk_frames=16, halo_frames=HALO,
              frame_quantum=64, return_int16=True)
    jsyn = _jax_synth(jsynth, **kw)
    psyn = Synthesizer(**kw, **port_kw)
    x_T = _prompt_x_T(psyn)
    det = dict(use_max=True, noise_scale=0.0, seed=11, zero_noise=True)
    jwavs, _ = jsyn.synthesize(SEQS, PROMPTS, x_T=jnp.asarray(x_T), **det)
    wavs, _ = psyn.synthesize(SEQS, PROMPTS, x_T=x_T, **det)
    pcm = mode == "batched"
    for w, jw in zip(wavs, jwavs):
        assert w.dtype == jw.dtype == (np.int16 if pcm else np.float32)
        assert w.shape == jw.shape
        scale = 32767.0 if pcm else 1.0
        np.testing.assert_allclose(
            w.astype(np.float64) / scale, jw.astype(np.float64) / scale,
            atol=1e-4 + (1.0 / scale if pcm else 0.0), rtol=0)


def test_return_int16_speculative_async_streaming_match_jax(
        synths, port_kw):  # noqa: F811
    """Speculative requests and ``synthesize_async`` (the batched vocoder)
    return PCM16 as JAX's speculative dispatch does; a stream yields
    float32 chunks in both."""
    jsynth, _ = synths
    kw = dict(frame_quantum=64, speculative=True, spec_frames_per_phone=8.0,
              chunk_frames=16, halo_frames=HALO, return_int16=True)
    jsyn = _jax_synth(jsynth, **kw)
    psyn = Synthesizer(**kw, **port_kw)
    req = dict(use_max=True, noise_scale=0.0, seed=2)
    jwavs, _ = jsyn.synthesize(SEQS, PROMPTS, **req)
    outs = [psyn.synthesize(SEQS, PROMPTS, **req)[0],
            psyn.synthesize_async(SEQS, PROMPTS, **req).result()[0]]
    for wavs in outs:
        for w, jw in zip(wavs, jwavs):
            assert w.dtype == jw.dtype == np.int16 and w.shape == jw.shape
    jchunk = next(iter(jsyn.synthesize_streaming(SEQS, PROMPTS, **req)))
    chunk = next(iter(psyn.synthesize_streaming(SEQS, PROMPTS, **req)))
    assert chunk.dtype == jchunk.dtype == np.float32


def test_short_reference_wav_matches_jax(synths, port_kw):  # noqa: F811
    """A 200-sample reference wav (shorter than the STFT's reflect pad of
    ``n_fft // 2``) conditions a request as in JAX: one log-mel frame, the
    same style embedding, wav and mel."""
    jsynth, _ = synths
    jmel = _jax_synth(jsynth, to_mel=JaxMel(n_mels=MEL), frame_quantum=64)
    pmel = Synthesizer(frame_quantum=64,
                       to_mel=MelSpectrogramTransform(n_mels=MEL), **port_kw)
    wavs = [(0.3 * np.sin(2 * np.pi * 200.0 * np.arange(200) / 24000.0)
             ).astype(np.float32)] * len(SEQS)
    mel = pmel.wav_to_mel(wavs[0])
    assert mel.shape == (1, MEL)
    np.testing.assert_allclose(mel, jmel.wav_to_mel(wavs[0]), atol=2e-5,
                               rtol=1e-4)
    x_T = _x_T(pmel, [mel] * len(SEQS))
    kw = dict(use_max=True, noise_scale=0.0, seed=3, zero_noise=True)
    ref = jmel.synthesize(SEQS, reference_wavs=wavs, x_T=jnp.asarray(x_T),
                          **kw)
    out = pmel.synthesize(SEQS, reference_wavs=wavs, x_T=x_T, **kw)
    _assert_match_jax(out, ref)
