"""The whole slice: the port's ``Synthesizer`` (tiny model and tiny vocoder
on the CPU) against the JAX ``Synthesizer`` with the same weights, the same
padded frame bucket, the same ``x_T``, zero diffusion noise, the most
probable style component and ``noise_scale=0``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.infer import Synthesizer as JaxSynthesizer
from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.infer import Synthesizer
from tests.test_torch_acoustic import MEL, init_jax_twins, perturbed

MEAN, STD = -1.3, 2.1
UPSAMPLE = 8
VOC_KW = dict(sampling_rate=24000, harmonic_num=2, in_channel=MEL,
              upsample_initial_channel=16, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
              resblock_dilations=((1, 2),))
SEQS = [[5, 17, 33, 45, 8, 61, 29, 74, 5, 50, 12, 88, 41, 23, 66, 9, 30],
        [2, 19, 44, 71, 3, 60, 28, 15]]
PROMPTS = ["a calm low voice", "fast bright speech"]


class WordIdTokenizer:
    """Deterministic ids below the tiny BERT's vocabulary of 64."""

    pad_id = 0

    def batch_encode(self, prompts):
        seqs = [[1] + [2 + sum(map(ord, w)) % 60 for w in p.split()] + [3]
                for p in prompts]
        L = max(len(s) for s in seqs)
        ids = np.zeros((len(seqs), L), np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        return ids, mask


@pytest.fixture(scope="module")
def synths():
    from promptttspp_tpu.vocoders.bigvgan_f0 import F0AwareBigVGAN as JaxVoc

    model, variables, port = init_jax_twins(seed=3)
    jvoc = JaxVoc(**VOC_KW)
    voc_vars = perturbed(jax.jit(lambda k: jvoc.init(
        k, jnp.zeros((1, 16, MEL)), jnp.zeros((1, 16, 1)),
        deterministic=True))(jax.random.PRNGKey(2)), seed=4)
    voc_vars = {"params": voc_vars["params"]}
    port_voc = flagship.build_vocoder("cpu", 0, VOC_KW)
    load_jax_variables(port_voc, voc_vars)
    kw = dict(tokenizer=WordIdTokenizer(),
              mel_stats={"mean": MEAN, "std": STD}, frame_quantum=64,
              max_frames_cap=512, upsample=UPSAMPLE)
    jsynth = JaxSynthesizer(model, variables, vocoder=jvoc,
                            vocoder_variables=voc_vars, **kw)
    psynth = Synthesizer(port, port_voc, device="cpu", **kw)
    return jsynth, psynth


def test_synthesize_matches_jax(synths):
    jsynth, psynth = synths
    phoneme, plens = psynth._pad_phonemes(SEQS)
    ids, mask = psynth._encode_prompts(PROMPTS)
    with torch.no_grad():
        flens = psynth.model.infer_frame_lengths(phoneme, plens, ids, mask)
    frames = bucket_shape(int(flens.max()), psynth.frame_quantum)
    x_T = np.random.RandomState(7).randn(len(SEQS), frames, MEL).astype(
        np.float32)
    kw = dict(use_max=True, noise_scale=0.0, seed=11, x_T=x_T,
              zero_noise=True)
    jwavs, jmels = jsynth.synthesize(SEQS, prompts=PROMPTS,
                                     x_T=jnp.asarray(x_T), **{
                                         k: v for k, v in kw.items()
                                         if k != "x_T"})
    wavs, mels = psynth.synthesize(SEQS, PROMPTS, **kw)
    assert [m.shape for m in mels] == [m.shape for m in jmels]
    assert [w.shape for w in wavs] == [w.shape for w in jwavs]
    for m, jm in zip(mels, jmels):
        # precedent: tests/test_e2e_wav_parity.py:215
        np.testing.assert_allclose(m, jm, atol=2e-3, rtol=0)
    for w, jw in zip(wavs, jwavs):
        # float32 on both sides through the mel, the F0 filter (float64
        # impulse response here, float32 recurrence in JAX) and the
        # vocoder; tanh-bounded output
        np.testing.assert_allclose(w, jw, atol=1e-4, rtol=0)


def test_pcm16_output(synths):
    _, psynth = synths
    wavs, _ = psynth.synthesize(SEQS, PROMPTS, noise_scale=0.0, seed=5,
                                return_mels=False)
    psynth.return_int16 = True
    try:
        pcm, mels = psynth.synthesize(SEQS, PROMPTS, noise_scale=0.0,
                                      seed=5, return_mels=False)
    finally:
        psynth.return_int16 = False
    assert mels == []
    for w, p in zip(wavs, pcm):
        assert p.dtype == np.int16 and p.shape == w.shape
        np.testing.assert_array_equal(
            p, np.clip(np.round(w * 32767.0), -32768, 32767).astype(
                np.int16))


def test_seeded_noise_is_reproducible(synths):
    _, psynth = synths
    a, _ = psynth.synthesize(SEQS[:1], PROMPTS[:1], use_max=False,
                             noise_scale=0.5, seed=2)
    b, _ = psynth.synthesize(SEQS[:1], PROMPTS[:1], use_max=False,
                             noise_scale=0.5, seed=2)
    c, _ = psynth.synthesize(SEQS[:1], PROMPTS[:1], use_max=False,
                             noise_scale=0.5, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    assert np.isfinite(c[0]).all()
    assert c[0].shape != a[0].shape or not np.array_equal(a[0], c[0])
