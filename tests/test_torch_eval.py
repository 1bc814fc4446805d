"""The port's evaluation metrics (``eval/metrics.py``) and per-utterance
statistics (``data_prep/``) against the JAX package on the CPU."""


import numpy as np
import pytest

from promptttspp_tpu_torch.data_prep import audio_metrics, stats
from promptttspp_tpu_torch.eval import metrics
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    raw_textgrid, speech_like)

SR = 24000
PAIR_RTOL = 1e-3  # evaluate_pair: float32 mels and YIN of another FFT


@pytest.fixture(scope="module")
def wavs():
    ref = speech_like(1.6, 150.0, seed=0).astype(np.float32)
    syn = speech_like(1.9, 160.0, seed=1).astype(np.float32)
    return ref, syn


def test_host_metrics_equal_jax():
    from promptttspp_tpu.eval import metrics as jm

    rng = np.random.RandomState(0)
    a, b = rng.randn(37, 80) - 5, rng.randn(44, 80) - 5
    np.testing.assert_array_equal(metrics.mel_cepstra(a), jm.mel_cepstra(a))
    path = metrics.dtw_path(a[:, :12], b[:, :12])
    np.testing.assert_array_equal(path, jm.dtw_path(a[:, :12], b[:, :12]))
    assert metrics.mcd(a, b) == jm.mcd(a, b)
    assert metrics.mel_l1(a, b) == jm.mel_l1(a, b)
    fa, fb = 100 + 50 * rng.rand(37), 100 + 50 * rng.rand(44)
    va, vb = rng.rand(37) > 0.3, rng.rand(44) > 0.3
    assert metrics.f0_metrics(fa, va, fb, vb, path) == jm.f0_metrics(
        fa, va, fb, vb, path)
    rows = [{"mcd": 1.0, "f0_rmse_cents": float("nan")},
            {"mcd": 3.0, "f0_rmse_cents": 20.0}]
    assert metrics.summarize(rows) == jm.summarize(rows)


def test_evaluate_pair_matches_jax(wavs):
    from promptttspp_tpu.eval.metrics import evaluate_pair as jax_pair

    ref, syn = wavs
    ours = metrics.evaluate_pair(ref, syn, SR, device="cpu")
    theirs = jax_pair(ref, syn, SR)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=PAIR_RTOL, err_msg=k)
    same = metrics.evaluate_pair(ref, ref, SR, device="cpu")
    assert same["mcd"] == 0.0 and same["vuv_error"] == 0.0


def test_audio_metrics_equal_jax(wavs):
    from promptttspp_tpu.data_prep import audio_metrics as jam

    ref, _ = wavs
    freqs = np.linspace(10, 12000, 50)
    np.testing.assert_array_equal(audio_metrics.a_weighting_db(freqs),
                                  jam.a_weighting_db(freqs))
    np.testing.assert_array_equal(
        audio_metrics.perceptual_loudness(ref, SR),
        jam.perceptual_loudness(ref, SR))
    assert audio_metrics.integrated_loudness(ref, SR) == \
        jam.integrated_loudness(ref, SR)
    for w in ("table", "little", "created", "eye", "rhythm", "queue"):
        assert audio_metrics.estimate_syllables(w) == \
            jam.estimate_syllables(w)


def test_utterance_stats_match_jax(wavs, tmp_path):
    """``compute_utt_stats``: the loudness, speaking rate and F0 statistics
    (YIN at a 5-ms hop) of one utterance, rounded to 2 decimals as in JAX;
    within one rounding step."""
    from promptttspp_tpu.data_prep import stats as jstats

    ref, _ = wavs
    tg = tmp_path / "u.TextGrid"
    tg.write_text(raw_textgrid(len(ref) / SR, np.random.RandomState(0)))
    ours = stats.compute_utt_stats(ref, SR, tg, device="cpu")
    theirs = jstats.compute_utt_stats(ref, SR, tg)
    assert sorted(ours) == sorted(theirs)
    assert ours["invalid"] == theirs["invalid"] == 0
    for k, v in theirs.items():
        assert abs(ours[k] - v) <= 0.0101, (k, ours[k], v)
    assert stats.compute_speaking_rate(tg) == jstats.compute_speaking_rate(tg)


def test_labels_equal_jax():
    from promptttspp_tpu.data_prep import stats as jstats

    for v in (-2.0, -1.0, -0.6, 0.0, 0.6, 1.0, 2.0):
        for level in (3, 5):
            assert stats.norm2label(v, level) == jstats.norm2label(v, level)
    vals = {"M": [1.0, 2.0, 4.0], "F": [3.0, 3.5]}
    ours, theirs = stats.GenderScaler().fit(vals), \
        jstats.GenderScaler().fit(vals)
    for g in vals:
        assert ours.normalize(2.5, g) == theirs.normalize(2.5, g)
        assert stats.pseudo_label(2.5, g, ours, ["low", "normal", "high"]) \
            == jstats.pseudo_label(2.5, g, theirs, ["low", "normal", "high"])
    assert stats.style_key("F", "very high", "low", "normal") == \
        jstats.style_key("F", "very high", "low", "normal")
