"""The port's demo app (``promptttspp_tpu_torch/app.py``) on the CPU
against ``app.py``: the two apps' synthesizers (the demo model, legacy
relative positions) on the same reference-format checkpoint files
(``tests/test_torch_cuda.py::write_tiny_cli_setup``), its command-line
fallback, and its host helpers (G2P fallback, reference-wav reading)."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from promptttspp_tpu_torch import app
from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.data.batching import bucket_shape
from tests.test_torch_cli import _env
from tests.test_torch_cuda import write_tiny_cli_setup

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return root, write_tiny_cli_setup(root)


def test_content_to_sequence_matches_jax():
    """Without g2p_en (absent here) both read ARPA phonemes and refuse
    anything else."""
    import app as jax_app

    for content in ("HH AH0 L OW1 sil W ER1 L D", "sp AA1 sil"):
        assert app.content_to_sequence(content) == \
            jax_app.content_to_sequence(content)
    for fn in (app.content_to_sequence, jax_app.content_to_sequence):
        with pytest.raises(SystemExit, match="g2p_en"):
            fn("Hello world.")


@pytest.mark.parametrize("sr,channels,dtype", [
    (16000, 2, np.int16), (24000, 1, np.int16), (48000, 1, np.float32),
    (22050, 1, np.int32)])
def test_load_wav_24k_matches_jax(tmp_path, sr, channels, dtype):
    from scipy.io import wavfile

    import app as jax_app

    rng = np.random.RandomState(sr)
    wav = 0.5 * rng.randn(sr // 3, channels).squeeze()
    if np.dtype(dtype).kind == "i":
        wav = (wav * np.iinfo(dtype).max * 0.5).astype(dtype)
    wavfile.write(tmp_path / "x.wav", sr, wav.astype(dtype))
    ours = app.load_wav_24k(tmp_path / "x.wav")
    ref = jax_app.load_wav_24k(tmp_path / "x.wav")
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_app_demo_request_matches_jax(setup):
    """The two apps' synthesizers (the demo model: legacy relative
    positions) on the same checkpoint files: a prompt request with a fixed
    x_T and no diffusion noise gives the same mel and wav. (Reference-wav
    requests are held to JAX's in tests/test_torch_infer.py.)"""
    import app as jax_app
    from promptttspp_tpu.config import compose

    root, argv = setup
    args = argv + [f"mel_stats_file={root}/dump/libritts_r_per_spk_cleaned/"
                   "mel63/stats.yaml"]
    pcfg = conf.compose("demo", args + ["device=cpu"])
    assert pcfg["model"]["encoder"]["rel_pos_type"] == "legacy"
    psynth = app.build_synthesizer(pcfg)
    jsynth = jax_app.build_synthesizer(compose(REPO / "conf", "demo",
                                               overrides=args))
    seq = app.content_to_sequence("HH AH0 L OW1 sil W ER1 L D AA1 N")
    kw = dict(prompts=["A calm low slow male voice."], use_max=True,
              noise_scale=0.0)
    _, mels = psynth.synthesize([seq], **kw)
    frames = bucket_shape(len(mels[0]), psynth.frame_quantum)
    x_T = np.random.RandomState(frames).randn(1, frames, 80).astype(
        np.float32)
    wavs, mels = psynth.synthesize([seq], x_T=x_T, zero_noise=True, **kw)
    jwavs, jmels = jsynth.synthesize([seq], x_T=jnp.asarray(x_T),
                                     zero_noise=True, **kw)
    assert mels[0].shape == jmels[0].shape
    # tests/test_torch_synth.py::test_synthesize_matches_jax
    np.testing.assert_allclose(mels[0], jmels[0], atol=2e-3, rtol=0)
    np.testing.assert_allclose(wavs[0], jwavs[0], atol=1e-4, rtol=0)


def test_app_cli_fallback(setup, tmp_path):
    """Without gradio the app reads the content and a style prompt (or
    ``@<wav>``) from standard input and writes demo_out.wav: as a module
    with ``device=cpu``, and in-process with a reference wav."""
    root, argv = setup
    proc = subprocess.run(
        [sys.executable, "-m", "promptttspp_tpu_torch.app", *argv,
         "device=cpu", f"hydra.run.dir={tmp_path / 'a'}",
         f"mel_stats_file={root}/dump/libritts_r_per_spk_cleaned/mel63/"
         "stats.yaml"],
        input="HH AH0 L OW1 W ER1 L D\na calm low voice\n", cwd=REPO,
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "a" / "demo_out.wav").exists()
    answers = iter(["HH AH0 L OW1", "@" + str(
        root / "data_prep/out/libritts_r_per_spk_cleaned/11/wav24k/"
        "utt_11_0.wav")])
    cwd = os.getcwd()
    try:
        with mock.patch("builtins.input", lambda _: next(answers)), \
                redirect_stdout(io.StringIO()) as out:
            app.main(argv + ["device=cpu", f"hydra.run.dir={tmp_path / 'b'}",
                             f"mel_stats_file={root}/dump/"
                             "libritts_r_per_spk_cleaned/mel63/stats.yaml"])
    finally:
        os.chdir(cwd)
    assert "wrote demo_out.wav" in out.getvalue()
    assert (tmp_path / "b" / "demo_out.wav").exists()
