"""The port's synthesize CLI (``promptttspp_tpu_torch/bin/synthesize.py``)
on the CPU against ``egs/proposed/bin/synthesize.py``, on one tiny corpus
with reference-format checkpoints of a seeded tiny model and vocoder
(``tests/test_torch_cuda.py::write_tiny_cli_setup``); the configs of both
entry points against JAX's ``compose``; and the host helpers the CLI uses
(stats, prompt candidates, wav files) against their JAX originals.

JAX's random streams are not torch's, so the two CLIs' runs are compared
by their trees, the prompts they pick and their wav lengths (most probable
style, ``noise_scale=0``); values are compared through the two apps'
synthesizers (tests/test_torch_app.py).
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.bin import synthesize as cli
from promptttspp_tpu_torch.config import parse_value
from promptttspp_tpu_torch.data import dataset
from tests.test_torch_cuda import (
    CLI_ROWS, tiny_cli_overrides, write_tiny_cli_setup)

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return root, write_tiny_cli_setup(root)


def test_read_mel_stats_matches_yaml(tmp_path):
    stats = dict(min=-11.512925148010254, max=2.5, mean=-5.123456789012345,
                 std=2.2, var=1e-20, big=-1.5e300, inf=float("inf"),
                 ninf=float("-inf"))
    path = tmp_path / "stats.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(stats, f)
    assert dataset.read_mel_stats(path) == yaml.safe_load(path.read_text())
    path.write_text("mean: .nan\n")
    assert np.isnan(dataset.read_mel_stats(path)["mean"])


def test_prompt_candidate_readers_match_jax(tmp_path):
    from promptttspp_tpu.data.dataset import (
        read_prompt_candidate, read_spk_prompt_candidate)

    meta = REPO / "metadata"
    assert dataset.read_prompt_candidate(
        meta / "style_prompt_candidates.csv") == read_prompt_candidate(
        meta / "style_prompt_candidates.csv")
    assert dataset.read_spk_prompt_candidate(
        meta / "speaker_prompt_candidates.csv") == read_spk_prompt_candidate(
        meta / "speaker_prompt_candidates.csv")
    path = tmp_path / "cands.csv"
    path.write_text('K1|"A Man, Slowly" ; a calm voice\n\nK2|fast\n')
    assert dataset.read_prompt_candidate(path) == \
        read_prompt_candidate(path)


def test_write_wav_matches_jax(tmp_path):
    from promptttspp_tpu.infer import write_wav as jax_write_wav

    from promptttspp_tpu_torch.infer import write_wav

    wav = np.random.RandomState(0).randn(4001).astype(np.float32) * 0.7
    write_wav(tmp_path / "a.wav", wav)
    jax_write_wav(tmp_path / "b.wav", wav)
    write_wav(tmp_path / "c.wav", wav, 16000)
    jax_write_wav(tmp_path / "d.wav", wav, 16000)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()
    assert (tmp_path / "c.wav").read_bytes() == \
        (tmp_path / "d.wav").read_bytes()


def _strip(node):
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items() if k != "_target_"}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


@pytest.mark.parametrize("name", ["synthesize", "demo"])
@pytest.mark.parametrize("overrides", [
    [],
    ["path.root=/data/corpus", "path.mel_dir=/stats/mel", "use_max=false",
     "noise_scale=0", "+speculative=true", "+spec_margin=2.5",
     "+vocoder_mode=chunked", "~vocoder_ckpt", "hydra.run.dir=/tmp/run"],
    ["model=prompttts_mdn_v2_wo_erg_final_demo"],
    ["model=prompttts_mdn_v2_wo_erg_final", "+decode_param_dtype=bfloat16"],
    "tiny"], ids=["defaults", "serving", "demo_model", "flagship", "tiny"])
def test_entry_point_configs_match_compose(name, overrides):
    """The port's configs of the CLI and the app equal JAX's ``compose`` of
    the same YAML and overrides (interpolations resolved), but for the
    port's ``device`` key, the ``dataset`` group the serving path does not
    read and the hydra node, of which only ``run.dir`` is used."""
    from promptttspp_tpu.config import compose

    if overrides == "tiny":
        overrides = tiny_cli_overrides()
    ours = conf.compose(name, overrides)
    ref = _strip(compose(REPO / "conf", name, overrides=overrides,
                         drop_hydra_node=False).to_dict())
    assert ours.pop("device") == "cuda"
    ref.pop("dataset", None)
    assert ours.pop("hydra") == {"run": {"dir": ref.pop("hydra")["run"][
        "dir"]}}
    assert ours == ref


def test_override_values_read_as_jax_reads_them():
    from promptttspp_tpu.config.compose import _parse_value

    for text in ("1", "-3", "2.5", "1e-3", "1.", ".5", "true", "False",
                 "null", "~", "yes", "off", "abc", "path/to/x.ckpt",
                 "[3]", "[[1,3],[1,3,5]]", "[a, 'b,c', 2]", "'quoted'",
                 '"7"', "[]", ".inf", "-.inf", "", "bfloat16"):
        assert parse_value(text) == _parse_value(text), text


def test_tiny_cli_model_is_the_e2e_tests_model():
    from tests.test_e2e_cli import TINY_MODEL_OVERRIDES
    from tests.test_torch_cuda import TINY_CLI_MODEL

    assert TINY_CLI_MODEL == TINY_MODEL_OVERRIDES


def test_override_rules(setup):
    with pytest.raises(KeyError, match=r"\+speculative"):
        conf.compose("synthesize", ["speculative=true"])
    with pytest.raises(ValueError, match="bigvgan_f0"):
        conf.compose("synthesize", ["vocoder=bigvgan"])
    cfg = conf.compose("synthesize", ["model.phoneme_embedding.channels=48"])
    assert cfg["model"]["style_mdn"]["out_dim"] == 48
    assert cfg["model"]["decoder"]["in_dim"] == 256


def test_cli_refuses_unported_options(setup):
    root, argv = setup
    for extra, match in ((["~model_ckpt"], "model_ckpt"),):
        cfg = conf.compose("synthesize", argv + ["device=cpu"] + extra)
        with pytest.raises(ValueError, match=match):
            cli.build_synthesizer(cfg)


def test_cli_serves_sharded_modes_on_a_cpu_mesh(setup):
    """``+vocoder_mode=sharded +frame_sharded_decode=true device=cpu``
    builds a ``Synthesizer`` with both modes over a mesh of the one CPU
    device (JAX's CLI passes both modes on; on the GPU the mesh is every
    visible GPU). One request gives the mel of the unsharded decode and
    the wav of the chunked vocoder the sharded one splits (the CLI's
    ``+vocoder_mode=chunked``, whose decode is the batched mode's), at
    tests/test_torch_parallel.py's bars for the sharded paths."""
    from tests.test_torch_parallel import SHARDED_ATOL

    root, argv = setup
    base = argv + ["device=cpu"]
    synth = cli.build_synthesizer(conf.compose("synthesize", base + [
        "+vocoder_mode=sharded", "+frame_sharded_decode=true"]))
    assert synth.vocoder_mode == "sharded" and synth.frame_sharded_decode
    assert [[d.type for d in row] for row in synth.mesh.devices] == [["cpu"]]
    ref = cli.build_synthesizer(conf.compose(
        "synthesize", base + ["+vocoder_mode=chunked"]))
    assert ref.mesh is None and not ref.frame_sharded_decode
    req = dict(prompts=["a calm voice."], use_max=True, noise_scale=0.0,
               seed=3)
    seq = [list(CLI_ROWS[0]["seq"])]
    wavs, mels = synth.synthesize(seq, **req)
    ref_wavs, ref_mels = ref.synthesize(seq, **req)
    np.testing.assert_allclose(mels[0], ref_mels[0], rtol=0,
                               atol=SHARDED_ATOL * synth.mel_stats["std"])
    assert wavs[0].shape == ref_wavs[0].shape
    np.testing.assert_allclose(wavs[0], ref_wavs[0], rtol=0, atol=1e-5)


def _tree(out: Path):
    from scipy.io import wavfile

    return {p.relative_to(out).as_posix(): len(wavfile.read(p)[1])
            for p in sorted(out.rglob("*.wav"))}


def test_cli_matches_jax_cli(setup, tmp_path):
    """Both CLIs on one tiny corpus and one pair of checkpoint files: the
    same eval tree and finish marker, the prompts JAX's reader and
    ``RandomState(seed).choice`` pick, and the same wav lengths."""
    from promptttspp_tpu.data.dataset import read_prompt_candidate

    root, argv = setup
    args = argv + ["num_eval_utts=2", "noise_scale=0", "seed=5"]
    jout, pout = tmp_path / "jax", tmp_path / "port"
    proc = subprocess.run(
        [sys.executable, str(REPO / "egs/proposed/bin/synthesize.py"),
         *args, f"output_dir={jout}", f"hydra.run.dir={tmp_path}"],
        capture_output=True, text=True, env=_env(), timeout=560)
    assert proc.returncode == 0, proc.stderr[-3000:]

    prompts = []
    real = cli.Synthesizer.synthesize

    def spy(self, seqs, **kw):
        prompts.extend(kw.get("prompts") or [])
        return real(self, seqs, **kw)

    cwd = os.getcwd()
    try:
        with mock.patch.object(cli.Synthesizer, "synthesize", spy):
            cli.main(args + [f"output_dir={pout}", f"hydra.run.dir={tmp_path}",
                             "device=cpu"])
    finally:
        os.chdir(cwd)

    cands = read_prompt_candidate(
        root / "metadata/style_prompt_candidates.csv")
    rng = np.random.RandomState(5)
    assert prompts == [f"{rng.choice(cands[r['style_prompt_key']])}."
                       for r in CLI_ROWS[:2]]
    tree = _tree(pout)
    assert tree == _tree(jout)
    assert len(tree) == 4 and len(set(tree.values())) > 1
    assert (pout / "finish").read_text() == (jout / "finish").read_text()


def test_cli_module_runs_on_the_cpu_when_asked(setup, tmp_path):
    """``python3 -m promptttspp_tpu_torch.bin.synthesize``: with
    ``device=cpu`` it writes the tree (relative ``output_dir`` inside
    ``hydra.run.dir``); without it, on a machine without a GPU, ``main``
    raises."""
    root, argv = setup
    cmd = [sys.executable, "-m", "promptttspp_tpu_torch.bin.synthesize",
           *argv, "num_eval_utts=1", "output_dir=out",
           f"hydra.run.dir={tmp_path / 'run'}"]
    proc = subprocess.run(cmd + ["device=cpu"], cwd=REPO, capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "run" / "out"
    assert sorted(_tree(out)) == ["11/prompt/wav/utt_11_0.wav",
                                  "11/ref/wav/utt_11_0.wav"]
    assert (out / "finish").exists()
    if torch.cuda.is_available():
        return
    cwd = os.getcwd()
    try:
        with pytest.raises(RuntimeError,
                           match=r"torch\.cuda\.is_available"):
            cli.main(argv + [f"hydra.run.dir={tmp_path / 'gpu'}"])
    finally:
        os.chdir(cwd)
