"""The port's recipe on the CPU, in-process: ``bin/preprocess.py`` ->
``bin/split_df.py`` -> ``bin/compute_mel.py`` -> ``bin/split_df.py`` ->
``bin/filter_eval.py`` on a raw synthetic corpus, ``bin/train.py`` for two
updates of the tiny model on the tree they write, ``bin/synthesize.py`` on
its ``ckpt/last`` and ``bin/eval.py`` on that output, its metrics held to
JAX's ``evaluate_pair`` on the same wavs."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import compute_mel, conf, filter_eval
from promptttspp_tpu_torch.bin import eval as eval_cli
from promptttspp_tpu_torch.bin import preprocess, split_df
from promptttspp_tpu_torch.bin import synthesize as synth_cli
from promptttspp_tpu_torch.bin import train as train_cli
from promptttspp_tpu_torch.bin.synthesize import read_wav
from promptttspp_tpu_torch.compat.torch_ckpt import (
    BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
from tests.test_torch_cuda import TINY_CLI_MODEL, TINY_CLI_VOCODER
from tests.test_torch_preprocess import make_raw_corpus

PAIR_RTOL = 1e-3  # tests/test_torch_eval.py


def _in(cwd, fn, argv):
    try:
        return fn(argv)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The five preprocessing stages, then training, synthesis and
    evaluation -> (root, printed output of the stages, eval report)."""
    root = make_raw_corpus(tmp_path_factory.mktemp("recipe"),
                           speakers={121: 2, 19: 2, 100: 2, 1001: 2})
    cwd = os.getcwd()
    args = [f"path.root={root}", "device=cpu", "eval_ids=[121]",
            "batch_size=4", "min_sec=1.0", f"hydra.run.dir={root / 'run'}"]
    for stage in (preprocess, split_df, compute_mel, split_df, filter_eval):
        _in(cwd, stage.main, args)
    out = root / "out"
    _in(cwd, train_cli.main, [
        f"path.root={root}", f"output_dir={out}", "device=cpu",
        "dataset.max_tokens=4000", "train.num_epochs=2",
        "train.lr_scheduler.warmup_steps=10", f"hydra.run.dir={root / 'run'}",
        *TINY_CLI_MODEL])
    cfg = conf.compose("synthesize", TINY_CLI_VOCODER)
    vocoder = flagship.build_vocoder("cpu", seed=8, cfg=cfg["vocoder"])
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    synth_args = [f"path.root={root}", f"output_dir={root / 'synth'}",
                  "device=cpu", f"hydra.run.dir={root / 'run'}",
                  "num_eval_utts=1", *TINY_CLI_MODEL, *TINY_CLI_VOCODER]
    _in(cwd, synth_cli.main, synth_args + [
        f"model_ckpt={out / 'ckpt/last'}",
        f"vocoder_ckpt={root / 'vocoder.ckpt'}", "noise_scale=0"])
    report = _in(cwd, eval_cli.main, synth_args)
    return root, report


def test_stages_write_the_recipe_tree(recipe):
    root, _ = recipe
    dump = root / "dump/libritts_r_per_spk_cleaned"
    for f in ("df/data.csv", "df/train.csv", "df/eval.csv", "df/finish",
              "df_filtered/trn.csv", "df_filtered/val.csv",
              "df_filtered/eval_filtered.csv", "mel63/stats.yaml",
              "mel63/finish"):
        assert (dump / f).exists(), f
    rows = (dump / "df/data.csv").read_text().splitlines()
    assert rows[0].split(",")[-2:] == ["seq", "durations"]
    assert len(rows) == 9
    evals = (dump / "df_filtered/eval_filtered.csv").read_text().splitlines()
    assert len(evals) == 3 and all(r.startswith("121,") for r in evals[1:])
    stats = yaml.safe_load((dump / "mel63/stats.yaml").read_text())
    assert sorted(stats) == ["max", "mean", "min", "std", "var"]


def test_train_took_two_updates(recipe):
    root, _ = recipe
    assert (root / "out/ckpt/last").exists()
    loss = (root / "out/logs/loss.csv").read_text().splitlines()
    assert len(loss) == 3  # header and one row per epoch


def test_eval_report_matches_jax(recipe):
    from promptttspp_tpu.eval.metrics import evaluate_pair as jax_pair

    root, report = recipe
    assert json.loads((root / "synth/eval_metrics.json").read_text()) == \
        json.loads(json.dumps(report))
    assert sorted(report) == ["prompt", "ref"]
    data_root = root / "data_prep/out/libritts_r_per_spk_cleaned"
    for mode, r in report.items():
        assert r["n_utts"] == 1
        utt = r["utts"][0]
        assert np.isfinite(utt["mcd"]) and np.isfinite(utt["mel_l1"])
        ref = jax_pair(
            read_wav(data_root / "121" / "wav24k"
                     / f"{utt['item_name']}.wav")[1],
            read_wav(root / "synth" / "121" / mode / "wav"
                     / f"{utt['item_name']}.wav")[1])
        for k, v in ref.items():
            np.testing.assert_allclose(utt[k], v, rtol=PAIR_RTOL,
                                       err_msg=f"{mode} {k}")


def test_compute_mel_reextracts_without_its_marker(recipe, tmp_path):
    """Without ``mel63/finish``, ``bin/compute_mel.py`` extracts the mels
    of ``data.csv`` again (1-s buckets): the same frames as
    ``bin/preprocess.py`` wrote, within the FFT tolerance, and the
    statistics within float32 rounding."""
    import shutil

    root, _ = recipe
    dump = root / "dump/libritts_r_per_spk_cleaned"
    mel_dir = tmp_path / "mel63"
    _in(os.getcwd(), compute_mel.main, [
        f"path.root={root}", "device=cpu", f"path.mel_dir={mel_dir}",
        f"hydra.run.dir={tmp_path}"])
    assert (mel_dir / "finish").exists()
    for p in sorted((dump / "mel63").rglob("*.npy")):
        q = mel_dir / p.relative_to(dump / "mel63")
        np.testing.assert_allclose(np.load(q), np.load(p), atol=1e-4,
                                   rtol=0)
    a = yaml.safe_load((dump / "mel63/stats.yaml").read_text())
    b = yaml.safe_load((mel_dir / "stats.yaml").read_text())
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5)
    shutil.rmtree(mel_dir)


@pytest.mark.parametrize("cli", [preprocess, compute_mel, split_df,
                                 filter_eval, eval_cli],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_points_refuse_a_missing_gpu(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = os.getcwd()
    with pytest.raises(RuntimeError, match="cuda"):
        _in(cwd, cli.main, [f"path.root={tmp_path}",
                            f"hydra.run.dir={tmp_path}"])
