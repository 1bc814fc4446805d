"""The port's trainer and its CLI on the CPU, on a synthetic corpus
(``tools/synthetic_corpus.py``) with the tiny model of the CLI tests
(``tests/test_torch_cuda.py::TINY_CLI_MODEL``): the settings it refuses
and those it takes, the input pipelines against each other and the
automatic choice among them, resume against an uninterrupted run, the
emergency checkpoint, warm start, a fixed batch size and a profile, and
``bin/train.py`` for two epochs (and for one in bf16) whose ``ckpt/last``
``bin/synthesize.py`` then serves."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.bin import synthesize as synth_cli
from promptttspp_tpu_torch.bin import train as train_cli
from promptttspp_tpu_torch.compat.torch_ckpt import (
    BIGVGAN_WEIGHT_NORMED, load_reference_state_dict,
    to_reference_state_dict, torch_state_dict)
from promptttspp_tpu_torch.data.dataset import AllWithSpkPromptNormDataset
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    training_rows, write_corpus, write_training_corpus)
from promptttspp_tpu_torch.train.trainer import TTSTrainer
from tests.test_torch_cuda import TINY_CLI_MODEL, TINY_CLI_VOCODER
from tests.test_torch_train_data import candidates

MEL_STATS = dict(mel_mean=-4.5, mel_std=2.1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A training corpus (21 train and 3 valid utterances) and an eval
    corpus of 2 utterances with the same prompt candidates and vocabulary,
    and a tiny vocoder in the reference's checkpoint format."""
    root = tmp_path_factory.mktemp("corpus")
    cands, spk = candidates(n_keys=8)
    rows = training_rows(24, cands, spk, phones=(4, 12),
                         frames_per_phone=(2, 6), valid_every=8, seed=1)
    eval_rows = [dict(spk_id=r["spk_id"], item_name=f"eval_{i}",
                      seq=r["seq"], style_prompt_key=r["style_prompt_key"])
                 for i, r in enumerate(rows[:2])]
    write_corpus(root, eval_rows, cands, wav_seconds=0.5, **MEL_STATS)
    write_training_corpus(root, rows, cands, spk, **MEL_STATS)
    cfg = conf.compose("synthesize", TINY_CLI_VOCODER)
    vocoder = flagship.build_vocoder("cpu", seed=8, cfg=cfg["vocoder"])
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    return root


def train_args(root, out, *extra):
    return [f"path.root={root}", f"output_dir={out}", "device=cpu",
            "dataset.max_tokens=300", "train.lr_scheduler.warmup_steps=10",
            "train.save_interval=2", "+dataset.train.seed=1",
            "+dataset.valid.seed=2", *TINY_CLI_MODEL, *extra]


def run_trainer(root, out, *extra, **kw):
    cfg = conf.compose("train", train_args(root, out, *extra))
    vocab = cfg["path"]["bert_vocab_file"]
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer

    trainer = TTSTrainer(cfg, tokenizer=WordPieceTokenizer.from_vocab_file(
        vocab), **kw)
    trainer.run()
    return trainer


def _rows(path):
    lines = Path(path).read_text().splitlines()
    return [dict(zip(lines[0].split(","), map(float, ln.split(","))))
            for ln in lines[1:]]


@pytest.mark.parametrize("override,key", [
    ("+train.mesh.model=2", "train.mesh.model"),
    ("+train.mesh.pipeline_microbatches=-1",
     "train.mesh.pipeline_microbatches"),
    ("+train.distributed.num_processes=2",
     "train.distributed.num_processes"),
    ("+train.input_pipeline=threads", "train.input_pipeline")])
def test_unported_settings_raise_naming_the_key(tmp_path, override, key):
    cfg = conf.compose("train", train_args(tmp_path, tmp_path, override))
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        TTSTrainer(cfg)


@pytest.mark.parametrize("override,key", [
    ("+train.compilation_cache_dir=/tmp/xla", "train.compilation_cache_dir"),
    ("train.per_epoch_scheduler=true", "train.per_epoch_scheduler")])
def test_settings_without_effect_are_taken_and_logged(tmp_path, caplog,
                                                      override, key):
    """JAX's trainer takes both keys: it never reads
    ``per_epoch_scheduler``, and ``compilation_cache_dir`` sets XLA's
    cache. The port builds its trainer and logs each key as ignored."""
    cfg = conf.compose("train", train_args(tmp_path, tmp_path, override))
    with caplog.at_level("WARNING", logger="promptttspp_tpu_torch.train"):
        TTSTrainer(cfg)
    assert any(key in r.getMessage() and "ignored" in r.getMessage()
               for r in caplog.records), caplog.text


class _FakeDataGroup:
    rank = 0

    def __init__(self, world):
        self.world = world


def _two_process_trainer(monkeypatch, cfg, data_ranks):
    """A trainer that sees two processes, ``data_ranks`` of them on the
    data axis (1: one data shard over a model axis of two), as rank 0 of a
    torch.distributed group would, without starting a group."""
    from promptttspp_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "init_distributed", lambda *a: True)
    monkeypatch.setattr(trainer_mod, "process_groups",
                        lambda *a: (_FakeDataGroup(data_ranks), None))
    monkeypatch.setattr(trainer_mod, "rank_device",
                        lambda kind: torch.device("cpu"))
    monkeypatch.setattr(trainer_mod.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(trainer_mod.dist, "get_world_size", lambda: 2)
    return TTSTrainer(cfg)


LONG_PROMPT = " ".join(["a", "calm", "deep", "voice"] * 20)  # 80 words


@pytest.mark.parametrize("world,data_ranks", [(1, 1), (2, 2), (2, 1)])
def test_prompts_pad_to_the_key_under_several_processes(corpus, monkeypatch,
                                                        world, data_ranks):
    """Under two processes (two data ranks, or one data shard over a model
    axis of two) a rank's prompts are padded and cut to
    ``train.prompt_pad_to`` (default 64) as JAX's ``collate(...,
    prompt_pad_to=64)`` pads them: a prompt of 82 WordPiece tokens loses
    its tail and its closing [SEP]. One process pads to the bucket of the
    longest prompt, and cuts nothing, as JAX does."""
    from promptttspp_tpu.data.collate import PromptTTSCollator as JaxCollator
    from promptttspp_tpu.models.bert import WordPieceTokenizer as JaxTok
    from promptttspp_tpu_torch.data.collate import PromptTTSCollator
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer

    vocab = corpus / "metadata/bert-base-uncased-vocab.txt"
    cfg = conf.compose("train", train_args(corpus, corpus / "unused"))
    trainer = (_two_process_trainer(monkeypatch, cfg, data_ranks)
               if world == 2 else TTSTrainer(cfg))
    assert trainer.prompt_pad_to == (64 if world == 2 else None)
    trainer._build_datasets()
    ds = trainer.train_ds
    drawn = ds.item_meta
    monkeypatch.setattr(ds, "item_meta", lambda i: {
        **drawn(i), **({"prompt": LONG_PROMPT} if i % 2 == 0 else {})})
    tok = WordPieceTokenizer.from_vocab_file(vocab)
    sampler = trainer.batches(ds, shuffle=False)
    entries = list(trainer._rank_batches(sampler, ds))
    batches = [b for b, _ in trainer._sync_batches(
        entries, PromptTTSCollator(tokenizer=tok))]
    ref = JaxCollator(JaxTok.from_vocab_file(str(vocab)))
    n_long = 0
    assert len(batches) == len(list(sampler))
    for batch in batches:
        real = batch["batch_weight"] > 0
        items = [{**ds.load_item_features(drawn(0)), "prompt": p}
                 for p in batch["prompts"]]
        want = ref(items, prompt_pad_to=trainer.prompt_pad_to)
        for k in ("prompt_ids", "prompt_mask"):
            np.testing.assert_array_equal(batch[k][real], want[k][real],
                                          err_msg=k)
        lengths = batch["prompt_mask"].sum(1)
        long = np.array([p == LONG_PROMPT for p in batch["prompts"]]) & real
        n_long += int(long.sum())
        if world == 2:
            assert batch["prompt_ids"].shape[1] == 64
            assert (lengths[long] == 64).all()
            assert (batch["prompt_ids"][long, -1] != tok.sep_id).all()
        else:
            assert (lengths[long] == 82).all()
            assert not long.any() or batch["prompt_ids"].shape[1] >= 82
    assert n_long > 0


@pytest.mark.parametrize("override,bf16,pipeline", [
    ("train.bf16=true", True, None), ("train.fp16=true", True, None),
    ("+train.input_pipeline=prefetch", False, "prefetch"),
    ("+train.input_pipeline=sync_native", False, "sync_native"),
    ("+train.prefetch=false", False, "sync")])
def test_ported_settings_are_taken(corpus, tmp_path, override, bf16,
                                   pipeline):
    """The settings the port refused before bf16 training and the input
    pipelines came in."""
    cfg = conf.compose("train", train_args(corpus, tmp_path, override))
    trainer = TTSTrainer(cfg)
    assert (trainer.build_state().shadow is not None) == bf16
    if pipeline is not None:
        trainer._setup_logging()
        trainer._build_datasets()
        assert trainer.input_pipeline() == pipeline


def test_auto_input_pipeline(corpus, tmp_path, monkeypatch):
    """Unset, the pipeline is JAX's choice for the host: prefetch with 4
    cores or more; inline below, with the C++ loader where the dataset
    has file-backed items; the choice is logged. A mode that needs the
    loader raises, naming the way out, where the loader does not build."""
    from promptttspp_tpu_torch.data import native_loader
    from promptttspp_tpu_torch.train import trainer as tr

    cfg = conf.compose("train", train_args(corpus, tmp_path))
    trainer = TTSTrainer(cfg)
    trainer._setup_logging()
    trainer._build_datasets()
    monkeypatch.setattr(tr.os, "cpu_count", lambda: 8)
    assert trainer.input_pipeline() == "prefetch"
    monkeypatch.setattr(tr.os, "cpu_count", lambda: 2)
    assert trainer.input_pipeline() == "sync_native"
    assert tr.auto_input_pipeline([]) == "sync"  # no item_meta
    assert "input pipeline auto-selected: sync_native (2 host cores)" in \
        (tmp_path / "logs/train.log").read_text()

    def no_compiler():
        raise RuntimeError("c++ failed for featloader")

    monkeypatch.setattr(native_loader, "library", no_compiler)
    for cores in (2, 8):
        monkeypatch.setattr(tr.os, "cpu_count", lambda: cores)
        with pytest.raises(RuntimeError,
                           match=r"train\.input_pipeline=sync "):
            trainer.input_pipeline()


def _weights(trainer):
    return trainer.state.model.state_dict()


def test_input_pipelines_train_alike(corpus, tmp_path):
    """One epoch through each input pipeline: the same batches, so the
    same loss rows and weights, bit for bit."""
    runs = {p: run_trainer(corpus, tmp_path / p, "train.num_epochs=1",
                           f"+train.input_pipeline={p}")
            for p in ("sync", "prefetch", "sync_native")}
    want = runs.pop("sync")
    rows = (tmp_path / "sync/logs/loss.csv").read_text()
    for p, got in runs.items():
        assert got.state.step == want.state.step > 2
        assert (tmp_path / p / "logs/loss.csv").read_text() == rows, p
        for k, v in _weights(want).items():
            assert torch.equal(_weights(got)[k], v), (p, k)


def test_energy_branch_trains_through_the_trainer(corpus, tmp_path):
    """The tiny model switched as ``chip_smoke.py::variant_config`` (every
    switch at JAX's default and the energy branch) trains an epoch through
    the prefetching pipeline (its validation through the inline one): the
    energy target reaches the model (``model_batch_keys``), and the
    epoch's loss row has a finite, positive ``energy`` next to the other
    losses; the flagship's device batches carry no energy."""
    from chip_smoke import variant_config
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.train.trainer import (
        MODEL_BATCH_KEYS, model_batch_keys)

    out = tmp_path / "out"
    cfg = conf.compose("train", train_args(
        corpus, out, "train.num_epochs=1", "+train.input_pipeline=prefetch",
        "+train.tensorboard=false"))
    cfg["model"] = variant_config(cfg["model"])
    trainer = TTSTrainer(cfg, tokenizer=WordPieceTokenizer.from_vocab_file(
        cfg["path"]["bert_vocab_file"]))
    trainer.run()
    assert trainer.model_keys == model_batch_keys(trainer.state.model) \
        == MODEL_BATCH_KEYS + ("energy",)
    row = _rows(out / "logs/loss.csv")[-1]
    assert {"loss", "dec", "dur", "cf0", "vuv", "style", "energy"} <= set(row)
    assert 0 < row["energy"] < float("inf") and row["loss"] > row["energy"]
    flagship_model = flagship.build_model(conf.compose("train", train_args(
        corpus, out))["model"], "cpu")
    assert model_batch_keys(flagship_model) == MODEL_BATCH_KEYS


def test_entry_point_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = conf.compose("train", [f"output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSTrainer(cfg)


def test_resume_equals_an_uninterrupted_run(corpus, tmp_path):
    """Two epochs in one run against one epoch, then a resume from its
    ``ckpt/last`` for the second: equal weights, BatchNorm statistics,
    update counts and loss rows. ``ckpt/last`` loads through the
    reference checkpoint loader."""
    whole = run_trainer(corpus, tmp_path / "a", "train.num_epochs=2")
    run_trainer(corpus, tmp_path / "b", "train.num_epochs=1")
    resumed = run_trainer(corpus, tmp_path / "b", "train.num_epochs=2",
                          f"ckpt_path={tmp_path / 'b/ckpt/last'}")
    assert resumed.state.step == whole.state.step > 2
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=0, msg=k)
    ra, rb = _rows(tmp_path / "a/logs/loss.csv"), _rows(
        tmp_path / "b/logs/loss.csv")
    assert len(ra) == len(rb) == 2
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        np.testing.assert_allclose(list(x.values()), list(y.values()),
                                   atol=1e-6)
    fresh = flagship.build_model(conf.compose(
        "train", TINY_CLI_MODEL)["model"], "cpu", seed=99)
    load_reference_state_dict(fresh, torch_state_dict(
        tmp_path / "a/ckpt/last", "model"))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, a[k], atol=0, rtol=0, msg=k)
    ckpt = torch.load(tmp_path / "a/ckpt/last", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (2, whole.state.step)
    assert set(ckpt) == {"epoch", "step", "model", "optimizer"}


class FailingDataset(AllWithSpkPromptNormDataset):
    """Raises on the ``fail_at``-th item read (``item_meta``, which every
    input pipeline calls)."""

    fail_at = 12

    def item_meta(self, idx):
        self.reads = getattr(self, "reads", 0) + 1
        if self.reads == self.fail_at:
            raise RuntimeError("disk gone")
        return super().item_meta(idx)


def test_a_crash_writes_an_emergency_checkpoint(corpus, tmp_path):
    cfg = conf.compose("train", train_args(corpus, tmp_path,
                                           "train.num_epochs=3"))
    ds = FailingDataset(**cfg["dataset"]["train"])
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer

    trainer = TTSTrainer(cfg, train_ds=ds,
                         tokenizer=WordPieceTokenizer.from_vocab_file(
                             cfg["path"]["bert_vocab_file"]))
    with pytest.raises(RuntimeError, match="disk gone"):
        trainer.run()
    ckpt = torch.load(tmp_path / "ckpt/crash", weights_only=True)
    assert ckpt["epoch"] == -1
    assert 0 < ckpt["step"] == trainer.state.step
    assert "training failed" in (tmp_path / "logs/train.log").read_text()


def test_warm_start_fixed_batches_and_profile(corpus, tmp_path):
    """``pretrained`` loads weights only (updates count from 0);
    ``dataset.dynamic_batch=false`` batches ``train.batch_size`` items;
    ``train.profile_steps`` writes a trace."""
    first = run_trainer(corpus, tmp_path / "a", "train.num_epochs=1")
    warm = run_trainer(
        corpus, tmp_path / "b", "train.num_epochs=1",
        f"pretrained={tmp_path / 'a/ckpt/last'}",
        "dataset.dynamic_batch=false", "train.batch_size=5",
        "+train.profile_steps=1")
    assert warm.state.step == 5  # 21 training items in batches of 5
    assert first.state.step != 5
    assert (tmp_path / "b/logs/profile/trace.json").stat().st_size > 0
    assert warm.profile is not None and warm.profile_wall_s > 0
    snapshot = yaml.safe_load((tmp_path / "b/config.yaml").read_text())
    assert snapshot["pretrained"] == str(tmp_path / "a/ckpt/last")
    assert json.loads((tmp_path / "b/config.yaml").read_text()) == snapshot


def test_train_cli_then_synthesize_serves_its_checkpoint(corpus, tmp_path):
    """``bin/train.py`` for 2 epochs (``device=cpu``): logs/loss.csv with 2
    rows, ``ckpt/last`` and ``ckpt/epoch-0002``; then ``bin/synthesize.py``
    serves that ``ckpt/last`` and writes finite wavs."""
    from scipy.io import wavfile

    out, cwd = tmp_path / "train", os.getcwd()
    try:
        trainer = train_cli.main(train_args(
            corpus, out, "train.num_epochs=2",
            f"hydra.run.dir={tmp_path / 'run'}"))
        assert Path.cwd() == tmp_path / "run"
    finally:
        os.chdir(cwd)
    assert trainer.state.step > 0
    rows = _rows(out / "logs/loss.csv")
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(np.isfinite(list(r.values())).all() for r in rows)
    assert {"loss", "dec", "dur", "cf0", "vuv", "style",
            "grad_norm"} <= rows[0].keys()
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "epoch-0002", "last"]
    log = (out / "logs/train.log").read_text()
    assert "epoch 2 valid:" in log and "frames/s=" in log

    wavs = tmp_path / "wavs"
    try:
        synth_cli.main([
            f"path.root={corpus}", f"model_ckpt={out / 'ckpt/last'}",
            f"vocoder_ckpt={corpus / 'vocoder.ckpt'}", f"output_dir={wavs}",
            f"hydra.run.dir={tmp_path / 'run'}", "num_eval_utts=1",
            "device=cpu", *TINY_CLI_MODEL, *TINY_CLI_VOCODER])
    finally:
        os.chdir(cwd)
    files = sorted(wavs.rglob("*.wav"))
    assert len(files) == 2 and (wavs / "finish").exists()
    for p in files:
        sr, data = wavfile.read(p)
        assert sr == 24000 and len(data) > 0
        assert np.isfinite(data.astype(np.float64)).all()


def test_bf16_epoch_serves_its_float32_checkpoint(corpus, tmp_path):
    """One bf16 epoch (prefetched) through ``bin/train.py``: finite losses,
    a ``ckpt/last`` of float32 weights that ``bin/synthesize.py`` serves."""
    from scipy.io import wavfile

    out, cwd = tmp_path / "train", os.getcwd()
    try:
        trainer = train_cli.main(train_args(
            corpus, out, "train.num_epochs=1", "train.bf16=true",
            "+train.input_pipeline=prefetch",
            f"hydra.run.dir={tmp_path / 'run'}"))
        synth_cli.main([
            f"path.root={corpus}", f"model_ckpt={out / 'ckpt/last'}",
            f"vocoder_ckpt={corpus / 'vocoder.ckpt'}",
            f"output_dir={tmp_path / 'wavs'}",
            f"hydra.run.dir={tmp_path / 'run'}", "num_eval_utts=1",
            "device=cpu", *TINY_CLI_MODEL, *TINY_CLI_VOCODER])
    finally:
        os.chdir(cwd)
    assert trainer.state.shadow is not None and trainer.state.step > 2
    (row,) = _rows(out / "logs/loss.csv")
    assert np.isfinite(list(row.values())).all()
    model = torch.load(out / "ckpt/last", weights_only=True)["model"]
    assert {v.dtype for v in model.values() if v.is_floating_point()} == {
        torch.float32}
    files = sorted((tmp_path / "wavs").rglob("*.wav"))
    assert len(files) == 2
    for p in files:
        data = wavfile.read(p)[1]
        assert len(data) and np.isfinite(data.astype(np.float64)).all()


def test_train_cli_needs_the_vocabulary(corpus, tmp_path):
    cwd = os.getcwd()
    try:
        with pytest.raises(FileNotFoundError, match="bert_vocab_file"):
            train_cli.main(train_args(
                corpus, tmp_path, "path.bert_vocab_file=/nonexistent",
                f"hydra.run.dir={tmp_path}"))
    finally:
        os.chdir(cwd)
