"""The port's training data path on the CPU against the JAX package's:
``batch_by_size``, ``ShuffleBatchSampler``, the prompt strings, the items
of ``AllWithSpkPromptNormDataset`` on a synthetic corpus
(``tools/synthetic_corpus.py::write_training_corpus``), the collated
arrays, and the ``train`` config against JAX's ``compose``."""

import random
from pathlib import Path

import numpy as np
import pytest

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.data import batching, dataset, prompts
from promptttspp_tpu_torch.data.collate import PromptTTSCollator
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    training_rows, write_training_corpus)

REPO = Path(__file__).resolve().parent.parent
META = REPO / "metadata"


def candidates(n_keys=None, n_spk=6):
    """The repository's style and speaker prompt candidates (the first
    ``n_spk`` speakers)."""
    p = dataset.read_prompt_candidate(META / "style_prompt_candidates.csv")
    s = dataset.read_spk_prompt_candidate(
        META / "speaker_prompt_candidates.csv")
    keys = sorted(p)[:n_keys]
    return {k: p[k] for k in keys}, {k: s[k] for k in sorted(s)[:n_spk]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_corpus")
    cands, spk = candidates()
    rows = training_rows(30, cands, spk, phones=(4, 12),
                         frames_per_phone=(1, 5), seed=3)
    write_training_corpus(root, rows, cands, spk, vocab_size=4000,
                          n_mels=20, seed=4)
    # the first row's durations overrun its mel by one frame, the
    # off-by-one of the duration extraction that both datasets repair
    csv = root / "dump/libritts_r_per_spk_cleaned/df_filtered/trn.csv"
    header, first, *rest = csv.read_text().splitlines()
    head, _, durs = first.rpartition(",")
    durs = durs.split()
    durs[-1] = str(int(durs[-1]) + 1)
    csv.write_text("\n".join([header, f"{head},{' '.join(durs)}", *rest])
                   + "\n")
    return root


def _paths(root, split="trn"):
    d = root / "dump/libritts_r_per_spk_cleaned"
    return dict(file_path=d / f"df_filtered/{split}.csv",
                data_root=root / "data_prep", feats_dir=d / "feats",
                mel_dir=d / "mel63",
                prompt_candidate_file=root / "metadata/"
                "style_prompt_candidates.csv",
                spk_prompt_candidate_file=root / "metadata/"
                "speaker_prompt_candidates.csv")


@pytest.mark.parametrize("max_tokens,max_sentences,mult", [
    (60, None, 1), (200, None, 4), (1000, 7, 2), (None, 5, 1)])
def test_batch_by_size_matches_jax(max_tokens, max_sentences, mult):
    from promptttspp_tpu.data.batching import batch_by_size as jax_bbs

    lens = np.random.RandomState(0).randint(5, 60, 300)
    idx = np.argsort(lens, kind="mergesort")
    kw = dict(max_tokens=max_tokens, max_sentences=max_sentences,
              required_batch_size_multiple=mult)
    fn = lambda i: int(lens[i])  # noqa: E731
    assert batching.batch_by_size(idx, fn, **kw) == jax_bbs(idx, fn, **kw)
    with pytest.raises(ValueError, match="exceeds max_tokens"):
        batching.batch_by_size(idx, fn, max_tokens=30)


def test_shuffle_batch_sampler_matches_jax():
    from promptttspp_tpu.data.batching import ShuffleBatchSampler as Jax

    batches = [[i, i + 1] for i in range(0, 40, 2)]
    for shuffle in (True, False):
        ours = batching.ShuffleBatchSampler(batches, shuffle, seed=7)
        ref = Jax(batches, shuffle, seed=7)
        for epoch in (1, 2, 5):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)
        assert len(ours) == len(ref)
    from promptttspp_tpu.data.batching import round_up
    assert all(batching.round_up(n, q) == round_up(n, q)
               for n in range(40) for q in (1, 16, 64))


def test_build_prompt_matches_jax():
    """500 prompts drawn with the same random.Random seed, speaker prompts
    and "very" augmentation included, are JAX's strings."""
    from promptttspp_tpu.data.prompts import build_prompt as jax_build

    cands, spk = candidates(n_spk=400)
    keys = sorted(cands)
    ours_rng, ref_rng = random.Random(11), random.Random(11)
    tags = ["very high", "high", "normal", "low", "very low"]
    pick = np.random.RandomState(0)
    for _ in range(500):
        args = (keys[pick.randint(len(keys))],
                sorted(spk)[pick.randint(len(spk))] if pick.rand() < 0.9
                else 123456, *(tags[pick.randint(5)] for _ in range(3)),
                cands, spk)
        kw = dict(use_spk_prompt=bool(pick.rand() < 0.8), p_augment=0.5)
        assert prompts.build_prompt(*args, ours_rng, **kw) == \
            jax_build(*args, ref_rng, **kw)


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def test_dataset_items_match_jax(corpus):
    from promptttspp_tpu.data.dataset import (
        AllWithSpkPromptNormDataset as JaxDataset)

    for split in ("trn", "val"):
        ours = dataset.AllWithSpkPromptNormDataset(**_paths(corpus, split),
                                                   p_augment=0.5, seed=5)
        ref = JaxDataset(**_paths(corpus, split), p_augment=0.5, seed=5)
        assert len(ours) == len(ref) > 0
        assert [ours.num_tokens(i) for i in range(len(ours))] == \
            [ref.num_tokens(i) for i in range(len(ref))]
        np.testing.assert_array_equal(ours.ordered_indices(),
                                      ref.ordered_indices())
        for i in list(range(len(ours))) * 2:
            _assert_items_equal(ours[i], ref[i])
    # the repaired off-by-one: durations sum to the mel's frames
    ds = dataset.AllWithSpkPromptNormDataset(**_paths(corpus), seed=5)
    item = ds[0]
    assert item["duration"].sum() == item["mel"].shape[0] == \
        ds.num_tokens(0) - 1


def test_dataset_set_epoch_reseeds_the_prompts(corpus):
    ds = dataset.AllWithSpkPromptNormDataset(**_paths(corpus), seed=5)
    draws = []
    for epoch in (1, 2, 1):
        ds.set_epoch(epoch)
        draws.append([ds[i]["prompt"] for i in range(len(ds))])
    assert draws[0] == draws[2] != draws[1]


def test_collated_batches_match_jax(corpus):
    from promptttspp_tpu.data.collate import PromptTTSCollator as JaxCollator
    from promptttspp_tpu.models.bert import WordPieceTokenizer as JaxTok

    vocab = corpus / "metadata/bert-base-uncased-vocab.txt"
    ds = dataset.AllWithSpkPromptNormDataset(**_paths(corpus), seed=5)
    ours = PromptTTSCollator(WordPieceTokenizer.from_vocab_file(vocab))
    ref = JaxCollator(JaxTok.from_vocab_file(str(vocab)))
    batches = batching.batch_by_size(ds.ordered_indices(), ds.num_tokens,
                                     max_tokens=150)
    assert len(batches) > 2
    for idx in batches:
        items = [ds[i] for i in idx]
        a, b = ours(items), ref(items)
        np.testing.assert_array_equal(a.pop("batch_weight"),
                                      np.ones(len(idx), np.float32))
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _strip(node):
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items() if k != "_target_"}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


@pytest.mark.parametrize("overrides", [
    [],
    ["path.root=/data/corpus", "train.num_epochs=2", "dataset.max_tokens=2000",
     "train.lr_scheduler.warmup_steps=10", "optimizer.lr=2e-4",
     "output_dir=/tmp/o", "ckpt_path=/tmp/o/ckpt/last",
     "+train.profile_steps=5", "dataset.dynamic_batch=false"],
    ["model=prompttts_mdn_v2_wo_erg_final_demo", "train.seed=3",
     "+model.prompt_encoder.bert_num_layers=1"]],
    ids=["defaults", "training", "demo_model"])
def test_train_config_matches_compose(overrides):
    """``bin/conf.compose("train", ...)`` equals JAX's ``compose`` of
    conf/train.yaml with the same overrides, but for the port's ``device``
    key, the ``_target_`` keys and the hydra node, of which only
    ``run.dir`` is used."""
    from promptttspp_tpu.config import compose

    ours = conf.compose("train", overrides)
    ref = _strip(compose(REPO / "conf", "train", overrides=overrides,
                         drop_hydra_node=False).to_dict())
    assert ours.pop("device") == "cuda"
    assert ours.pop("hydra") == {"run": {"dir": ref.pop("hydra")["run"][
        "dir"]}}
    assert ours == ref
