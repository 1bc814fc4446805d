"""The port's C++ feature loader (``csrc/featloader.cpp`` through
``data/native_loader.py``) and its prefetching pipeline
(``data/prefetch.py``) on the CPU, against the JAX package's
``native_loader`` and ``prefetch`` and against the port's own inline
assembly."""

import sys
import threading
import time

import numpy as np
import pytest

from promptttspp_tpu_torch.data import native_loader
from promptttspp_tpu_torch.data.collate import PromptTTSCollator
from promptttspp_tpu_torch.data.dataset import AllWithSpkPromptNormDataset
from promptttspp_tpu_torch.data.prefetch import (
    _collate_native, prefetch_batches)
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    training_rows, write_training_corpus)
from promptttspp_tpu_torch.train.trainer import MODEL_BATCH_KEYS, to_device
from tests.test_torch_train_data import _paths, candidates

ARRAY_KEYS = ("phoneme", "duration", "phone_lengths", "mel", "log_cf0",
              "vuv", "frame_lengths", "batch_weight", "prompt_ids",
              "prompt_mask")
BATCHES = [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9]]


@pytest.fixture(scope="module")
def jax_loader():
    """The JAX package's loader, built by its own script if it is not."""
    import subprocess
    from pathlib import Path

    from promptttspp_tpu.data import native_loader as jax_native

    if not jax_native.available():
        repo = Path(__file__).resolve().parent.parent
        subprocess.run(["bash", str(repo / "native" / "build.sh")],
                       check=True)
    assert jax_native.available()
    return jax_native


def _files(tmp_path, T_list, dtype=np.float32, fortran=False, seed=0):
    rng = np.random.RandomState(seed)
    paths = {"mel": [], "cf0": [], "vuv": []}
    for i, T in enumerate(T_list):
        mel = (rng.randn(80, T) - 4.0).astype(dtype)
        if fortran:
            mel = np.asfortranarray(mel)
        arrays = dict(mel=mel, cf0=(rng.rand(1, T) * 5).astype(dtype),
                      vuv=(rng.rand(1, T) > 0.4).astype(dtype))
        for k, a in arrays.items():
            p = tmp_path / f"{k}{i}_{np.dtype(dtype).name}_{fortran}.npy"
            np.save(p, a)
            paths[k].append(str(p))
    return paths


@pytest.mark.parametrize("dtype,fortran", [(np.float32, False),
                                           (np.float64, False),
                                           (np.float32, True)],
                         ids=["f4", "f8", "fortran"])
def test_loader_matches_jax_loader(jax_loader, tmp_path, dtype, fortran):
    """The same files through both loaders, at test_native_loader.py's
    tolerances; and the port's against numpy's normalization bit for bit
    (float32 files)."""
    paths = _files(tmp_path, [37, 80, 41], dtype, fortran)
    args = (paths["mel"], paths["cf0"], paths["vuv"], 96)
    kw = dict(mel_mean=-4.2, mel_std=2.3)
    got = native_loader.load_feature_batch(*args, **kw)
    want = jax_loader.load_feature_batch(*args, **kw)
    for k in ("log_cf0", "vuv", "frame_lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["mel"], want["mel"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-4)
    if dtype == np.float32:
        for i, p in enumerate(paths["mel"]):
            mel = np.load(p)
            T = mel.shape[1]
            np.testing.assert_array_equal(
                got["mel"][i, :T], ((mel - kw["mel_mean"]) / kw["mel_std"]).T)
            assert not got["mel"][i, T:].any()


def test_loader_fills_caller_buffers_and_reports_errors(tmp_path):
    paths = _files(tmp_path, [20, 33])
    out = {"mel": np.full((2, 64, 80), np.nan, np.float32),
           "vuv": np.full((2, 64, 1), np.nan, np.float32)}
    got = native_loader.load_feature_batch(
        paths["mel"], paths["cf0"], paths["vuv"], 64, 0.0, 1.0, out=out)
    assert got["mel"] is out["mel"] and got["vuv"] is out["vuv"]
    assert np.isfinite(out["mel"]).all() and not out["mel"][0, 20:].any()
    with pytest.raises(ValueError, match=r"out\['mel'\]"):
        native_loader.load_feature_batch(
            paths["mel"], paths["cf0"], paths["vuv"], 32, 0.0, 1.0,
            out={"mel": np.zeros((2, 64, 80), np.float32)})
    with pytest.raises(RuntimeError, match="item 1: cannot open"):
        native_loader.load_feature_batch(
            [paths["mel"][0], str(tmp_path / "missing.npy")],
            paths["cf0"], paths["vuv"], 64, 0.0, 1.0)
    np.save(tmp_path / "ints.npy", np.zeros((80, 5), np.int32))
    with pytest.raises(RuntimeError, match="dtype must be <f4 or <f8"):
        native_loader.load_feature_batch(
            [str(tmp_path / "ints.npy")], paths["cf0"][:1],
            paths["vuv"][:1], 64, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="mel shape mismatch"):
        native_loader.load_feature_batch(
            paths["mel"], paths["cf0"], paths["vuv"], 64, 0.0, 1.0,
            n_mels=20)


def test_library_is_built_once_per_source_and_flags(monkeypatch):
    """The library sits under build/torch_kernels/ by the hash of its
    flags and source; a second load builds nothing; a failed build raises
    with the compiler's output."""
    path = _build.library_path("featloader")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("featloader-") and path.suffix == ".so"
    native_loader.library()
    assert path.exists()
    mtime = path.stat().st_mtime_ns
    assert _build.build(["featloader"]) == {}
    assert path.stat().st_mtime_ns == mtime
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-DX",))
    assert _build.library_path("featloader") != path
    monkeypatch.setattr(_build, "HOST_FLAGS", ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="failed for featloader"):
        _build.build(["featloader"])


# ------------------------------------------------------------- batches


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_corpus")
    cands, spk = candidates(n_keys=8)
    rows = training_rows(10, cands, spk, phones=(4, 12),
                         frames_per_phone=(1, 5), valid_every=100, seed=2)
    write_training_corpus(root, rows, cands, spk, vocab_size=4000,
                          n_mels=20, seed=3)
    return root


def make_ds(root, seed=7):
    return AllWithSpkPromptNormDataset(**_paths(root), seed=seed)


@pytest.fixture(scope="module")
def collator(corpus):
    return PromptTTSCollator(WordPieceTokenizer.from_vocab_file(
        corpus / "metadata/bert-base-uncased-vocab.txt"))


@pytest.fixture(scope="module")
def sync_batches(corpus, collator):
    ds = make_ds(corpus)
    return [collator([ds[i] for i in idx]) for idx in BATCHES]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["prompts"] == w["prompts"] and g["utt_ids"] == w["utt_ids"]
        for k in ARRAY_KEYS:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_item_split_is_the_item(corpus):
    a, b = make_ds(corpus), make_ds(corpus)
    for i in range(len(a)):
        want, got = a[i], b.load_item_features(b.item_meta(i))
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_collate_native_matches_collator_and_jax(corpus, collator,
                                                 sync_batches, jax_loader):
    """The port's native assembly equals its collator's batches bit for
    bit, and JAX's ``_collate_native`` on the same metadata."""
    from promptttspp_tpu.data.collate import PromptTTSCollator as JaxCollator
    from promptttspp_tpu.data.prefetch import _collate_native as jax_native

    ds = make_ds(corpus)
    got = [_collate_native([ds.item_meta(i) for i in idx], collator,
                           ds.stats) for idx in BATCHES]
    assert_batches_equal(got, sync_batches)
    ds = make_ds(corpus)
    jcoll = JaxCollator(tokenizer=collator.tokenizer, mel_dim=20)
    for g, idx in zip(got, BATCHES):
        w = jax_native([ds.item_meta(i) for i in idx], jcoll, ds.stats)
        for k in set(ARRAY_KEYS) - {"batch_weight", "mel"}:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["mel"], w["mel"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["energy"], w["energy"], rtol=1e-4)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_prefetch_equals_sync_and_jax(corpus, collator, sync_batches,
                                      jax_loader, native):
    """prefetch_batches in order, bit for bit the inline batches, their
    device tensors ``to_device``'s; and JAX's prefetch host batches."""
    from promptttspp_tpu.data.collate import PromptTTSCollator as JaxCollator
    from promptttspp_tpu.data.dataset import (
        AllWithSpkPromptNormDataset as JaxDataset)
    from promptttspp_tpu.data.prefetch import (
        prefetch_batches as jax_prefetch)

    out = list(prefetch_batches(
        make_ds(corpus), BATCHES, collator, model_keys=MODEL_BATCH_KEYS,
        num_workers=3, prefetch_depth=2, use_native=native))
    assert_batches_equal([b for b, _ in out], sync_batches)
    for (batch, dev), want in zip(out, sync_batches):
        ref = to_device(want, "cpu")
        assert dev.keys() == ref.keys()
        for k, t in dev.items():
            assert t.dtype == ref[k].dtype and t.equal(ref[k]), k
    jax_out = [b for b, _ in jax_prefetch(
        JaxDataset(**_paths(corpus), seed=7), BATCHES,
        JaxCollator(tokenizer=collator.tokenizer, mel_dim=20),
        num_workers=3, prefetch_depth=2, use_native=native)]
    for g, w in zip(sync_batches, jax_out):
        assert g["prompts"] == w["prompts"]
        for k in set(ARRAY_KEYS) - {"batch_weight"}:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_prefetch_in_order_under_thread_switching(corpus, collator,
                                                  sync_batches):
    """More workers than cores and a switch interval of 1 us: the batches
    still come out whole and in sampler order."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [b for b, _ in prefetch_batches(
            make_ds(corpus), BATCHES * 3, collator,
            model_keys=MODEL_BATCH_KEYS, num_workers=16, prefetch_depth=4)]
    finally:
        sys.setswitchinterval(interval)
    ds = make_ds(corpus)
    assert_batches_equal(got, [collator([ds[i] for i in idx])
                               for idx in BATCHES * 3])


class Exploding(AllWithSpkPromptNormDataset):
    def load_item_features(self, meta):
        if meta["utt_id"] == self.bad:
            raise ValueError("boom")
        return super().load_item_features(meta)


def _threads():
    return set(threading.enumerate())


def test_prefetch_raises_a_worker_error_and_stops(corpus, collator):
    ds = Exploding(**_paths(corpus), seed=7)
    ds.bad = ds.data[BATCHES[2][1]][1]
    got, before = [], _threads()
    with pytest.raises(ValueError, match="boom"):
        for b, _ in prefetch_batches(ds, BATCHES, collator,
                                     model_keys=MODEL_BATCH_KEYS,
                                     num_workers=2, use_native=False):
            got.append(b)
    assert len(got) == 2  # the batches before it, in order
    assert not _threads() - before


def test_abandoned_prefetch_joins_its_threads(corpus, collator):
    """An iterator closed after one batch of many stops its producer and
    shuts down its pool; none of their threads outlives the close."""
    before = _threads()
    it = prefetch_batches(make_ds(corpus), BATCHES * 20, collator,
                          model_keys=MODEL_BATCH_KEYS, num_workers=3,
                          prefetch_depth=2)
    next(it)
    started = _threads() - before
    assert {t.name for t in started} >= {"prefetch-producer"}
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 10
    assert not any(t.is_alive() for t in started)
