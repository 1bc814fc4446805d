"""The port's preprocessing against the JAX package on the CPU: the
TextGrid parser and durations, the YAML reader and writer, the
``preprocess`` config, and ``preprocess_corpus``, ``split_train_valid`` and
``filter_eval`` on a small raw corpus (``tools/synthetic_corpus.py``)
whose speaker ids sort differently as strings and as integers."""

from pathlib import Path

import numpy as np
import pytest
import yaml

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.data.dataset import read_prompt_candidate
from promptttspp_tpu_torch.preprocess import duration, pipeline, textgrid
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    raw_rows, write_raw_corpus)

REPO = Path(__file__).resolve().parent.parent
F0_STATS = REPO / "metadata/libritts_r_f0_stats.yaml"
# speaker 121 is an eval id of conf/preprocess.yaml; as strings the others
# sort 100, 1001, 19, as integers 19, 100, 1001
SPEAKERS = {121: 2, 19: 2, 100: 3, 1001: 2}
CSVS = ["df/data.csv", "df/train.csv", "df/eval.csv", "df_filtered/trn.csv",
        "df_filtered/val.csv", "df_filtered/eval_filtered.csv"]
MEL_ATOL = 1e-4  # float32 STFTs of another FFT
STATS_RTOL = 1e-5  # float32 sums of those mels
# cf0/vuv: the F0 bar of tests/test_torch_f0.py
VUV_AGREEMENT, F0_RTOL = 0.995, 1e-3


def small_prompts(n_keys=6, per_key=2):
    cands = read_prompt_candidate(
        REPO / "metadata/style_prompt_candidates.csv")
    return {k: cands[k][:per_key] for k in sorted(cands)[:n_keys]}


def make_raw_corpus(root, speakers=SPEAKERS, seconds=(1.5, 3.0), seed=0):
    prompts = small_prompts()
    rows = raw_rows(speakers, prompts, seconds=seconds,
                    f0_stats=yaml_lite.load(F0_STATS), seed=seed)
    spk_words = {s: ["calm", "deep", "clear"] for s in speakers}
    return write_raw_corpus(root, rows, prompts, spk_words,
                            f0_stats_file=F0_STATS, vocab_size=600,
                            seed=seed)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The raw corpus, preprocessed, split and filtered by JAX and by the
    port into ``dump_jax`` and ``dump_port``."""
    from promptttspp_tpu.preprocess import pipeline as jax_pipeline

    root = make_raw_corpus(tmp_path_factory.mktemp("raw"))
    stats = yaml_lite.load(F0_STATS)
    data_root = root / "data_prep/out/libritts_r_per_spk_cleaned"
    for name, mod, kw in (("jax", jax_pipeline, {}),
                          ("port", pipeline, dict(device="cpu"))):
        d = root / f"dump_{name}"
        mod.preprocess_corpus(
            root / "metadata/metadata_w_style_prompt_tags.csv", data_root,
            d / "feats", d / "mel63", d / "df", f0_stats=stats,
            eval_ids=[121], batch_size=4, **kw)
        mod.split_train_valid(d / "df", d / "df_filtered", valid_frac=0.4)
        mod.filter_eval(d / "df", d / "df_filtered", min_sec=1.0,
                        max_sec=2.5)
    return root


@pytest.mark.parametrize("name", CSVS)
def test_csvs_equal_jax_cell_for_cell(corpus, name):
    ours = (corpus / "dump_port" / name).read_text()
    assert ours == (corpus / "dump_jax" / name).read_text()
    assert len(ours.splitlines()) >= 2 or name == "df_filtered/val.csv"


def test_split_orders_speakers_as_integers(corpus, monkeypatch):
    """The split draws one permutation per speaker in integer order, as
    pandas' groupby does; in string order this corpus splits otherwise."""
    out = corpus / "split_by_string"
    monkeypatch.setattr(pipeline, "_speaker_key", str)
    pipeline.split_train_valid(corpus / "dump_port/df", out, valid_frac=0.4)
    ref = (corpus / "dump_jax/df_filtered/val.csv").read_text()
    assert (out / "val.csv").read_text() != ref


def test_features_equal_jax(corpus):
    jax_dir, port_dir = corpus / "dump_jax", corpus / "dump_port"
    mels = sorted((jax_dir / "mel63").rglob("*.npy"))
    assert len(mels) == sum(SPEAKERS.values())
    for p in mels:
        q = port_dir / p.relative_to(jax_dir)
        a, b = np.load(p), np.load(q)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=MEL_ATOL, rtol=0)
    vuv_same = vuv_all = 0
    for p in sorted((jax_dir / "feats").rglob("vuv/*.npy")):
        q = port_dir / p.relative_to(jax_dir)
        a, b = np.load(p), np.load(q)
        assert a.shape == b.shape and a.shape[0] == 1
        vuv_same += int((a == b).sum())
        vuv_all += a.size
        cf0_p = Path(str(p).replace("/vuv/", "/cf0/"))
        ca = np.load(cf0_p)
        cb = np.load(port_dir / cf0_p.relative_to(jax_dir))
        both = (a > 0) & (b > 0)
        np.testing.assert_allclose(np.exp(cb[both]), np.exp(ca[both]),
                                   rtol=F0_RTOL)
    assert vuv_same / vuv_all >= VUV_AGREEMENT


def test_mel_stats_equal_jax(corpus):
    ref = yaml.safe_load((corpus / "dump_jax/mel63/stats.yaml").read_text())
    ours = yaml.safe_load((corpus / "dump_port/mel63/stats.yaml").read_text())
    assert sorted(ours) == sorted(ref) == ["max", "mean", "min", "std", "var"]
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=STATS_RTOL)
    for d in ("mel63", "df"):
        assert (corpus / "dump_port" / d / "finish").exists()


def test_preprocess_again_is_a_no_op(corpus, capsys):
    before = (corpus / "dump_port/df/data.csv").stat().st_mtime_ns
    d = corpus / "dump_port"
    pipeline.preprocess_corpus(
        corpus / "metadata/metadata_w_style_prompt_tags.csv", corpus,
        d / "feats", d / "mel63", d / "df", device="cpu")
    assert "already finished" in capsys.readouterr().out
    assert (d / "df/data.csv").stat().st_mtime_ns == before


def test_textgrid_and_durations_equal_jax(corpus):
    from promptttspp_tpu.preprocess import duration as jax_duration
    from promptttspp_tpu.preprocess import textgrid as jax_textgrid

    grids = sorted(corpus.rglob("*.TextGrid"))
    assert len(grids) == sum(SPEAKERS.values())
    for p in grids:
        for tier in ("phones", "words"):
            ours = textgrid.read_textgrid(str(p), tier)
            assert [tuple(e) for e in ours] == [
                tuple(e) for e in jax_textgrid.read_textgrid(str(p), tier)]
        wav = np.zeros(int(24000 * ours[-1].stop))
        seq, dur = duration.process_textgrid("1", p.stem, wav, p)
        jseq, jdur = jax_duration.process_textgrid("1", p.stem, wav, p)
        assert seq == jseq
        np.testing.assert_array_equal(dur, jdur)
    E = textgrid.Entry
    labels = [E(0.0, 0.3, "HH", "phones"), E(0.3, 0.6, "AH0", "phones")]
    assert duration.adjust_textgrid(labels) == [
        tuple(e) for e in jax_duration.adjust_textgrid(
            [jax_textgrid.Entry(*e) for e in labels])]
    short = [E(0.0, 0.001, "HH", "phones"), E(0.001, 0.5, "AH0", "phones")]
    for mod in (duration, jax_duration):
        with pytest.raises(RuntimeError, match="Too short"):
            mod.textgrid_to_phone_durations(short)


def test_yaml_reader_equals_safe_load():
    ours = yaml_lite.load(F0_STATS)
    ref = yaml.safe_load(F0_STATS.read_text())
    assert ours == ref
    assert all(type(ours[s][k]) is type(ref[s][k]) for s in ref
               for k in ref[s])


def test_yaml_writer_equals_safe_dump(tmp_path):
    stats = dict(min=-11.512925148010254, max=2.25, mean=-5.430971145629883,
                 std=1e-05, var=float("inf"))
    yaml_lite.dump_flat(tmp_path / "stats.yaml", stats)
    text = (tmp_path / "stats.yaml").read_text()
    assert text == yaml.safe_dump(stats)
    assert yaml.safe_load(text) == stats == yaml_lite.loads(text)


@pytest.mark.parametrize("text", [
    "a: b\n", "a: 1e5\n", "- 1\n", "a:\n  b:\n    c: 1\n", "a: [1, 2]\n",
    "a: 1\na: 2\n", "  a: 1\n"])
def test_yaml_reader_refuses_other_shapes(text):
    with pytest.raises(ValueError):
        yaml_lite.loads(text)


@pytest.mark.parametrize("overrides", [
    [], ["path.root=/data/corpus", "eval_ids=[22]", "batch_size=4",
         "f0_method=world", "min_sec=0.5", "hydra.run.dir=/tmp/run"]],
    ids=["defaults", "recipe"])
def test_preprocess_config_matches_compose(overrides):
    """``bin/conf.py``'s ``preprocess`` config equals JAX's ``compose`` of
    ``conf/preprocess.yaml`` and the same overrides (interpolations
    resolved), but for the port's ``device`` key and the hydra node, of
    which only ``run.dir`` is used."""
    from promptttspp_tpu.config import compose
    from tests.test_torch_cli import _strip

    ours = conf.compose("preprocess", overrides)
    ref = _strip(compose(REPO / "conf", "preprocess", overrides=overrides,
                         drop_hydra_node=False).to_dict())
    assert ours.pop("device") == "cuda"
    assert ours.pop("hydra") == {"run": {"dir": ref.pop("hydra")["run"][
        "dir"]}}
    assert ours == ref


def test_world_method_equals_jax(tmp_path):
    """``BatchedFeatureExtractor(f0_method="world")``, host DIO +
    StoneMask, equals JAX's; the mel as above."""
    from promptttspp_tpu.preprocess.pipeline import (
        BatchedFeatureExtractor as JaxExtractor)
    from promptttspp_tpu_torch.tools.synthetic_corpus import speech_like

    wavs = [speech_like(0.8, 150.0, seed=1).astype(np.float32)]
    ours = pipeline.BatchedFeatureExtractor(f0_method="world", device="cpu",
                                            sample_quantum=24000)(
        wavs, 70.0, 400.0)
    ref = JaxExtractor(f0_method="world", sample_quantum=24000)(
        wavs, 70.0, 400.0)
    for k in ("f0", "cf0", "vuv"):
        np.testing.assert_array_equal(ours[0][k], np.asarray(ref[0][k]))
    np.testing.assert_allclose(ours[0]["mel"], np.asarray(ref[0]["mel"]),
                               atol=MEL_ATOL, rtol=0)
    with pytest.raises(ValueError, match="yin or world"):
        pipeline.BatchedFeatureExtractor(f0_method="dio", device="cpu")
