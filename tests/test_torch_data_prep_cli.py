"""The port's data-prep command lines (``data_prep/``) against the root
scripts that drive the JAX package, on the same LibriTTS-R-shaped tree:
2 speakers x 3 transcribed utterances (and one wav without a transcript),
a ``speakers.tsv``, and a stand-in for the Montreal Forced Aligner's
TextGrids (one utterance left unaligned). Each stage's output tree, YAML
and CSV are compared with the root script's; the two runall scripts run
the whole chain with a stand-in ``mfa`` on the PATH. Every run is in a
``tmp_path`` working directory, where the scripts write ``log/``.
"""

import csv
import os
import runpy
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.data_prep import (
    add_style_prompt_tags, compute_utt_stats, finalize_mfa, prepare_mfa,
    run_mfa)
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    raw_textgrid, speech_like)

REPO = Path(__file__).resolve().parent.parent
ROOT_SCRIPTS = REPO / "data_prep"
PORT_SCRIPTS = REPO / "promptttspp_tpu_torch" / "data_prep"
SPEAKERS = {"1034": ("M", 110.0), "1040": ("F", 210.0)}
SUBSET = "train-clean-100"
# compute_utt_stats rounds to 2 decimals; YIN on each side may move a
# value by one rounding step (tests/test_torch_eval.py)
ROUNDING = 0.0101


def _utt(spk, u):
    return f"{spk}_{200 + u}_{u:06d}_000000"


def write_tree(root: Path):
    """The raw corpus, ``speakers.tsv``, a stand-in MFA output and an F0
    statistics YAML under ``root``."""
    rng = np.random.RandomState(0)
    (root / "speakers.tsv").write_text(
        "READER\tGENDER\tSUBSET\tNAME\n" + "".join(
            f"{spk}\t{g}\t{SUBSET}\tReader {spk}\n"
            for spk, (g, _) in SPEAKERS.items()) + "77\tF\n")
    seconds = {}
    for i, (spk, (_, f0)) in enumerate(SPEAKERS.items()):
        for u in range(4):
            utt = _utt(spk, u)
            d = root / "LibriTTS_R" / SUBSET / spk / utt.split("_")[1]
            d.mkdir(parents=True, exist_ok=True)
            wav = speech_like(float(rng.uniform(1.2, 1.8)), f0, 10 * i + u)
            wavfile.write(d / f"{utt}.wav", 24000,
                          np.round(wav * 32767).astype(np.int16))
            seconds[utt] = len(wav) / 24000
            if u == 3:
                continue  # a wav without a transcript
            text = "- a false start" if (i, u) == (1, 2) else \
                f"hello, \"world\" number {u}"
            (d / f"{utt}.normalized.txt").write_text(text + "\n")
            if (i, u) != (0, 1):  # left unaligned
                tg = root / "mfa_fake" / spk / f"{utt}.TextGrid"
                tg.parent.mkdir(parents=True, exist_ok=True)
                tg.write_text(raw_textgrid(seconds[utt], rng))
    yaml_lite.dump(root / "f0_stats.yaml", {
        spk: {"f0_floor": 0.5 * f0, "f0_ceil": 2.5 * f0}
        for spk, (_, f0) in SPEAKERS.items()})
    (root / "failed").mkdir()
    (root / "failed" / "x_list.txt").write_text(
        f"some/dir/{_utt('1034', 2)}.wav\n\n")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("libritts"))


def run_root(script, *args):
    """A root script of ``data_prep/`` in this process, as ``python
    data_prep/<script> args`` runs it."""
    argv, path = sys.argv, list(sys.path)
    sys.argv = [str(ROOT_SCRIPTS / script), *map(str, args)]
    sys.path.insert(0, str(ROOT_SCRIPTS))
    try:
        runpy.run_path(str(ROOT_SCRIPTS / script), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = argv, path


def files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def staged(tree, tmp_path_factory):
    """Both sides' prepare_mfa and finalize_mfa trees (the stand-in MFA
    output between them), in working directories of their own."""
    out = {}
    for side in ("root", "port"):
        work = tmp_path_factory.mktemp(side)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            tsv = ["--speakers_tsv", tree / "speakers.tsv"]
            args = [tree / "LibriTTS_R", work / "per_spk", *tsv]
            fin = [work / "per_spk", tree / "mfa_fake", work / "cleaned",
                   *tsv]
            if side == "root":
                run_root("prepare_mfa.py", *args, "--n_jobs", 2)
                run_root("finalize_mfa.py", *fin)
            else:
                prepare_mfa.main([*map(str, args), "--n_jobs", "2"])
                finalize_mfa.main(list(map(str, fin)))
        finally:
            os.chdir(cwd)
        out[side] = work
    return out


def test_prepare_and_finalize_match_the_root_scripts(staged):
    """The .lab pairing (a wav without a transcript is left out), the
    int16 rewrite and the TextGrid placement, file for file; the
    unaligned utterance is listed as missing."""
    root, port = staged["root"], staged["port"]
    for sub in ("per_spk", "cleaned"):
        ours, theirs = files(port / sub), files(root / sub)
        assert ours == theirs, sorted(set(ours) ^ set(theirs))
    per_spk = files(port / "per_spk")
    assert len([k for k in per_spk if k.endswith(".lab")]) == 6
    assert len([k for k in per_spk if k.endswith(".wav")]) == 6
    assert (port / "cleaned/missing_utt_ids.txt").read_text() == \
        f"{_utt('1034', 1)}\n"
    assert (port / "log/prepare_mfa.log").exists()
    sr, wav = wavfile.read(port / "cleaned/1040/wav24k"
                           / f"{_utt('1040', 0)}.wav")
    assert sr == 24000 and wav.dtype == np.int16


def test_run_mfa_names_the_missing_binary(tmp_path, monkeypatch, tree):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="'mfa' is not on the PATH"):
        run_mfa.main([str(tree / "LibriTTS_R"), str(tmp_path / "out"),
                      "--speakers_tsv", str(tree / "speakers.tsv")])
    assert not (tmp_path / "out").exists()


def fake_mfa(bin_dir: Path, textgrids: Path) -> Path:
    """An ``mfa`` that logs its arguments and, for ``align IN DICT MODEL
    OUT``, copies the stand-in TextGrids of IN's speaker into OUT."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    exe = bin_dir / "mfa"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\nfrom pathlib import Path\n"
        "with open(Path(__file__).with_name('calls.txt'), 'a') as f:\n"
        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
        "_, spk_in, _, _, out = sys.argv[1:6]\n"
        f"src = Path({str(textgrids)!r}) / Path(spk_in).name\n"
        "shutil.copytree(src, out, dirs_exist_ok=True)\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return exe


def test_run_mfa_aligns_each_speaker(tmp_path, monkeypatch, tree, staged):
    exe = fake_mfa(tmp_path / "bin", tree / "mfa_fake")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", f"{exe.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    per_spk = staged["port"] / "per_spk"
    run_mfa.main([str(per_spk), str(tmp_path / "aligned"), "--speakers_tsv",
                  str(tree / "speakers.tsv"), "--n_jobs", "3"])
    calls = (exe.parent / "calls.txt").read_text().splitlines()
    assert calls == [
        f"align {per_spk / spk} english_us_arpa english_us_arpa "
        f"{tmp_path / 'aligned' / spk} --num_jobs 3 --clean --quiet --use_mp"
        for spk in SPEAKERS]
    assert files(tmp_path / "aligned") == files(tree / "mfa_fake")


@pytest.fixture(scope="module")
def utt_stats(tree, staged, tmp_path_factory):
    """Both sides' compute_utt_stats YAML of the finalized tree (the
    port's YIN on the CPU)."""
    out = {}
    cleaned = staged["port"] / "cleaned"
    for side in ("root", "port"):
        work = tmp_path_factory.mktemp(f"stats_{side}")
        cwd = os.getcwd()
        os.chdir(work)
        try:
            args = [cleaned, tree / "f0_stats.yaml", "--out_filename",
                    work / "utt.yaml", "--num_jobs", 2, "--speakers_tsv",
                    tree / "speakers.tsv"]
            if side == "root":
                run_root("compute_utt_stats.py", *args)
            else:
                compute_utt_stats.main([*map(str, args), "--device", "cpu"])
        finally:
            os.chdir(cwd)
        out[side] = work / "utt.yaml"
    return out


def test_compute_utt_stats_matches_the_root_script(utt_stats):
    """The same utterances and keys; each value within one rounding
    step; the port's YAML is what PyYAML writes and reads."""
    theirs = yaml.safe_load(utt_stats["root"].read_text())
    text = utt_stats["port"].read_text()
    ours = yaml_lite.loads(text)
    assert yaml.safe_load(text) == ours
    assert yaml.dump(ours) == text
    assert list(ours) == list(theirs) and len(ours) == 5
    assert all(isinstance(k, str) for k in ours)
    for utt, stats in theirs.items():
        assert sorted(ours[utt]) == sorted(stats)
        assert ours[utt]["invalid"] == stats["invalid"]
        for k, v in stats.items():
            assert abs(ours[utt][k] - v) <= ROUNDING, (utt, k, ours[utt][k],
                                                      v)
    assert yaml_lite.loads(utt_stats["root"].read_text()) == theirs


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_add_style_prompt_tags_matches_the_root_script(tree, utt_stats,
                                                       tmp_path,
                                                       monkeypatch):
    """On the root script's YAML, the CSV byte for byte: the labels, the
    content prompts (one that starts with "-" and one on the failed list
    marked invalid), the statistics as pandas writes them."""
    monkeypatch.chdir(tmp_path)
    cands = REPO / "metadata/style_prompt_candidates.csv"
    args = [tree / "LibriTTS_R", utt_stats["root"], cands,
            "--failed_list_dir", tree / "failed", "--speakers_tsv",
            tree / "speakers.tsv"]
    run_root("add_style_prompt_tags.py", *args, "--out_filename",
             tmp_path / "root.csv")
    add_style_prompt_tags.main([*map(str, args), "--out_filename",
                                str(tmp_path / "port.csv")])
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "root.csv").read_bytes()
    rows = _csv(tmp_path / "port.csv")
    head, body = rows[0], rows[1:]
    assert len(body) == 5
    invalid = {r[0]: r[head.index("invalid")] for r in body}
    assert invalid[_utt("1040", 2)] == "1" and invalid[_utt("1034", 2)] == "1"
    prompts = {r[0]: r[head.index("content_prompt")] for r in body}
    assert prompts[_utt("1040", 0)] == 'hello, "world" number 0'


def test_runall_scripts_run_the_chain(tree, staged, utt_stats, tmp_path):
    """``runall_mfa.sh`` (with the stand-in ``mfa``) and
    ``runall_style_prompt_tags.sh`` (YIN on the CPU) give the stage-wise
    trees and files."""
    exe = fake_mfa(tmp_path / "bin", tree / "mfa_fake")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PATH=f"{exe.parent}{os.pathsep}{env['PATH']}",
               LIBRITTS_R_DIR=str(tree / "LibriTTS_R"),
               OUTPUT_DIR=str(tmp_path / "out"),
               SPEAKERS_TSV=str(tree / "speakers.tsv"), N_JOBS="2",
               METADATA_DIR=str(tmp_path / "meta"), DEVICE="cpu")
    (tmp_path / "meta").mkdir()
    (tmp_path / "meta/libritts_r_f0_stats.yaml").write_bytes(
        (tree / "f0_stats.yaml").read_bytes())
    (tmp_path / "meta/style_prompt_candidates.csv").write_bytes(
        (REPO / "metadata/style_prompt_candidates.csv").read_bytes())
    for script in ("runall_mfa.sh", "runall_style_prompt_tags.sh"):
        run = subprocess.run(["bash", str(PORT_SCRIPTS / script)],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
    out = tmp_path / "out"
    assert files(out / "libritts_r_per_spk") == \
        files(staged["port"] / "per_spk")
    assert files(out / "libritts_r_per_spk_cleaned") == \
        files(staged["port"] / "cleaned")
    assert (out / "libritts_r_per_utt_metadata.yaml").read_text() == \
        utt_stats["port"].read_text()
    rows = _csv(out / "metadata_w_style_prompt_key.csv")
    assert len(rows) == 6 and rows[0][0] == "item_name"
