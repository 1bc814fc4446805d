"""The benchmark's command, as a check runs it: without a card, or in a
directory that holds only BENCHMARK.json and the benchmark's files, it
exits with another code than 0 and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import cell as cells

ARGS = ["--workload", "serve_online_b1", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, BENCH_RUN="x", **(env_extra or {}))
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


def test_without_a_card_no_result(cuda_absent):
    out = _run(cells.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr[-2000:]
    _no_result(out)
    assert "no result" in out.stderr


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
