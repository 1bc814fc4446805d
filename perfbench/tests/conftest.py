"""Fixtures of the benchmark's tests: ``cuda`` skips a test without a
card (decided when the test runs, never at import); ``tmpdir_env`` gives
the run a TMPDIR of its own."""

import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path
