"""A CPU rehearsal of ``chip_smoke.py``'s phase 15 (the experimental nets
and the data-prep command line, each on the card against the CPU): the
phase at a tiny size with ``dev="cpu"`` and CUDA's events, memory
statistics and synchronization stubbed, so the comparisons, the timing
and the command line run as they do on the card."""

import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

TINY = dict(
    batch=2, frames=24, mels=8, cond=12, style=8, convnext=(16, 32, 2),
    mrf=(16, (3, 7), (1, 3)), conformer=(2, 16, 2, 5),
    vits=(16, 2, 2, 3, 2, 4), unet_dim=8, glow=(8, 2, 2),
    diffnet=(16, 3, 16, 2), anc_steps=10, plms=5, cnf_steps=3, sde_steps=4,
    utts=2, seconds=(1.0, 1.4))


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def query(self):
        return False

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.fixture
def cpu_cuda(monkeypatch, tmp_path):
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0),
                       ("empty_cache", lambda: None),
                       ("_sleep", lambda cycles: None), ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path / "out")


def test_phase15_rehearsal_on_the_cpu(cpu_cuda, capsys):
    from promptttspp_tpu_torch.ops.kernels import amp as k2
    from promptttspp_tpu_torch.ops.kernels import snake as k1

    failures = []
    with mock.patch.dict(chip_smoke.AUX, TINY):
        launches = chip_smoke.phase_aux_nets(k1, k2, "cpu", "cpu, 0 W",
                                             failures)
    out = capsys.readouterr().out
    assert failures == []
    assert launches == {"antialias_snake": 0, "amp_layer_bf16": 0,
                        "amp_layer": 0, "amp_block": 0, "amp_block_bf16": 0}
    lines = [ln for ln in out.splitlines() if "phase 15:" in ln]
    assert len(lines) == len(chip_smoke.aux_net_entries()) + 2
    assert all("(ok)" in ln for ln in lines[:-1]), out
    assert "reverse of its forward" in out
    assert "compute_utt_stats over 2 utterances" in out
    assert not (chip_smoke.OUT_DIR / "aux_nets").exists()
