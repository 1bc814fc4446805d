"""The reference (the frozen plain modules) agrees with the port on the
CPU at tiny widths, with the same weights from the benchmark's seed."""

import copy

import numpy as np
import pytest
import torch

from perfbench.harness import weights
from perfbench.reference.ptts import build
from perfbench.tests import tiny

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def cfg():
    return tiny.spec("serve_offline_b16")["config"]


def _pair(cfg, which):
    from promptttspp_tpu_torch import flagship

    if which == "model":
        prog = flagship.build_model(cfg["model"], "cpu", seed=0)
        ref = build.build_model(cfg["model"], "cpu")
        pins = cfg["pins"]
    else:
        prog = flagship.build_vocoder("cpu", seed=1, cfg=cfg["vocoder"])
        ref = build.build_vocoder(cfg["vocoder"], "cpu")
        pins = None
    for m in (prog, ref):
        weights.fill(m, weights.sub_seed(SEED, which), pins)
    return prog, ref


def test_weights_are_the_same_on_both_sides(cfg):
    prog, ref = _pair(cfg, "model")
    for (n, a), (m, b) in zip(prog.state_dict().items(),
                              ref.state_dict().items()):
        assert n == m
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    p = dict(prog.named_parameters())
    mu = "variance_adaptor.duration_predictor.out_layer.mu.bias"
    assert float(p[mu][0]) == pytest.approx(np.log(10.0))


def test_weights_differ_across_seeds(cfg):
    from promptttspp_tpu_torch import flagship

    m = flagship.build_model(cfg["model"], "cpu", seed=0)
    weights.fill(m, 1)
    a = copy.deepcopy(m.state_dict())
    weights.fill(m, 2)
    assert any(not torch.equal(a[k], v) for k, v in m.state_dict().items()
               if v.is_floating_point())


def test_acoustic_model_agrees(cfg):
    prog, ref = _pair(cfg, "model")
    g = torch.Generator().manual_seed(3)
    ph = torch.randint(1, 90, (2, 16), generator=g)
    pl = torch.tensor([16, 11])
    ids = torch.randint(1000, 2000, (2, 16), generator=g)
    mask = torch.ones(2, 16, dtype=torch.long)
    outs = []
    for m in (prog, ref):
        with torch.no_grad():
            outs.append(m.infer(ph, pl, 256, ids, mask, use_max=True,
                                noise_scale=0.5,
                                style_generator=torch.Generator()
                                .manual_seed(5),
                                diffusion_generator=torch.Generator()
                                .manual_seed(6)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert int(outs[0][1][0]) == 160  # 16 phones at the pinned 10 frames


def test_vocoder_agrees(cfg):
    from perfbench.reference.ptts import precision

    prog, ref = _pair(cfg, "vocoder")
    g = torch.Generator().manual_seed(4)
    mel = torch.randn(2, 24, 80, generator=g)
    f0 = 100 + 50 * torch.rand(2, 24, 1, generator=g)
    with torch.no_grad(), precision.use("ieee", None):
        a = prog(mel, f0, deterministic=True)
        b = ref(mel, f0, deterministic=True)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_training_step_agrees(cfg, tmpdir_env):
    """The harness's CPU run of the training cell: the program's first
    three updates equal the reference's."""
    import time

    from perfbench.harness import cell as cells
    from perfbench.harness import main as M
    from perfbench.harness.run import Run

    spec = tiny.train_spec(utterances=40, phones=[13, 30])
    run = Run(spec, SEED, 1.0, False, time.perf_counter(), device="cpu")
    M.execute(run, cells.driver("train_loop"))
    assert run.correct, run.checks
    assert all(c["value"] <= 1e-6 for c in run.checks.values())
    assert len(run.values["program"]["losses"]) == 3
