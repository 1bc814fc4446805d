"""Data-parallel training of the port across processes, on the CPU with
gloo: two ranks against one process on the same global batches, and
``bin/train.py`` spawning two ranks.

The ranks are spawned with ``torch.multiprocessing``; they import torch, the
port and this module (which imports no JAX). The one-process reference runs
in the test's process meanwhile.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import train as train_cli
from promptttspp_tpu_torch.parallel.distributed import DataGroup
from promptttspp_tpu_torch.parallel.mesh import pad_batch_to_multiple
from promptttspp_tpu_torch.tools.synthetic_corpus import (
    training_rows, write_training_corpus)
from promptttspp_tpu_torch.train.state import TrainState
from tests.test_torch_cuda import (
    MEL, OPT, TINY_BERT, TINY_CLI_MODEL, tiny_model_config, torch_batch)
from tests.test_torch_train_data import candidates

WORLD = 2
# the parameters and statistics of each rank against one process's: the
# largest difference relative to the model's largest magnitude. The sums
# run in another order (the gradient over the ranks, the BatchNorm
# statistics, the normalizers), nothing else; AdamW's steps, near lr each,
# magnify a relative error of a gradient that two updates nearly cancel,
# so a tensor that holds only such steps (a LayerNorm beta, 2e-4 after two
# updates) is not held to 1e-5 of its own magnitude.
PARAM_RTOL, LOSS_RTOL = 1e-5, 1e-5
# bf16 (tests/test_torch_train_bf16.py's bar on the losses): bf16 rounds
# products of rows that one process computes in other blocks
BF16_LOSS_ATOL, BF16_PARAM_RTOL = 1.5e-3, 1e-3
JOIN_S = 120


def global_batch(seed: int, B: int, Tp: int = 12, Tf: int = 64,
                 L: int = 16):
    """A numpy global batch of ``B`` rows for the tiny model, with ragged
    phones and prompts, and no diffusion draws given, padded with
    zero-weight rows to a multiple of ``WORLD``."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(4, Tp + 1, B).astype(np.int32)
    duration = np.zeros((B, Tp), np.int32)
    for b in range(B):
        duration[b, :plens[b]] = rng.randint(1, 5, plens[b])
    flens = duration.sum(1).astype(np.int32)
    phoneme = rng.randint(1, 90, (B, Tp)).astype(np.int32)
    phoneme[np.arange(Tp)[None] >= plens[:, None]] = 0
    frame = (np.arange(Tf)[None] < flens[:, None])[:, :, None]
    mask = (np.arange(L)[None] < rng.randint(6, L + 1, B)[:, None])
    return pad_batch_to_multiple(dict(
        phoneme=phoneme, duration=duration, phone_lengths=plens,
        mel=(rng.randn(B, Tf, MEL) * frame).astype(np.float32),
        log_cf0=(rng.randn(B, Tf, 1) * frame).astype(np.float32),
        vuv=((rng.rand(B, Tf, 1) > 0.3) * frame).astype(np.float32),
        frame_lengths=flens,
        prompt_ids=(rng.randint(1, 60, (B, L)) * mask).astype(np.int32),
        prompt_mask=mask.astype(np.int32),
        batch_weight=np.ones(B, np.float32)), WORLD)


# 5 rows padded to 6 (rank 1: two real rows and a pad row), then 1 row
# padded to 2 (rank 1's slab all padding)
BATCHES = [(7, 5), (8, 1)]


def _slab(batch, data):
    if data is None:
        return batch
    return {k: v[data.rows(len(v) // data.world)] for k, v in batch.items()}


def run_updates(data=None):
    """2 float32 updates on ``BATCHES`` and 1 bf16 update on the first,
    dropout on -> {"f32": (losses, state_dict), "bf16": (...)}; with
    ``data``, on this rank's rows."""
    batches = [global_batch(s, b) for s, b in BATCHES]
    out = {}
    for name, bf16, steps in (("f32", False, batches),
                              ("bf16", True, batches[:1])):
        model = flagship.build_model(tiny_model_config(), "cpu", seed=0,
                                     bert_config=TINY_BERT)
        state = TrainState(model, seed=0, bf16=bf16, data=data, **OPT)
        losses = [{k: float(v) for k, v in state.train_step(
            torch_batch(_slab(b, data))).items()} for b in steps]
        out[name] = (losses, {k: v.clone()
                              for k, v in model.state_dict().items()})
    return out


def _rank(rank: int, port: int, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        torch.save(run_updates(DataGroup(rank, WORLD)),
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two ranks with dropout on, a ragged batch and an all-padding slab:
    both hold the same parameters and statistics, and those and the losses
    are one process's on the same global batches."""
    ctx = mp.start_processes(_rank, args=(train_cli.free_port(),
                                          str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = run_updates()
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {JOIN_S} s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    for name, loss_ok, rtol in (
            ("f32", lambda a, b: np.isclose(a, b, rtol=LOSS_RTOL, atol=0),
             PARAM_RTOL),
            ("bf16", lambda a, b: abs(a - b) <= BF16_LOSS_ATOL,
             BF16_PARAM_RTOL)):
        losses0, sd0 = ranks[0][name]
        losses1, sd1 = ranks[1][name]
        assert losses0 == losses1, name
        for k in sd0:
            assert torch.equal(sd0[k], sd1[k]), f"{name} {k}: ranks differ"
        ref_losses, ref_sd = ref[name]
        for i, (a, b) in enumerate(zip(losses0, ref_losses)):
            for k in b:
                assert loss_ok(a[k], b[k]), (name, i, k, a[k], b[k])
        init = flagship.build_model(tiny_model_config(), "cpu", seed=0,
                                    bert_config=TINY_BERT).state_dict()
        diff = scale = moved = 0.0
        for k, v in ref_sd.items():
            if not v.is_floating_point():
                assert torch.equal(sd0[k], v), k
                continue
            diff = max(diff, float((sd0[k] - v).abs().max()))
            scale = max(scale, float(v.abs().max()))
            moved = max(moved, float((v - init[k]).abs().max()))
        assert diff <= rtol * scale, (name, diff, scale)
        assert moved > 10 * rtol * scale, (name, moved)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_corpus")
    cands, spk = candidates(n_keys=8)
    rows = training_rows(14, cands, spk, phones=(4, 12),
                         frames_per_phone=(2, 6), valid_every=7, seed=2)
    write_training_corpus(root, rows, cands, spk, mel_mean=-4.5,
                          mel_std=2.1)
    return root


def test_train_cli_spawns_gloo_ranks(corpus, tmp_path, monkeypatch):
    """``bin/train.py`` with ``train.distributed.num_processes=2`` on the
    CPU spawns two gloo ranks: one epoch of unseeded prompt draws (rank
    0's seed is shared), the records written by rank 0 only,
    ``ckpt/last`` beside them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    out = tmp_path / "out"
    argv = [f"path.root={corpus}", f"output_dir={out}", "device=cpu",
            f"hydra.run.dir={tmp_path / 'run'}", "train.num_epochs=1",
            "dataset.max_tokens=300", "train.lr_scheduler.warmup_steps=10",
            "+train.input_pipeline=sync", "+train.distributed.num_processes=2",
            *TINY_CLI_MODEL]
    assert train_cli.main(argv) is None
    log = (out / "logs/train.log").read_text()
    assert "rank 0 of 2" in log and "rank 1" not in log
    assert "epoch 1 valid:" in log
    rows = (out / "logs/loss.csv").read_text().splitlines()
    assert len(rows) == 2
    assert np.isfinite([float(v) for v in rows[1].split(",")]).all()
    assert (out / "ckpt/last").exists()
    assert json.loads((out / "config.yaml").read_text())["train"][
        "distributed"]["num_processes"] == 2


@pytest.mark.parametrize("overrides,env,expect", [
    ([], {}, 0), (["+train.distributed.num_processes=1"], {}, 0),
    (["+train.distributed.num_processes=3"], {}, 3),
    (["+train.distributed.num_processes=2",
      "+train.distributed.process_id=1"], {}, 0),
    (["+train.distributed.num_processes=2"], {"RANK": "0"}, 0)])
def test_when_the_cli_spawns(monkeypatch, overrides, env, expect):
    """``bin/train.py`` spawns ``num_processes`` workers above 1, none for
    one process, none where this process joins a group (torchrun's
    ``RANK`` or ``process_id``); and ``init_distributed`` forms no group
    for one process without a ``process_id``."""
    from promptttspp_tpu_torch.bin import conf
    from promptttspp_tpu_torch.parallel.distributed import init_distributed

    monkeypatch.delenv("RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = conf.compose("train", ["device=cpu", *overrides])
    assert train_cli._spawned_processes(cfg) == expect
    if not env:
        assert init_distributed(num_processes=1, device_type="cpu") is False
