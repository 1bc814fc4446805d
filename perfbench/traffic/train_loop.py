"""Training: ``TrainState.train_step`` on batches from the prefetching
input pipeline, as the port's trainer runs its epochs.

``params``: a corpus of ``utterances`` (``traffic/corpus.py``: ``phones``,
``frames_per_phone``) written under TMPDIR at set-up; the batches of
``dataset.max_tokens`` formed by ``TTSTrainer.batches`` and shuffled per
epoch; ``prefetch_batches`` (``train.num_workers`` threads,
``train.prefetch_depth`` ahead, a copy stream) feeding the updates; a
loss read back every ``train.host_sync_every`` updates, as the trainer
does. ``trace_seconds`` traced in a ``--trace 1`` run.

Set-up builds the one train state the window uses and runs epoch 1 on it:
its first three updates are the ones the check compares with the
reference (the losses, the first gradient, the parameters' change), the
rest warm every batch shape of the corpus. The window runs epochs 2, 3,
... for ``--seconds`` and ends when the device has finished the last
update. ``train_frames_per_s``: the unpadded mel frames of every update
of the window over the window.
"""

from __future__ import annotations

import shutil
import sys
import time

import numpy as np

from perfbench.harness import serving, training, weights
from perfbench.traffic import corpus

CHECKED_UPDATES = 3


def run(run):
    import torch
    from promptttspp_tpu_torch.data.collate import PromptTTSCollator
    from promptttspp_tpu_torch.data.dataset import \
        AllWithSpkPromptNormDataset
    from promptttspp_tpu_torch.data.prefetch import prefetch_batches
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.train.trainer import (TTSTrainer,
                                                     model_batch_keys)

    p, cfg = run.params, run.config
    cuda = run.device == "cuda"
    if cuda:
        serving.set_float32(cfg["precision"]["float32"])
    root = training.corpus_root()
    run.values["corpus"] = root
    cands, spk = corpus.candidates()
    rows = corpus.training_rows(p["utterances"], cands, spk, p["phones"],
                                p["frames_per_phone"], seed=run.seed)
    corpus.write_training_corpus(root, rows, cands, spk, seed=run.seed,
                                 mel_mean=cfg["mel_stats"]["mean"],
                                 mel_std=cfg["mel_stats"]["std"])
    tcfg = training.trainer_config(cfg, run.device, root / "out")
    ds = AllWithSpkPromptNormDataset(**corpus.paths(root),
                                     seed=cfg["train"]["seed"])
    collator = PromptTTSCollator(
        WordPieceTokenizer.from_vocab_file(corpus.vocab_file(root)))
    trainer = TTSTrainer(tcfg, tokenizer=collator.tokenizer, train_ds=ds)
    state = trainer.build_state()
    weights.fill(state.model, weights.sub_seed(run.seed, "model"),
                 cfg["pins"])
    sampler = trainer.batches(ds, shuffle=True)
    keys = model_batch_keys(state.model)
    t = cfg["train"]

    def epoch(n):
        sampler.set_epoch(n)
        ds.set_epoch(n)
        return prefetch_batches(ds, sampler, collator, model_keys=keys,
                                device=run.device,
                                num_workers=t["num_workers"],
                                prefetch_depth=t["prefetch_depth"])

    # epoch 1: the checked updates, then every shape of the corpus
    before = [q.detach().clone() for q in state.params]
    losses, first = [], None
    loader = epoch(1)
    for i, (_, device_batch) in enumerate(loader):
        if i == CHECKED_UPDATES and run.values.get("checked_updates_only"):
            break
        out = state.train_step(device_batch)
        if i < CHECKED_UPDATES:
            losses.append(float(out["loss"]))
        if i == 0:
            first = training.first_gradient(state.params, state.trainable,
                                            state.optimizer)
        if i == CHECKED_UPDATES - 1:
            moved = training.change(state.params, before, state.trainable)
            del before
    loader.close()
    run.values["program"] = dict(losses=losses, grad=first, change=moved)
    run.values["warm_updates"] = state.step
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_done()

    tracer = run.tracer
    frames, updates, shapes = 0, [], []
    sync_every = int(t.get("host_sync_every", 0))
    n_epoch = 2
    loader = epoch(n_epoch)
    it = iter(loader)
    t0 = run.window()
    while time.perf_counter() - t0 < run.seconds:
        tracer.poll()
        with run.span("next_batch"):
            nxt = next(it, None)
        if nxt is None:
            loader.close()
            n_epoch += 1
            loader = epoch(n_epoch)
            it = iter(loader)
            continue
        batch, device_batch = nxt
        run.attempted += 1
        t_step = time.perf_counter()
        with run.span("train_step"):
            out = state.train_step(device_batch)
        if sync_every and len(updates) % sync_every == sync_every - 1:
            with run.span("host_sync"):
                out["loss"].item()
        keep = batch["batch_weight"] > 0
        frames += int(np.sum(batch["frame_lengths"] * keep))
        shapes.append(tuple(batch["mel"].shape[:2]))
        updates.append((t_step, np.asarray(batch["phone_lengths"])[keep],
                        np.asarray(batch["frame_lengths"])[keep],
                        np.asarray(batch["prompt_mask"]).sum(axis=1)[keep]))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.stop()
    loader.close()
    last = float(out["loss"]) if updates else float("nan")
    if not np.isfinite(last):
        run.failed += 1
    run.e2e["train_frames_per_s"] = frames / wall
    if cuda:
        run.values["window_peak_bytes"] = int(
            torch.cuda.max_memory_allocated())
    run.memory_peak_bytes = serving.memory_peak(run.device)
    run.values.update(window_s=wall, updates=updates, epochs=n_epoch - 1)
    steps = [d for _, d in run.spans["train_step"]]
    slow = sorted(range(len(steps)), key=lambda i: -steps[i])[:5]
    print("slowest train_step calls (s, [rows, frames]): " + ", ".join(
        f"{steps[i]:.3f} {list(shapes[i])}" for i in slow), file=sys.stderr)
    print(f"{run.name}: {len(updates)} updates, {frames} frames in "
          f"{wall:.3f} s ({n_epoch - 1} epochs of {len(sampler)} batches; "
          f"{run.values['warm_updates']} in set-up); last loss {last:.4f}",
          file=sys.stderr)


def check(run):
    from perfbench.reference import judge
    from perfbench.reference import train as reference

    root = run.values["corpus"]
    try:
        ref = reference.readings(run.config, run.seed, root, run.device,
                                 float32=run.config["precision"]["float32"],
                                 updates=CHECKED_UPDATES)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gaps = judge.train_gaps(run.values["program"], ref)
    for name in ("loss", "grad", "change"):
        run.compare(name, gaps[name], run.cell["limits"][name])
