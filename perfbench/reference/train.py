"""The reference's side of a training check: the first updates of a
train state built from the same configuration and seed, on the same
corpus files, through the frozen plain modules (``ptts/``): its own
dataset, prompt draws, collation, token buckets and epoch-1 order, its own
model with the benchmark's weights of the seed, its own AdamW and Noam
rate, the same per-update generators. It reads nothing the program made.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.harness import training, weights
from perfbench.reference.ptts import build, precision
from perfbench.reference.ptts.data.batching import (ShuffleBatchSampler,
                                                    batch_by_size)
from perfbench.reference.ptts.data.collate import PromptTTSCollator
from perfbench.reference.ptts.data.dataset import AllWithSpkPromptNormDataset
from perfbench.reference.ptts.models.bert import WordPieceTokenizer
from perfbench.reference.ptts.train.state import TrainState
from perfbench.traffic import corpus


def batches(cfg: Dict, root, epoch: int = 1):
    """The epoch's collated batches (host arrays), in order."""
    train = cfg["train"]
    ds = AllWithSpkPromptNormDataset(**corpus.paths(root),
                                     seed=train["seed"])
    collate = PromptTTSCollator(
        WordPieceTokenizer.from_vocab_file(corpus.vocab_file(root)))
    sampler = ShuffleBatchSampler(
        batch_by_size(ds.ordered_indices(), ds.num_tokens,
                      max_tokens=cfg["dataset"]["max_tokens"]),
        shuffle=True, seed=train["seed"])
    sampler.set_epoch(epoch)
    ds.set_epoch(epoch)
    for idx in sampler:
        yield collate([ds[i] for i in idx])


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k in training.MODEL_BATCH_KEYS:
        if k in batch:
            a = torch.as_tensor(batch[k])
            out[k] = (a.to(torch.int64) if not a.is_floating_point()
                      else a).to(device)
    return out


def half(batch: Dict) -> Dict:
    """The first half of ``batch``'s rows (the fault of half of a batch
    left out, the mean taken over the rest)."""
    n = (len(batch["phone_lengths"]) + 1) // 2
    return {k: (v[:n] if hasattr(v, "shape") and len(v.shape) else v)
            for k, v in batch.items()}


def readings(cfg: Dict, seed: int, root, device: str,
             float32: str = "ieee", updates: int = 3,
             half_rows: bool = False) -> Dict:
    """-> {"losses": [each update's loss], "grad": {leaf: norm of the first
    gradient AdamW took}, "change": {leaf: norm of the change over the
    updates}}, computed in ``float32`` ("ieee"; "tf32" for the
    control); ``half_rows``: each batch's first half only (a fault)."""
    model = build.build_model(cfg["model"], device)
    weights.fill(model, weights.sub_seed(seed, "model"), cfg["pins"])
    opt, train = cfg["optimizer"], cfg["train"]
    state = TrainState(model, lr=opt["lr"],
                       warmup_steps=train["lr_scheduler"]["warmup_steps"],
                       betas=tuple(opt["betas"]),
                       weight_decay=opt["weight_decay"], seed=train["seed"])
    before = [p.detach().clone() for p in state.params]
    losses, first = [], None
    with precision.use(float32):
        for i, batch in enumerate(batches(cfg, root)):
            if i == updates:
                break
            if half_rows:
                batch = half(batch)
            out = state.train_step(to_device(batch, device))
            losses.append(float(out["loss"]))
            if i == 0:
                first = training.first_gradient(
                    state.params, state.trainable, state.optimizer)
    moved = training.change(state.params, before, state.trainable)
    del state, model, before
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, grad=first, change=moved)
