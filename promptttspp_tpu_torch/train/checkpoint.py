"""Checkpoints of the trainer: torch files in the reference trainer's
layout ``{epoch, step, model, optimizer}``.

Counterpart of ``promptttspp_tpu/train/checkpoint.py`` (cadence and names:
``ckpt/last`` every epoch, ``ckpt/epoch-NNNN`` every ``save_interval``,
``ckpt/crash`` on a failure) with torch files instead of orbax trees. The
``model`` entry is the reference's state dict
(``compat/torch_ckpt.py::to_reference_state_dict``), so the synthesize CLI
and ``load_reference_state_dict`` read it as they read a reference
checkpoint; ``optimizer`` is torch's AdamW state dict over the trainable
parameters. A file is written beside its final name and then renamed, so a
crash mid-write leaves the previous file whole.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from promptttspp_tpu_torch.compat.torch_ckpt import (
    load_reference_state_dict, to_reference_state_dict, torch_state_dict)


def save_checkpoint(path, state, epoch: int):
    """Write ``state`` (a ``TrainState``) and ``epoch`` to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"epoch": int(epoch), "step": int(state.step),
                "model": to_reference_state_dict(state.model),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path, state) -> int:
    """Resume: load the model, the optimizer and the update count of
    ``path`` into ``state``; returns the checkpoint's epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(state.model, ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def load_pretrained(path, state):
    """Warm start: the model weights of ``path`` (a checkpoint of this
    trainer, a reference checkpoint or an ``.npz`` state dict) only."""
    load_reference_state_dict(state.model, torch_state_dict(path, "model"))
