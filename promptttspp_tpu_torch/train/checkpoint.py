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

A model sharded over a model group (``parallel/tp.py``) is saved whole:
every rank of the group joins the sharded parameters and AdamW moments
(``save_checkpoint`` is then a collective, and one rank writes), so the
file is the layout of one process and is served without a mesh. Resume and
warm start cut the whole tensors to each rank's slices.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from promptttspp_tpu_torch.compat.torch_ckpt import (
    load_reference_state_dict, to_reference_state_dict, torch_state_dict)
from promptttspp_tpu_torch.parallel.tp import (
    gather_optimizer_state, gather_state_dict, local_optimizer_state,
    local_state_dict)


def is_sharded(state) -> bool:
    """Whether ``state``'s model is sharded over a model group."""
    return bool(getattr(state.model, "tp_shards", None))


def save_checkpoint(path, state, epoch: int, write: bool = True):
    """Write ``state`` (a ``TrainState``) and ``epoch`` to ``path``, whole.
    A sharded model's ranks all call it (the tensors are joined over the
    group); only those with ``write`` write."""
    model = to_reference_state_dict(state.model)
    model.update({k: v.cpu() for k, v in
                  gather_state_dict(state.model).items()})
    optimizer = gather_optimizer_state(state)
    if not write:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"epoch": int(epoch), "step": int(state.step),
                "model": model, "optimizer": optimizer}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path, state) -> int:
    """Resume: load the model, the optimizer and the update count of
    ``path`` into ``state``, cut to its slices when it is sharded; returns
    the checkpoint's epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(state.model,
                              local_state_dict(state.model, ckpt["model"]))
    state.optimizer.load_state_dict(local_optimizer_state(
        state, ckpt["optimizer"]))
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def load_pretrained(path, state):
    """Warm start: the model weights of ``path`` (a checkpoint of this
    trainer, a reference checkpoint or an ``.npz`` state dict) only."""
    load_reference_state_dict(state.model, local_state_dict(
        state.model, torch_state_dict(path, "model")))
