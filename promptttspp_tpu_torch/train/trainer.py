"""Training of the acoustic model, on one GPU or data-parallel over several.

Counterpart of ``promptttspp_tpu/train/trainer.py::TTSTrainer``: the model,
the optimizer and the data from the ``train`` config (``bin/conf.py``), the
epoch loop over token-bucketed batches (``dataset.dynamic_batch``, or a
fixed ``train.batch_size``) shuffled per epoch as a function of (seed,
epoch), validation on the running statistics, and the JAX trainer's
records: ``logs/train.log``, ``logs/loss.csv`` (one row per epoch), the
config snapshot ``config.yaml`` (JSON, which YAML reads), TensorBoard
scalars when ``torch.utils.tensorboard`` is installed (unless
``train.tensorboard=false``; its import takes seconds), checkpoints
``ckpt/last`` every epoch and ``ckpt/epoch-NNNN`` every
``train.save_interval``, ``ckpt/crash`` on a failure, resume
(``ckpt_path``) and warm start (``pretrained``). ``train.profile_steps=N``
traces updates N .. N+2 with ``torch.profiler`` into ``logs/profile/``.

``train.bf16=true`` (``train.fp16`` is its alias, as in JAX) trains in
bfloat16 with float32 masters (``train/state.py``). The input pipeline is
JAX's: ``train.input_pipeline=sync`` assembles each batch inline,
``sync_native`` inline with the C++ feature loader
(``data/native_loader.py``), ``prefetch`` in a pool of
``train.num_workers`` threads, ``train.prefetch_depth`` batches ahead,
staged on the device on a copy stream (``data/prefetch.py``); unset, it is
chosen for the host as JAX chooses it (``auto_input_pipeline``;
``train.prefetch`` false means ``sync``). A mode that needs the loader
raises if the loader does not build. Every ``train.host_sync_every``
updates the host reads a loss back, so it runs at most that many updates
ahead of the card. Validation assembles its batches inline.

Data parallelism (``parallel/distributed.py``): in a process group (torchrun's
environment, or ``train.distributed.{coordinator_address,num_processes,
process_id}``, NCCL on a GPU and gloo on the CPU or with
``train.distributed.backend=gloo``) each rank trains on ``cuda:LOCAL_RANK``.
The batches are formed with a row multiple of the world size W and only
W-divisible ones are kept (all, where none is, as JAX does); each rank
collates its rows of every global batch at the global batch's buckets, a
ragged batch padded with zero-weight rows, validation's too; the step is
the global batch's (``train/state.py``). Rank 0 writes the logs,
``loss.csv``, the profile and the checkpoints, the others wait at a
barrier after each checkpoint; every rank restores the same checkpoint,
and rank 0's parameters are broadcast before the first update. At world
size 1 the step is the single-process one, bit for bit.

The model axis (``train.mesh.model=M``): the W processes fold into W / M
data shards of M ranks each (``parallel/distributed.py::process_groups``:
rank ``d * M + m``, or ``m * D + d`` with
``train.mesh.model_spans_processes``), the M ranks of a data shard holding
the same rows. They split the model by tensor parallelism
(``parallel/tp.py``: Megatron's column and row sharding of the layers
JAX's ``param_partition_spec`` names), or, with
``train.mesh.pipeline_microbatches=P``, they run the DiffNet as a GPipe
pipeline of M stages in P microbatches (``parallel/pp.py``), its
parameters kept out of TP, the batch multiple then ``D * max(1, P)``. A
model axis across processes (``model_spans_processes``) turns TP off, as
in JAX. The checkpoints are whole (``train/checkpoint.py``).

The port raises, naming the key, on what it does not implement: the XLA
compilation cache and the per-epoch scheduler.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.data import native_loader
from promptttspp_tpu_torch.data.batching import (
    ShuffleBatchSampler, batch_by_size)
from promptttspp_tpu_torch.data.collate import PromptTTSCollator
from promptttspp_tpu_torch.data.dataset import AllWithSpkPromptNormDataset
from promptttspp_tpu_torch.data.prefetch import (
    _collate_native, entry_metas, finish, host_tensors, prefetch_batches)
from promptttspp_tpu_torch.parallel.distributed import (
    host_batches, init_distributed, process_groups, rank_device)
from promptttspp_tpu_torch.parallel.pp import StageDevices
from promptttspp_tpu_torch.parallel.tp import shard_module
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.train import checkpoint as ckpt_lib
from promptttspp_tpu_torch.train.state import TrainState
from promptttspp_tpu_torch.train.tracker import Tracker

INPUT_PIPELINES = ("sync", "sync_native", "prefetch")
MODEL_BATCH_KEYS = (
    "phoneme", "duration", "phone_lengths", "mel", "log_cf0", "vuv",
    "frame_lengths", "prompt_ids", "prompt_mask", "batch_weight",
    "diffusion_t", "diffusion_noise",
)


def model_batch_keys(model) -> Tuple[str, ...]:
    """The keys of a collated batch that ``model`` reads:
    ``MODEL_BATCH_KEYS``, and the energy target where its variance adaptor
    has an energy branch. Only those reach the device: the C++ loader sums
    the energy in another order than numpy, so a model without the branch
    gets the same device batches from every input pipeline, bit for
    bit."""
    va = getattr(model, "variance_adaptor", None)
    if getattr(va, "energy_predictor", None) is None:
        return MODEL_BATCH_KEYS
    return MODEL_BATCH_KEYS + ("energy",)


def select(cfg: Mapping, dotted: str, default=None):
    """``cfg["a"]["b"]`` for "a.b"; ``default`` where a key is absent."""
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node


def check_supported(cfg: Mapping):
    """Raise, naming the key, where ``cfg`` asks for what the port's
    trainer does not implement."""
    refused = {
        "train.compilation_cache_dir": "the XLA compilation cache has no "
                                       "counterpart in the port",
        "train.per_epoch_scheduler": "the per-epoch scheduler is not ported",
    }
    for key, why in refused.items():
        if select(cfg, key):
            raise ValueError(f"{key}={select(cfg, key)!r}: {why}")
    for key in ("train.mesh.model", "train.mesh.pipeline_microbatches"):
        value = select(cfg, key)
        if value is not None and (not isinstance(value, int) or value < 0):
            raise ValueError(f"{key}={value!r}: a count")
    backend = select(cfg, "train.distributed.backend")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"train.distributed.backend={backend!r}: 'nccl' or "
                         "'gloo'")
    pipeline = select(cfg, "train.input_pipeline")
    if pipeline not in (None, *INPUT_PIPELINES):
        raise ValueError(f"train.input_pipeline={pipeline!r}: one of "
                         f"{INPUT_PIPELINES}")


def _has_meta(ds) -> bool:
    return hasattr(ds, "item_meta") and getattr(ds, "stats", None) is not None


def auto_input_pipeline(ds) -> str:
    """JAX's choice for this host: "prefetch" with 4 or more cores, where
    its workers have cores to run on; else inline assembly, with the C++
    loader where the dataset has file-backed item metadata."""
    if (os.cpu_count() or 1) >= 4:
        return "prefetch"
    return "sync_native" if _has_meta(ds) else "sync"


def to_device(batch: Dict, device,
              keys: Sequence[str] = MODEL_BATCH_KEYS
              ) -> Dict[str, torch.Tensor]:
    """The model's ``keys`` of a collated batch as tensors on ``device``
    (integers as int64)."""
    return {k: t.to(device) for k, t in host_tensors(batch, keys).items()}


class TTSTrainer:
    """Builds the model, optimizer and data of ``cfg`` and runs the epoch
    loop. ``train_ds`` may be given (a test's dataset); otherwise it comes
    from ``cfg``, as the validation set does."""

    def __init__(self, cfg: Mapping, tokenizer=None, train_ds=None):
        check_supported(cfg)
        self.cfg = cfg
        self.train_ds = train_ds
        self.valid_ds = None
        self.tokenizer = tokenizer
        self.device = resolve_device(cfg.get("device", "cuda"))
        # a process group: torchrun's environment or train.distributed.*
        self.data = self.model_group = None
        n_model = select(cfg, "train.mesh.model") or 1
        self.microbatches = select(cfg, "train.mesh.pipeline_microbatches") \
            or 0
        self.model_spans = bool(select(cfg,
                                       "train.mesh.model_spans_processes"))
        if init_distributed(
                select(cfg, "train.distributed.coordinator_address"),
                select(cfg, "train.distributed.num_processes"),
                select(cfg, "train.distributed.process_id"),
                select(cfg, "train.distributed.backend"), self.device.type):
            self.data, self.model_group = process_groups(n_model,
                                                         self.model_spans)
            self.device = rank_device(self.device.type)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        elif n_model > 1:
            raise ValueError(
                f"train.mesh.model={n_model}: the model axis is a group of "
                f"{n_model} processes per data shard; set "
                "train.distributed.num_processes to a multiple of it")
        self.rank = dist.get_rank() if self.data else 0
        self.world = dist.get_world_size() if self.data else 1
        self.n_data = self.data.world if self.data else 1
        # the rows of a global batch are a multiple of this
        self.batch_multiple = self.n_data * max(1, self.microbatches)
        self.is_main = self.rank == 0
        self.output_dir = Path(cfg.get("output_dir", "./out"))
        self.log_dir = self.output_dir / "logs"
        self.ckpt_dir = self.output_dir / "ckpt"
        self.seed = select(cfg, "train.seed", 42)
        self.state: Optional[TrainState] = None
        self.model_keys = MODEL_BATCH_KEYS  # model_batch_keys of the model
        self.profile = None  # the torch.profiler of train.profile_steps

    # ------------------------------------------------------------- setup
    def _build_datasets(self):
        if self.train_ds is None:
            self.train_ds = AllWithSpkPromptNormDataset(
                **self.cfg["dataset"]["train"])
        if select(self.cfg, "dataset.valid"):
            self.valid_ds = AllWithSpkPromptNormDataset(
                **self.cfg["dataset"]["valid"])
        unseeded = [ds for ds in (self.train_ds, self.valid_ds)
                    if getattr(ds, "seed", 0) is None]
        if self.world > 1 and unseeded:
            # every rank draws every row's prompt (host_batches): an
            # unseeded dataset takes rank 0's random seed, so the ranks
            # draw alike, as one process would
            seed = self.data.broadcast_object(random.randrange(2**31),
                                              self.device)
            for ds in unseeded:
                ds.seed = seed

    def _setup_logging(self):
        self.logger = logging.getLogger("promptttspp_tpu_torch.train")
        self.logger.setLevel(logging.INFO)
        self.writer = None
        if not self.is_main:  # the records come from rank 0 only
            return
        for d in (self.output_dir, self.log_dir, self.ckpt_dir):
            d.mkdir(parents=True, exist_ok=True)
        snapshot = {k: v for k, v in self.cfg.items() if k != "hydra"}
        (self.output_dir / "config.yaml").write_text(
            json.dumps(snapshot, indent=2, default=str) + "\n")
        logger = self.logger
        log_path = str((self.log_dir / "train.log").absolute())
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler) and \
                    h.baseFilename != log_path:
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler)
                   for h in logger.handlers):
            fh = logging.FileHandler(log_path)
            fh.setFormatter(logging.Formatter(
                "[%(asctime)s][%(levelname)s][%(module)s | %(lineno)s] "
                "%(message)s"))
            logger.addHandler(fh)
        if not any(type(h) is logging.StreamHandler
                   for h in logger.handlers):
            logger.addHandler(logging.StreamHandler())
        self.logger = logger
        if select(self.cfg, "train.tensorboard") is False:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional, as in JAX
            return
        self.writer = SummaryWriter(str(self.log_dir))

    def build_state(self) -> TrainState:
        """The model of ``cfg``, seeded from ``train.seed``, pipelined or
        sharded over the model axis as ``train.mesh`` says, with its
        optimizer."""
        model = flagship.build_model(self.cfg["model"], self.device,
                                     seed=self.seed)
        group = self.model_group
        if self.microbatches:
            model.decoder = model.decoder.clone(
                pipeline=group or StageDevices([self.device]),
                pipeline_microbatches=self.microbatches,
                pipeline_batch_axis="data")
        if group is not None and not self.model_spans:
            shard_module(model, group, skip=("decoder.denoise_fn",)
                         if self.microbatches else ())
        return TrainState(
            model, lr=select(self.cfg, "optimizer.lr", 1e-3),
            warmup_steps=select(self.cfg, "train.lr_scheduler.warmup_steps",
                                4000),
            betas=tuple(select(self.cfg, "optimizer.betas", (0.9, 0.98))),
            weight_decay=select(self.cfg, "optimizer.weight_decay", 0.0),
            seed=self.seed, bf16=bool(select(self.cfg, "train.bf16")
                                      or select(self.cfg, "train.fp16")),
            data=self.data, model_group=group)

    def batches(self, ds, shuffle: bool) -> ShuffleBatchSampler:
        """The batch sampler of ``ds`` (``dataset.dynamic_batch``: token
        buckets of ``dataset.max_tokens`` in multiples of the batch
        multiple, only the divisible ones kept where any is; else
        ``train.batch_size``)."""
        mult = self.batch_multiple
        if select(self.cfg, "dataset.dynamic_batch", True):
            batches = batch_by_size(
                ds.ordered_indices(), ds.num_tokens,
                max_tokens=select(self.cfg, "dataset.max_tokens", 10000),
                required_batch_size_multiple=mult)
            batches = [b for b in batches if len(b) % mult == 0] or batches
        else:
            bs = select(self.cfg, "train.batch_size", 32)
            idx = list(range(len(ds)))
            batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        return ShuffleBatchSampler(batches, shuffle=shuffle, seed=self.seed)

    def _rank_batches(self, sampler, ds):
        """This rank's entries of ``sampler`` (``host_batches``: the
        global batch's buckets, the prompts padded to its longest's, rows
        padded to a multiple of the batch multiple, the same rows on every
        rank of a model group), or ``sampler`` itself in one process
        without microbatches."""
        if self.batch_multiple == 1:
            return sampler
        if not hasattr(ds, "item_meta"):
            raise ValueError("data parallelism and pipeline microbatches "
                             "need a dataset with item_meta and "
                             "load_item_features")
        return host_batches(sampler, ds, rank=self.data.rank if self.data
                            else 0, world=self.n_data, prompt_pad_to=None,
                            row_multiple=self.batch_multiple)

    def _barrier(self):
        if self.data is not None:
            dist.barrier(device_ids=[self.device.index]
                         if self.device.type == "cuda" else None)

    def _save(self, name: str, state: TrainState, epoch: int):
        """Rank 0 writes ``ckpt/<name>`` (a sharded model's ranks all join
        its tensors); every rank waits for it."""
        if self.is_main or ckpt_lib.is_sharded(state):
            ckpt_lib.save_checkpoint(self.ckpt_dir / name, state, epoch,
                                     write=self.is_main)
        self._barrier()

    # --------------------------------------------------------------- run
    def run(self, num_epochs: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        self._setup_logging()
        self._build_datasets()
        self.state = state = self.build_state()
        self.model_keys = model_batch_keys(state.model)
        n_params = sum(p.numel() for p in state.params)
        self.logger.info(f"number of trainable params: {n_params / 1e6:.3f}"
                         f" M on {self.device}"
                         + (", bf16" if state.shadow is not None else "")
                         + (f", rank {self.rank} of {self.world}"
                            if self.data is not None else "")
                         + (f", model axis {self.model_group.world}"
                            if self.model_group is not None else "")
                         + (f", {self.microbatches} pipeline microbatches"
                            if self.microbatches else ""))
        start_epoch = 1
        if cfg.get("ckpt_path"):
            last = ckpt_lib.restore_checkpoint(cfg["ckpt_path"], state)
            start_epoch = last + 1
            self.logger.info(f"resumed from {cfg['ckpt_path']} at epoch "
                             f"{last}")
        elif cfg.get("pretrained"):
            ckpt_lib.load_pretrained(cfg["pretrained"], state)
            self.logger.info(f"warm start from {cfg['pretrained']}")
        if self.data is not None:
            self.data.broadcast_module(state.model)
        num_epochs = num_epochs or select(cfg, "train.num_epochs", 1000)
        try:
            self._train_loop(state, start_epoch, num_epochs)
        except Exception:
            if not self.is_main:
                raise
            if ckpt_lib.is_sharded(state):
                # the whole tensors need every rank of the model group
                self.logger.exception("training failed; no emergency "
                                      "checkpoint of a sharded model")
                raise
            try:
                ckpt_lib.save_checkpoint(self.ckpt_dir / "crash", state,
                                         epoch=-1)
                self.logger.exception("training failed; emergency "
                                      f"checkpoint -> {self.ckpt_dir / 'crash'}")
            except Exception:  # the original error is what matters
                self.logger.exception("emergency checkpoint also failed")
            raise
        finally:
            if self.writer is not None:
                self.writer.close()
        return state

    def _profile(self, global_step: int):
        """Start the profiler before update ``train.profile_steps``, stop
        and export it after three updates."""
        first = select(self.cfg, "train.profile_steps", 0)
        if not first or not self.is_main:
            return
        if global_step == first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.profile = profile(activities=acts)
            self.profile.__enter__()
            self._profile_t0 = time.perf_counter()
        elif global_step == first + 3 and self.profile is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.profile_wall_s = time.perf_counter() - self._profile_t0
            self.profile.__exit__(None, None, None)
            out = self.log_dir / "profile"
            out.mkdir(parents=True, exist_ok=True)
            self.profile.export_chrome_trace(str(out / "trace.json"))
            self.logger.info(f"profile of updates {first}..{first + 2} -> "
                             f"{out / 'trace.json'}")

    def input_pipeline(self) -> str:
        """The input pipeline of ``cfg`` (see the module docstring); the C++
        loader is built here when the pipeline needs it."""
        cfg = self.cfg
        pipeline = select(cfg, "train.input_pipeline")
        if pipeline is None:
            if select(cfg, "train.prefetch") is not None:
                pipeline = "prefetch" if select(cfg, "train.prefetch") \
                    else "sync"
            else:
                pipeline = auto_input_pipeline(self.train_ds)
                self.logger.info(f"input pipeline auto-selected: {pipeline} "
                                 f"({os.cpu_count()} host cores)")
        if pipeline == "sync_native" and not _has_meta(self.train_ds):
            raise ValueError("train.input_pipeline=sync_native needs a "
                             "dataset with item_meta and stats")
        if pipeline == "sync_native" or (pipeline == "prefetch"
                                         and _has_meta(self.train_ds)):
            try:
                native_loader.library()
            except RuntimeError as e:
                raise RuntimeError(
                    f"input pipeline {pipeline!r} reads features with the "
                    "C++ loader, which did not build; set "
                    "train.input_pipeline=sync to assemble batches in "
                    "Python") from e
        return pipeline

    def _sync_batches(self, sampler, collator, native: bool = False,
                      ds=None):
        """Inline assembly of ``ds``'s (default: the training set's)
        batches, each built when it is due, with the C++ loader under
        ``native``; -> (host batch, device batch)."""
        ds = self.train_ds if ds is None else ds
        for entry in sampler:
            if isinstance(entry, tuple) or native:
                metas, kwargs, padding = entry_metas(ds, entry,
                                                     collator.tokenizer)
                if native:
                    batch = _collate_native(metas, collator, ds.stats,
                                            **kwargs)
                else:
                    batch = collator([ds.load_item_features(m)
                                      for m in metas], **kwargs)
                batch = finish(batch, padding)
            else:
                batch = collator([ds[i] for i in entry])
            yield batch, to_device(batch, self.device, self.model_keys)

    def _train_loop(self, state: TrainState, start_epoch: int,
                    num_epochs: int):
        cfg = self.cfg
        collator = PromptTTSCollator(tokenizer=self.tokenizer)
        sampler = self.batches(self.train_ds, shuffle=True)
        save_interval = select(cfg, "train.save_interval", 20)
        host_sync_every = select(cfg, "train.host_sync_every", 64)
        pipeline = self.input_pipeline()
        tracker = Tracker(str(self.log_dir / "loss.csv")
                          if self.is_main else None)
        global_step = state.step
        for epoch in range(start_epoch, num_epochs + 1):
            sampler.set_epoch(epoch)
            for ds in (self.train_ds, self.valid_ds):
                if hasattr(ds, "set_epoch"):
                    ds.set_epoch(epoch)
            tracker.reset()
            t0 = time.perf_counter()
            n_frames, n_steps, sums = 0, 0, None
            epoch_sampler = self._rank_batches(sampler, self.train_ds)
            if pipeline == "prefetch":
                loader = prefetch_batches(
                    self.train_ds, epoch_sampler, collator,
                    model_keys=self.model_keys, device=self.device,
                    num_workers=select(cfg, "train.num_workers", 8),
                    prefetch_depth=select(cfg, "train.prefetch_depth", 3))
            else:
                loader = self._sync_batches(
                    epoch_sampler, collator, native=pipeline == "sync_native")
            with contextlib.closing(loader):  # stops a prefetch on a fault
                for batch, device_batch in loader:
                    n_frames += int(np.sum(batch["frame_lengths"]
                                           * (batch["batch_weight"] > 0)))
                    self._profile(global_step)
                    metrics = state.train_step(device_batch)
                    if host_sync_every and \
                            n_steps % host_sync_every == host_sync_every - 1:
                        metrics["loss"].item()  # bounds the run-ahead
                    sums = metrics if sums is None else {
                        k: sums[k] + v for k, v in metrics.items()}
                    global_step += 1
                    n_steps += 1
            self._profile(global_step)
            if sums is not None:
                vals = torch.stack(list(sums.values())).tolist()
                tracker.update({k: v / n_steps
                                for k, v in zip(sums, vals)})
            if self.data is not None:  # every rank's real frames
                n_frames = int(self.data.total(torch.tensor(
                    [n_frames], dtype=torch.float64,
                    device=self.device)).item())
            dt = time.perf_counter() - t0
            avgs = tracker.averages()
            fps = n_frames / max(dt, 1e-9)
            self.logger.info(
                f"epoch {epoch}: "
                + ", ".join(f"{k}={v:.4f}" for k, v in avgs.items())
                + f", frames/s={fps:.1f}")
            if self.writer is not None:
                for k, v in avgs.items():
                    self.writer.add_scalar(f"train/{k}", v, global_step)
                self.writer.add_scalar("perf/frames_per_sec", fps,
                                       global_step)
            if self.valid_ds is not None:
                self._validate(state, collator, epoch, global_step)
            self._save("last", state, epoch)
            if epoch % save_interval == 0:
                self._save(f"epoch-{epoch:04d}", state, epoch)
            tracker.write(epoch)

    def _validate(self, state, collator, epoch: int, global_step: int):
        """The validation losses on the running statistics; under data
        parallelism each rank evaluates its rows of every global batch,
        padded as the training batches are, and the losses are the global
        batch's."""
        vtracker = Tracker()
        sampler = self._rank_batches(
            self.batches(self.valid_ds, shuffle=False), self.valid_ds)
        for _, device_batch in self._sync_batches(sampler, collator,
                                                  ds=self.valid_ds):
            out = state.eval_step(device_batch)
            vals = dict(zip(out, torch.stack(list(out.values())).tolist()))
            vtracker.update(vals)
            if self.writer is not None:
                for k, v in vals.items():
                    self.writer.add_scalar(f"valid/{k}", v, global_step)
        self.logger.info(f"epoch {epoch} valid: " + ", ".join(
            f"{k}={v:.4f}" for k, v in vtracker.averages().items()))
