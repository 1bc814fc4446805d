"""Single-GPU training of the acoustic model.

Counterpart of ``promptttspp_tpu/train/trainer.py::TTSTrainer``: the model,
the optimizer and the data from the ``train`` config (``bin/conf.py``), the
epoch loop over token-bucketed batches (``dataset.dynamic_batch``, or a
fixed ``train.batch_size``) shuffled per epoch as a function of (seed,
epoch), validation on the running statistics, and the JAX trainer's
records: ``logs/train.log``, ``logs/loss.csv`` (one row per epoch), the
config snapshot ``config.yaml`` (JSON, which YAML reads), TensorBoard
scalars when ``torch.utils.tensorboard`` is installed, checkpoints
``ckpt/last`` every epoch and ``ckpt/epoch-NNNN`` every
``train.save_interval``, ``ckpt/crash`` on a failure, resume
(``ckpt_path``) and warm start (``pretrained``). ``train.profile_steps=N``
traces updates N .. N+2 with ``torch.profiler`` into ``logs/profile/``.

Batches are assembled inline on the host, one after the other. The port
raises, naming the key, on what it does not implement: half precision
(``train.bf16``/``train.fp16``), more than one process, a model-parallel
or pipelined mesh, the XLA compilation cache, the prefetching and native
input pipelines, and the per-epoch scheduler.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.data.batching import (
    ShuffleBatchSampler, batch_by_size)
from promptttspp_tpu_torch.data.collate import PromptTTSCollator
from promptttspp_tpu_torch.data.dataset import AllWithSpkPromptNormDataset
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.train import checkpoint as ckpt_lib
from promptttspp_tpu_torch.train.state import TrainState
from promptttspp_tpu_torch.train.tracker import Tracker

MODEL_BATCH_KEYS = (
    "phoneme", "duration", "phone_lengths", "mel", "log_cf0", "vuv",
    "frame_lengths", "prompt_ids", "prompt_mask", "batch_weight",
    "diffusion_t", "diffusion_noise",
)


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
        "train.bf16": "half precision is not ported",
        "train.fp16": "half precision is not ported",
        "train.mesh.pipeline_microbatches": "pipeline parallelism is not "
                                            "ported",
        "train.mesh.model_spans_processes": "more than one process is not "
                                            "ported",
        "train.distributed.coordinator_address": "more than one process is "
                                                 "not ported",
        "train.compilation_cache_dir": "the XLA compilation cache has no "
                                       "counterpart in the port",
        "train.prefetch": "the prefetching input pipeline is not ported",
        "train.per_epoch_scheduler": "the per-epoch scheduler is not ported",
    }
    for key, why in refused.items():
        if select(cfg, key):
            raise ValueError(f"{key}={select(cfg, key)!r}: {why}")
    if (select(cfg, "train.distributed.num_processes") or 1) > 1:
        raise ValueError("train.distributed.num_processes > 1: more than "
                         "one process is not ported")
    if (select(cfg, "train.mesh.model") or 1) > 1:
        raise ValueError("train.mesh.model > 1: model parallelism is not "
                         "ported")
    pipeline = select(cfg, "train.input_pipeline")
    if pipeline not in (None, "sync"):
        raise ValueError(f"train.input_pipeline={pipeline!r}: the port "
                         "assembles batches inline ('sync') only")


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's keys of a collated batch as tensors on ``device``
    (integers as int64)."""
    out = {}
    for k in MODEL_BATCH_KEYS:
        if k in batch:
            a = np.asarray(batch[k])
            t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                                 else a)
            out[k] = t.to(device)
    return out


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
        self.output_dir = Path(cfg.get("output_dir", "./out"))
        self.log_dir = self.output_dir / "logs"
        self.ckpt_dir = self.output_dir / "ckpt"
        self.seed = select(cfg, "train.seed", 42)
        self.state: Optional[TrainState] = None
        self.profile = None  # the torch.profiler of train.profile_steps

    # ------------------------------------------------------------- setup
    def _build_datasets(self):
        if self.train_ds is None:
            self.train_ds = AllWithSpkPromptNormDataset(
                **self.cfg["dataset"]["train"])
        if select(self.cfg, "dataset.valid"):
            self.valid_ds = AllWithSpkPromptNormDataset(
                **self.cfg["dataset"]["valid"])

    def _setup_logging(self):
        for d in (self.output_dir, self.log_dir, self.ckpt_dir):
            d.mkdir(parents=True, exist_ok=True)
        snapshot = {k: v for k, v in self.cfg.items() if k != "hydra"}
        (self.output_dir / "config.yaml").write_text(
            json.dumps(snapshot, indent=2, default=str) + "\n")
        logger = logging.getLogger("promptttspp_tpu_torch.train")
        logger.setLevel(logging.INFO)
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
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional, as in JAX
            self.writer = None
        else:
            self.writer = SummaryWriter(str(self.log_dir))

    def build_state(self) -> TrainState:
        """The model of ``cfg``, seeded from ``train.seed``, with its
        optimizer."""
        model = flagship.build_model(self.cfg["model"], self.device,
                                     seed=self.seed)
        return TrainState(
            model, lr=select(self.cfg, "optimizer.lr", 1e-3),
            warmup_steps=select(self.cfg, "train.lr_scheduler.warmup_steps",
                                4000),
            betas=tuple(select(self.cfg, "optimizer.betas", (0.9, 0.98))),
            weight_decay=select(self.cfg, "optimizer.weight_decay", 0.0),
            seed=self.seed)

    def batches(self, ds, shuffle: bool) -> ShuffleBatchSampler:
        """The batch sampler of ``ds`` (``dataset.dynamic_batch``: token
        buckets of ``dataset.max_tokens``; else ``train.batch_size``)."""
        if select(self.cfg, "dataset.dynamic_batch", True):
            batches = batch_by_size(
                ds.ordered_indices(), ds.num_tokens,
                max_tokens=select(self.cfg, "dataset.max_tokens", 10000))
        else:
            bs = select(self.cfg, "train.batch_size", 32)
            idx = list(range(len(ds)))
            batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        return ShuffleBatchSampler(batches, shuffle=shuffle, seed=self.seed)

    # --------------------------------------------------------------- run
    def run(self, num_epochs: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        self._setup_logging()
        self._build_datasets()
        self.state = state = self.build_state()
        n_params = sum(p.numel() for p in state.params)
        self.logger.info(f"number of trainable params: {n_params / 1e6:.3f}"
                         f" M on {self.device}; batches assembled inline")
        start_epoch = 1
        if cfg.get("ckpt_path"):
            last = ckpt_lib.restore_checkpoint(cfg["ckpt_path"], state)
            start_epoch = last + 1
            self.logger.info(f"resumed from {cfg['ckpt_path']} at epoch "
                             f"{last}")
        elif cfg.get("pretrained"):
            ckpt_lib.load_pretrained(cfg["pretrained"], state)
            self.logger.info(f"warm start from {cfg['pretrained']}")
        num_epochs = num_epochs or select(cfg, "train.num_epochs", 1000)
        try:
            self._train_loop(state, start_epoch, num_epochs)
        except Exception:
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
        if not first:
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

    def _train_loop(self, state: TrainState, start_epoch: int,
                    num_epochs: int):
        cfg = self.cfg
        collator = PromptTTSCollator(tokenizer=self.tokenizer)
        sampler = self.batches(self.train_ds, shuffle=True)
        save_interval = select(cfg, "train.save_interval", 20)
        tracker = Tracker(str(self.log_dir / "loss.csv"))
        global_step = state.step
        for epoch in range(start_epoch, num_epochs + 1):
            sampler.set_epoch(epoch)
            for ds in (self.train_ds, self.valid_ds):
                if hasattr(ds, "set_epoch"):
                    ds.set_epoch(epoch)
            tracker.reset()
            t0 = time.perf_counter()
            n_frames, n_steps, sums = 0, 0, None
            for idx in sampler:
                batch = collator([self.train_ds[i] for i in idx])
                n_frames += int(np.sum(batch["frame_lengths"]))
                self._profile(global_step)
                metrics = state.train_step(to_device(batch, self.device))
                sums = metrics if sums is None else {
                    k: sums[k] + v for k, v in metrics.items()}
                global_step += 1
                n_steps += 1
            self._profile(global_step)
            if sums is not None:
                vals = torch.stack(list(sums.values())).tolist()
                tracker.update({k: v / n_steps
                                for k, v in zip(sums, vals)})
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
            ckpt_lib.save_checkpoint(self.ckpt_dir / "last", state, epoch)
            if epoch % save_interval == 0:
                ckpt_lib.save_checkpoint(
                    self.ckpt_dir / f"epoch-{epoch:04d}", state, epoch)
            tracker.write(epoch)

    def _validate(self, state, collator, epoch: int, global_step: int):
        vtracker = Tracker()
        for idx in self.batches(self.valid_ds, shuffle=False):
            batch = collator([self.valid_ds[i] for i in idx])
            out = state.eval_step(to_device(batch, self.device))
            vals = dict(zip(out, torch.stack(list(out.values())).tolist()))
            vtracker.update(vals)
            if self.writer is not None:
                for k, v in vals.items():
                    self.writer.add_scalar(f"valid/{k}", v, global_step)
        self.logger.info(f"epoch {epoch} valid: " + ", ".join(
            f"{k}={v:.4f}" for k, v in vtracker.averages().items()))
