"""Train the acoustic model with the port, on one GPU or data-parallel over
several.

Counterpart of ``egs/proposed/bin/train.py``, with its command line (the
``train`` config of ``bin/conf.py``: ``conf/train.yaml`` and its groups)::

    python3 -m promptttspp_tpu_torch.bin.train path.root=<corpus root> \\
        [output_dir=./out] [dataset.max_tokens=10000] \\
        [train.num_epochs=1000] [train.save_interval=20] [train.seed=42] \\
        [train.lr_scheduler.warmup_steps=4000] [optimizer.lr=0.001] \\
        [ckpt_path=<ckpt/last>] [pretrained=<model.ckpt>] \\
        [train.bf16=true] [+train.input_pipeline=sync|sync_native|prefetch] \\
        [train.num_workers=8] [+train.prefetch_depth=3] \\
        [+train.host_sync_every=64] [+train.profile_steps=N] [device=cpu] \\
        [+train.distributed.num_processes=N] \\
        [+train.distributed.process_id=P] \\
        [+train.distributed.coordinator_address=host:port] \\
        [+train.distributed.backend=nccl|gloo] [+train.mesh.model=M] \\
        [+train.mesh.pipeline_microbatches=P] \\
        [+train.mesh.model_spans_processes=true]

It runs on ``cuda``; ``device=cpu`` runs it on the CPU. It reads the
train/valid CSVs, features and prompt candidates under ``path.root``
(``tools/synthetic_corpus.py::write_training_corpus`` writes a stand-in)
and ``path.bert_vocab_file``. As in JAX, the working directory becomes
``hydra.run.dir`` first (``./out/hydra/train``), so a relative
``output_dir`` lands inside it. Checkpoints (``<output_dir>/ckpt/last``)
are served by ``bin/synthesize.py model_ckpt=...``. ``train.bf16=true``
(or its alias ``train.fp16=true``) trains in bfloat16 with float32 master
weights, as JAX does; without ``train.input_pipeline`` the pipeline is
chosen for the host as JAX chooses it (``train/trainer.py``).

Several processes, one per GPU, train data-parallel on one global batch
(``parallel/distributed.py``), as JAX's trainer uses every chip of its host
and the reference spawns one DDP worker per GPU:

- under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``), or with
  ``train.distributed.process_id`` (and ``num_processes`` and
  ``coordinator_address``), this process joins that group;
- otherwise, with ``train.distributed.num_processes`` above 1, or without
  it and with more than one visible GPU on ``cuda`` or a model axis, it
  spawns one worker per process on this host (without the key: one per
  GPU, rounded down to a multiple of ``train.mesh.model`` and at least
  one model group), joined at ``train.distributed.coordinator_address`` or
  a free local port, and returns None when they are done;
- otherwise (``train.distributed.num_processes=1`` on any machine) it
  trains in this process.

The backend is NCCL on a GPU (one GPU per rank) and gloo on the CPU;
``train.distributed.backend=gloo`` runs several ranks on one GPU.

The model axis: ``+train.mesh.model=M`` splits the processes into data
shards of M ranks that share their rows and shard the model (tensor
parallelism); ``+train.mesh.pipeline_microbatches=P`` pipelines the
DiffNet over those M ranks in P microbatches instead;
``+train.mesh.model_spans_processes=true`` folds the model axis across the
data shards, as JAX's mesh does (``train/trainer.py``).
"""

from __future__ import annotations

import os
import socket
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.train.trainer import TTSTrainer, select


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_processes(cfg) -> int:
    """How many local workers to spawn: 0 to join a configured group, or
    to train in this process."""
    if "RANK" in os.environ or select(cfg, "train.distributed.process_id") \
            is not None:
        return 0
    n = select(cfg, "train.distributed.num_processes")
    if n is None:
        n = 1
        if torch.device(cfg.get("device", "cuda")).type == "cuda" \
                and torch.cuda.is_available():
            n = torch.cuda.device_count()
        model = select(cfg, "train.mesh.model") or 1
        n = model * max(1, n // model)
    return int(n) if int(n) > 1 else 0


def _worker(rank: int, argv: List[str], world: int, address: str):
    """One spawned rank: torchrun's environment, then the CLI."""
    host, port = address.rsplit(":", 1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR=host,
                      MASTER_PORT=port)
    main(argv)


def main(argv: Optional[Sequence[str]] = None) -> Optional[TTSTrainer]:
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``); returns the
    trainer after its last epoch (None after spawned workers)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = conf.compose("train", argv)
    n = _spawned_processes(cfg)
    if n:
        import torch.multiprocessing as mp

        address = select(cfg, "train.distributed.coordinator_address") \
            or f"localhost:{free_port()}"
        address = address.split("://")[-1]
        mp.spawn(_worker, args=(argv, n, address), nprocs=n, join=True)
        return None
    conf.enter_run_dir(cfg)
    vocab = cfg["path"]["bert_vocab_file"]
    if not vocab or not Path(vocab).exists():
        raise FileNotFoundError(f"path.bert_vocab_file={vocab!r} does not "
                                "exist: the prompts cannot be tokenized")
    joined = dist.is_initialized()
    trainer = TTSTrainer(cfg,
                         tokenizer=WordPieceTokenizer.from_vocab_file(vocab))
    try:
        trainer.run()
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
