"""Train the acoustic model with the port on one GPU.

Counterpart of ``egs/proposed/bin/train.py``, with its command line (the
``train`` config of ``bin/conf.py``: ``conf/train.yaml`` and its groups)::

    python3 -m promptttspp_tpu_torch.bin.train path.root=<corpus root> \\
        [output_dir=./out] [dataset.max_tokens=10000] \\
        [train.num_epochs=1000] [train.save_interval=20] [train.seed=42] \\
        [train.lr_scheduler.warmup_steps=4000] [optimizer.lr=0.001] \\
        [ckpt_path=<ckpt/last>] [pretrained=<model.ckpt>] \\
        [train.bf16=true] [+train.input_pipeline=sync|sync_native|prefetch] \\
        [train.num_workers=8] [+train.prefetch_depth=3] \\
        [+train.host_sync_every=64] [+train.profile_steps=N] [device=cpu]

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
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.train.trainer import TTSTrainer


def main(argv: Optional[Sequence[str]] = None) -> TTSTrainer:
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``); returns the
    trainer after its last epoch."""
    cfg = conf.compose("train", sys.argv[1:] if argv is None else argv)
    conf.enter_run_dir(cfg)
    vocab = cfg["path"]["bert_vocab_file"]
    if not vocab or not Path(vocab).exists():
        raise FileNotFoundError(f"path.bert_vocab_file={vocab!r} does not "
                                "exist: the prompts cannot be tokenized")
    trainer = TTSTrainer(cfg,
                         tokenizer=WordPieceTokenizer.from_vocab_file(vocab))
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
