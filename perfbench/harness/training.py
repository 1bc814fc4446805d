"""What the training cells share: the corpus's place, the trainer's
configuration from the cell's, and the readings of the first updates that
the check compares with the reference's.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

# the batch keys the model reads (the port's trainer's MODEL_BATCH_KEYS)
MODEL_BATCH_KEYS = (
    "phoneme", "duration", "phone_lengths", "mel", "log_cf0", "vuv",
    "frame_lengths", "prompt_ids", "prompt_mask", "batch_weight",
    "diffusion_t", "diffusion_noise",
)


def corpus_root() -> Path:
    """A fixed directory under the run's TMPDIR."""
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    return Path(base) / "perfbench_train_corpus"


def trainer_config(cfg: Dict, device: str, out_dir: Path) -> Dict:
    """The port trainer's configuration of the cell's: the model, AdamW,
    the Noam warm-up, the token buckets, the input pipeline."""
    return dict(model=cfg["model"], optimizer=dict(cfg["optimizer"]),
                train=dict(cfg["train"]), dataset=dict(cfg["dataset"]),
                device=device, output_dir=str(out_dir))


@torch.no_grad()
def first_gradient(params: List[torch.Tensor], names: List[str],
                   optimizer) -> Dict[str, float]:
    """Each leaf's norm of the gradient AdamW took at its first update:
    its first moment over (1 - beta1); 0 where AdamW holds none."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    moments = [optimizer.state.get(p, {}).get("exp_avg", torch.zeros(1))
               .to(p.device) for p in params]
    norms = torch.stack(torch._foreach_norm(moments)) / (1.0 - beta1)
    return dict(zip(names, norms.tolist()))


@torch.no_grad()
def change(params: List[torch.Tensor], before: List[torch.Tensor],
           names: List[str]) -> Dict[str, float]:
    """Each leaf's norm of its change from ``before``."""
    diffs = torch._foreach_sub(list(params), list(before))
    norms = torch.stack(torch._foreach_norm(diffs))
    return dict(zip(names, norms.tolist()))
