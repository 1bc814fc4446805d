"""The training step: the model, AdamW over its trainable parameters, the
Noam rate and the update count (frozen copy of the port's
``train/state.py`` in one process and float32: no bf16 shadow, no data or
model group).

- The BERT freeze: every parameter under ``prompt_encoder.bert`` but the
  last layer's attention gets ``requires_grad=False`` and stays out of the
  optimizer.
- Gradients are clipped by their global norm (scaled by max_norm / norm
  where the norm reaches max_norm, no epsilon); a parameter that got no
  gradient gets a zero one.
- AdamW (eps 1e-8), its rate set before each update from
  ``schedule.noam_schedule``.
- Each step draws (dropout masks, diffusion steps and noise) from a
  generator seeded from (seed + 1, step).
- Steps run under ``models/diffusion.py::float32_math``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.ptts.models.diffusion import float32_math
from perfbench.reference.ptts.train.schedule import noam_schedule

_BERT_LAYER = re.compile(r"^prompt_encoder\.bert\.model\.encoder\.layer\.(\d+)\.")


def bert_trainable(names) -> List[str]:
    """The names among ``names`` that stay trainable under the BERT
    freeze: all outside ``prompt_encoder.bert``, and inside it the last
    layer's ``attention.*``."""
    names = list(names)
    layers = [int(m.group(1)) for n in names if (m := _BERT_LAYER.match(n))]
    keep = (f"prompt_encoder.bert.model.encoder.layer.{max(layers)}."
            "attention." if layers else None)
    return [n for n in names if not n.startswith("prompt_encoder.bert.")
            or (keep is not None and n.startswith(keep))]


def step_generator(seed: int, step: int, device, stream: int = 0):
    """A generator on ``device`` seeded from (seed + 1, step, stream)."""
    state = np.random.SeedSequence([seed + 1, step, stream])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    def __init__(self, model: torch.nn.Module, lr: float = 1e-3,
                 warmup_steps: int = 4000,
                 betas: Tuple[float, float] = (0.9, 0.98),
                 weight_decay: float = 0.0, grad_clip: float = 1.0,
                 seed: int = 42):
        self.model = model
        self.seed = seed
        self.grad_clip = grad_clip
        self.schedule = noam_schedule(lr, warmup_steps)
        self.step = 0
        named = dict(model.named_parameters())
        self.trainable = bert_trainable(named)
        for name, p in named.items():
            p.requires_grad_(name in self.trainable)
        self.params = [named[n] for n in self.trainable]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(betas), eps=1e-8,
            weight_decay=weight_decay)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` -> the losses and the gradients' global
        norm before clipping."""
        self.model.train()
        g = step_generator(self.seed, self.step, self.params[0].device)
        self.optimizer.zero_grad(set_to_none=True)
        with float32_math():
            losses = self.model(batch, generator=g)
            losses["loss"].backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        scale = torch.where(norm < self.grad_clip, 1.0,
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["grad_norm"] = norm.detach()
        return out
