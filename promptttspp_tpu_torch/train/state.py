"""The train state and its steps: the model, AdamW over its trainable
parameters, the Noam rate and the update count.

Counterpart of ``promptttspp_tpu/train/state.py`` (``bert_freeze_mask``,
``make_optimizer``, ``make_train_step``, ``make_eval_step``):

- The BERT freeze is structural, as in JAX: every parameter under
  ``prompt_encoder.bert`` but the last layer's attention (self-attention,
  its output projection and LayerNorm) gets ``requires_grad=False`` and
  stays out of the optimizer.
- Gradients are clipped by their global norm over the trainable parameters
  as ``optax.clip_by_global_norm`` does it (scaled by max_norm / norm where
  the norm reaches max_norm, with no epsilon, unlike torch's
  ``clip_grad_norm_``); a parameter that got no gradient gets a zero one,
  as JAX's gradient tree has.
- AdamW (eps 1e-8) with the config's betas and weight decay, its rate set
  before each update from ``schedule.noam_schedule`` as optax counts it.
- Each step draws (dropout masks, diffusion steps and noise) from its own
  generator, seeded from (seed + 1, step), so a resumed run draws what an
  uninterrupted one draws.
- Steps run in full float32 (``diffusion.float32_math``), so results do not
  depend on the TF32 flags.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.models.diffusion import float32_math
from promptttspp_tpu_torch.train.schedule import noam_schedule

_BERT_LAYER = re.compile(r"^prompt_encoder\.bert\.model\.encoder\.layer\.(\d+)\.")


def bert_trainable(names) -> List[str]:
    """The names among ``names`` that stay trainable under the BERT freeze:
    all outside ``prompt_encoder.bert``, and inside it the last layer's
    ``attention.*`` (the counterpart of JAX's ``bert_freeze_mask``)."""
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
    """sqrt of the sum of squares of every element, as optax's
    ``global_norm`` (in a few multi-tensor launches: each tensor's norm,
    then the norm of those)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    """``model`` (a ``PromptTTSMDNDurCFG``) with AdamW over its trainable
    parameters. ``step`` counts the updates made."""

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
        trainable = bert_trainable(named)
        for name, p in named.items():
            p.requires_grad_(name in trainable)
        self.trainable = trainable
        self.params = [named[n] for n in trainable]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(betas), eps=1e-8,
            weight_decay=weight_decay)

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (tensors on the model's device) -> the
        losses and the gradients' global norm before clipping, as 0-dim
        tensors (read them without syncing each step)."""
        self.model.train()
        g = step_generator(self.seed, self.step, self.device)
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

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The losses of ``batch`` on the running statistics, no dropout;
        the diffusion steps and noise drawn from (seed + 1, step, 1)."""
        self.model.eval()
        g = step_generator(self.seed, self.step, self.device, stream=1)
        with float32_math():
            return {k: v.detach() for k, v in
                    self.model(batch, generator=g).items()}
