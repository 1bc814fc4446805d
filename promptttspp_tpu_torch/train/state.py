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
- ``bf16=True`` is ``make_train_step(bf16=True)``: the forward and backward
  run on bfloat16 copies of every parameter (the frozen BERT's too) and of
  every float leaf of the batch, with float32 masters. The copies are a
  persistent shadow of the model (``bf16_shadow``) whose buffers (the
  BatchNorm statistics) are the masters' own, so the statistics stay
  float32. Each update refreshes the shadow's trainable parameters from the
  masters with one multi-tensor copy (the frozen ones at the first update
  only), and copies the bf16 gradients into float32 ones the same way:
  JAX's gradient through ``astype`` is ``astype`` of the gradient, so this
  is its arithmetic. Clip, AdamW and the norm then run on float32 as
  without it. Which operations compute in bf16 follows JAX's promotion
  (``nn/layers.py::promoted``): most of the model computes in float32 with
  bf16-rounded weights. No loss scaling, as in JAX. Evaluation reads the
  float32 masters.
- ``data`` (a ``parallel/distributed.py::DataGroup``): data parallelism.
  Each rank's batch is its block of a global batch; the model's losses
  are its rows' share of the global ones (global normalizers and BatchNorm
  statistics, draws at the global shape from the same generator on every
  rank: ``models/prompttts.py``). After the backward (and, under bf16, the
  copy to the float32 gradients) one float32 SUM over the ranks of the
  trainable gradients, in a few flat buckets, makes them the global
  batch's gradient, so clip, AdamW and the norm agree on every rank; the
  reported losses are summed over the ranks too. The frozen BERT weights
  are not reduced.
- ``model_group`` (a ``parallel/distributed.py::ModelGroup``): the model
  axis. Under tensor parallelism (``parallel/tp.py::shard_module``, before
  the state is made) each rank holds its slices of the sharded
  parameters, and AdamW's moments follow them; the clip's global norm sums
  the squares of the sharded gradients over the group and counts the
  replicated ones once. Under pipeline parallelism over the group
  (``parallel/pp.py``) every rank holds the whole DiffNet but computes the
  gradients of its own stage's blocks only; those are summed over the
  group before the data axis's sum. Every other gradient is the same on
  each rank of the group but for the card's non-deterministic backward
  (atomic sums), so it is averaged over the group, in the same
  collective: the replicated parameters then stay equal on every rank.
- Spans (``utils/trace.py``, recorded only while a profiler runs or inside
  ``trace.recording()``), each carrying ``step``: ``train.step`` around
  the update, inside it ``train.forward`` (the generator, ``zero_grad`` or
  the shadow's refresh, the forward pass), ``train.backward`` (the
  backward pass, the gradients of unused parameters) and
  ``train.optimizer`` (``_update``: reductions, norm, clip, AdamW).
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.models.diffusion import float32_math
from promptttspp_tpu_torch.train.schedule import noam_schedule
from promptttspp_tpu_torch.utils import trace

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


def bf16_shadow(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose floating parameters are bfloat16 copies
    (``requires_grad`` as the originals') and whose buffers are
    ``model``'s own tensors."""
    shadow = copy.deepcopy(model)
    for src, dst in zip(model.modules(), shadow.modules()):
        for name, buf in src.named_buffers(recurse=False):
            dst._buffers[name] = buf
        for name, p in src.named_parameters(recurse=False):
            if p.is_floating_point():
                # setattr, so an RNN's flat weight list follows
                setattr(dst, name, torch.nn.Parameter(
                    p.detach().to(torch.bfloat16),
                    requires_grad=p.requires_grad))
    return shadow


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax's
    ``global_norm`` (in a few multi-tensor launches: each tensor's norm,
    then the norm of those)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    """``model`` (a ``PromptTTSMDNDurCFG``) with AdamW over its trainable
    parameters. ``step`` counts the updates made. ``bf16`` computes the
    updates in bfloat16 on a shadow of the model (see the module
    docstring)."""

    def __init__(self, model: torch.nn.Module, lr: float = 1e-3,
                 warmup_steps: int = 4000,
                 betas: Tuple[float, float] = (0.9, 0.98),
                 weight_decay: float = 0.0, grad_clip: float = 1.0,
                 seed: int = 42, bf16: bool = False, data=None,
                 model_group=None):
        self.model = model
        self.seed = seed
        self.data = data
        self.model_group = model_group
        self.grad_clip = grad_clip
        self.schedule = noam_schedule(lr, warmup_steps)
        self.step = 0
        named = dict(model.named_parameters())
        trainable = bert_trainable(named)
        for name, p in named.items():
            p.requires_grad_(name in trainable)
        self.trainable = trainable
        self.params = [named[n] for n in trainable]
        shards = getattr(model, "tp_shards", None) or {}
        self._sharded = {i for i, n in enumerate(trainable) if n in shards}
        pipeline = getattr(getattr(model, "decoder", None), "pipeline", None)
        self._stage = []  # the gradients each pipeline stage holds its own of
        if model_group is not None and pipeline is model_group:
            self._stage = [i for i, n in enumerate(trainable) if n.startswith(
                "decoder.denoise_fn.residual_layers.")]
        self._replicated = [] if model_group is None else [
            i for i in range(len(trainable))
            if i not in self._sharded and i not in self._stage]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(betas), eps=1e-8,
            weight_decay=weight_decay)
        self.shadow = bf16_shadow(model) if bf16 else None
        if bf16:
            shadow = dict(self.shadow.named_parameters())
            self.shadow_params = [shadow[n] for n in trainable]
            frozen = [n for n in named if n not in trainable
                      and named[n].is_floating_point()]
            self._frozen = ([named[n] for n in frozen],
                            [shadow[n] for n in frozen])
            self._grads = [torch.zeros_like(p) for p in self.params]

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (tensors on the model's device) -> the
        losses and the gradients' global norm before clipping, as 0-dim
        float32 tensors (read them without syncing each step)."""
        step = self.step
        with trace.span("train.step", step):
            if self.shadow is not None:
                return self._bf16_step(batch)
            with trace.span("train.forward", step):
                self.model.train()
                g = step_generator(self.seed, step, self.device)
                self.optimizer.zero_grad(set_to_none=True)
                with float32_math():
                    losses = self.model(batch, generator=g, data=self.data)
            with trace.span("train.backward", step):
                with float32_math():
                    losses["loss"].backward()
                for p in self.params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            with trace.span("train.optimizer", step):
                return self._update(losses)

    def _bf16_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        step = self.step
        with trace.span("train.forward", step):
            with torch.no_grad():
                if self._frozen is not None:
                    # at the first update, so a restored or warm-started
                    # model's frozen weights are the ones cast
                    torch._foreach_copy_(self._frozen[1], self._frozen[0])
                    self._frozen = None
                torch._foreach_copy_(self.shadow_params, self.params)
            batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                     for k, v in batch.items()}
            self.shadow.train()
            g = step_generator(self.seed, step, self.device)
            for p in self.shadow_params:
                p.grad = None
            with float32_math():
                losses = self.shadow(batch, generator=g, data=self.data)
        with trace.span("train.backward", step):
            with float32_math():
                losses["loss"].float().backward()
            pairs = [(g, p.grad) for g, p in
                     zip(self._grads, self.shadow_params)
                     if p.grad is not None]
            torch._foreach_copy_([g for g, _ in pairs],
                                 [s for _, s in pairs])
            unused = [g for g, p in zip(self._grads, self.shadow_params)
                      if p.grad is None]
            if unused:  # JAX's gradient tree has zeros there
                torch._foreach_zero_(unused)
            for p, grad in zip(self.params, self._grads):
                p.grad = grad
        with trace.span("train.optimizer", step):
            return self._update({k: v.float() for k, v in losses.items()})

    def _update(self, losses: Dict) -> Dict[str, torch.Tensor]:
        """Clip the trainable parameters' gradients by their global norm,
        step AdamW at this update's rate; under data parallelism the
        gradients and losses are summed over the ranks first."""
        grads = [p.grad for p in self.params]
        if self.model_group is not None:
            self.model_group.reduce_grads(
                [grads[i] for i in self._stage + self._replicated])
            torch._foreach_mul_([grads[i] for i in self._replicated],
                                1.0 / self.model_group.world)
        if self.data is not None:
            self.data.reduce_grads(grads)
            losses = self._total(losses)
        norm = self._global_norm(grads)
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

    def _global_norm(self, grads) -> torch.Tensor:
        """The global norm of the (whole) gradients: the sharded ones'
        squares summed over the model group, the replicated ones once."""
        if not self._sharded:
            return global_norm(grads)
        sq = [torch.stack(torch._foreach_norm(part)).square().sum()
              for part in ([g for i, g in enumerate(grads)
                            if i not in self._sharded],
                           [grads[i] for i in sorted(self._sharded)])]
        return torch.sqrt(sq[0] + self.model_group.total(sq[1]))

    def _total(self, losses: Dict) -> Dict[str, torch.Tensor]:
        """``losses`` summed over the ranks, in one collective."""
        return dict(zip(losses, self.data.total(
            torch.stack([v.detach() for v in losses.values()]))))

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The losses of ``batch`` on the running statistics, no dropout;
        the diffusion steps and noise drawn from (seed + 1, step, 1)."""
        self.model.eval()
        g = step_generator(self.seed, self.step, self.device, stream=1)
        with float32_math():
            out = {k: v.detach() for k, v in
                   self.model(batch, generator=g, data=self.data).items()}
        return out if self.data is None else self._total(out)
