"""Tensor parallelism over a model group: Megatron's column and row
sharding of the model's matrix products.

Counterpart of ``promptttspp_tpu/parallel/tp.py``. JAX places each
parameter with a ``PartitionSpec`` on the mesh's model axis
(``param_partition_spec``) and XLA inserts the collectives. The port
shards the same parameters, keyed on its ``state_dict`` names (JAX's
flax names map to them by ``compat/from_jax.py``), and places the
collectives by hand with the two conjugate functions of
``parallel/distributed.py::ModelGroup``:

- column (the product's outputs split; ``w_1`` of the three FFNs,
  ``linear_q/k/v/pos`` of the plain and relative attentions,
  BERT's ``query/key/value`` and ``intermediate.dense``, the DiffNet's
  ``mlp.0``, ``dilated_conv`` and ``conditioner_projection``, the prompt
  adaptor's ``adaptor.0``): the rank keeps its rows of the weight and the
  bias, and its input passes ``copy`` (identity; gradient summed), once
  for all the products that read it (an attention module's q, k and v;
  every DiffNet block's conditioner projection of ``cond``);
- row (the contraction split; ``w_2`` (a ``Conv1d`` or a ``Linear``),
  ``linear_out``, BERT's
  ``attention.output.dense`` and ``output.dense``, the DiffNet's
  ``mlp.2`` and its blocks' ``output_projection``): the rank keeps its
  columns of the weight, and its partial product passes ``reduce`` (sum;
  gradient unchanged) before the bias, which every rank holds whole;
- head (``pos_bias_u/v`` [heads, d_k]): the rank's heads, as its q/k/v.

Where the port differs from JAX's contiguous spec, ``Shard`` says so:

- gated (``dilated_conv``, ``conditioner_projection``, 2R outputs split
  into gate | filter): a contiguous cut would give one rank the gate and
  the other the filter, and GSPMD moves data to pair them. The port gives
  each rank the same part of the gate and of the filter (``interleave``
  2), so the gating stays local; the row-sharded ``output_projection``
  then reduces to the replicated residual | skip.
- gather (``adaptor.0``: a column whose successor ``adaptor.2`` is not
  sharded, where XLA gathers): the output is all-gathered, with
  gradient.

The attention modules then hold ``heads / world`` heads (the GST
attention keeps its scale, which counts every head), and the dropouts of
sharded activations (the FFN hidden, the attention weights) draw their
masks at the whole width and cut them, so a model group draws what one
process draws. A width or head count that does not divide raises, naming
it, and so does a product JAX's spec shards by its name that is not a
``Linear`` or ``Conv1d`` of a module ``shard_module`` knows (``_OWNERS``):
a model group never replicates what JAX shards. ``shard_module`` keeps
the names of the ``state_dict``;
``gather_state_dict`` and ``local_state_dict`` convert between the
sharded model's tensors and the whole ones of a checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from promptttspp_tpu_torch.models.bert import (
    BertIntermediate, BertOutput, BertSelfAttention, BertSelfOutput)
from promptttspp_tpu_torch.models.diffusion import DiffNet, ResidualBlock
from promptttspp_tpu_torch.nn.attention import (
    GSTCrossAttention, MultiHeadedAttention)
from promptttspp_tpu_torch.nn.conformer import (
    MultiLayeredConv1d, PositionwiseFeedForward)
from promptttspp_tpu_torch.nn.layers import (
    Conv1d, Linear, conv1d_btc, conv1d_same, promoted)
from promptttspp_tpu_torch.parallel.distributed import shard_of


class Shard(NamedTuple):
    """How one parameter is split over the model group: along ``dim`` of
    its torch layout, in ``interleave`` blocks (2: gated halves), for a
    module of ``kind`` "column", "gated", "gather", "row" or "head"."""
    dim: int
    kind: str
    interleave: int = 1


# module names (the last one or two parts of a state_dict name) whose
# product expands the hidden width (column) or contracts it (row)
_COLUMN = {"w_1", "linear_q", "linear_k", "linear_v", "linear_pos", "query",
           "key", "value", "intermediate.dense", "mlp.0"}
_GATED = {"dilated_conv", "conditioner_projection"}
_GATHER = {"adaptor.0"}
_ROW = {"w_2", "linear_out", "output.dense", "mlp.2"}
_HEAD = {"pos_bias_u", "pos_bias_v"}
_BLOCK_OUT = re.compile(r"(^|\.)residual_layers\.\d+\.output_projection$")


def module_kind(name: str) -> Optional[str]:
    """The sharding of the module named ``name`` (a state_dict prefix), or
    None (replicated)."""
    parts = name.split(".")
    for kind, names in (("column", _COLUMN), ("gated", _GATED),
                        ("gather", _GATHER), ("row", _ROW)):
        if parts[-1] in names or ".".join(parts[-2:]) in names:
            return kind
    if _BLOCK_OUT.search(name):
        return "row"
    return None


def param_partition_spec(name: str, param: torch.Tensor) -> Optional[Shard]:
    """The ``Shard`` of the parameter named ``name`` (a ``state_dict``
    key), or None (replicated): the counterpart of JAX's
    ``param_partition_spec`` in the torch layouts (``Linear.weight`` [out,
    in], ``Conv1d.weight`` [out, in, k])."""
    module, _, leaf = name.rpartition(".")
    if leaf in _HEAD and param.ndim == 2:
        return Shard(0, "head")
    kind = module_kind(module)
    if kind is None or leaf not in ("weight", "bias"):
        return None
    if kind == "row":
        return Shard(1, kind) if leaf == "weight" else None
    return Shard(0, kind, 2 if kind == "gated" else 1)


# ----------------------------------------------------------- the modules
class _Column:
    """A column-parallel product: its input's gradient is summed over the
    group, by its own ``copy``, or by its owner's where the owner passed
    the input through one (``tp_copied``)."""

    tp_copied = False

    def forward(self, x):
        return super().forward(x if self.tp_copied else self.tp_group.copy(x))


class _Gather(_Column):
    """A column-parallel product whose output is joined over the group."""

    def forward(self, x):
        return self.tp_group.gather(super().forward(x), -1)


class _Row:
    """A row-parallel product: the partial products are summed over the
    group, then the (whole) bias added."""

    def forward(self, x):
        if isinstance(self, nn.Linear):
            y = F.linear(*promoted(x, self.weight))
        elif self.padding == "same":
            y = conv1d_same(x, self.weight, None, self.dilation[0],
                            self.groups)
        else:
            y = conv1d_btc(x, self.weight, None, self.stride[0],
                           self.padding[0], self.dilation[0], self.groups)
        y = self.tp_group.reduce(y)
        return y if self.bias is None else y + self.bias


def _copy_once(group, xs):
    """``xs`` with each floating tensor passed through ``group.copy``, one
    copy for each distinct tensor (q, k and v of a self-attention read one
    x): the gradients of its readers add up before the one all-reduce."""
    done = {}
    out = []
    for x in xs:
        if torch.is_tensor(x) and x.is_floating_point():
            if id(x) not in done:
                done[id(x)] = group.copy(x)
            x = done[id(x)]
        out.append(x)
    return out


class _CopyInputs:
    """An attention module whose column products share inputs: each
    distinct input passes ``copy`` once, here."""

    def forward(self, *args, **kwargs):
        return super().forward(*_copy_once(self.tp_group, args), **kwargs)


class _CopyCond:
    """The DiffNet: ``cond`` passes ``copy`` once before every block's
    conditioner projection reads it."""

    def precompute_cond(self, cond, io_dtype=None):
        return super().precompute_cond(self.tp_group.copy(cond), io_dtype)


_MIXINS = {"column": _Column, "gated": _Column, "gather": _Gather,
           "row": _Row, "inputs": _CopyInputs, "cond": _CopyCond}
_CLASSES: Dict[tuple, type] = {}


def _parallel_class(kind: str, cls: type) -> type:
    key = (kind, cls)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"{kind.capitalize()}Parallel{cls.__name__}",
                             (_MIXINS[kind], cls), {})
    return _CLASSES[key]


def _set_class(mod, kind, group):
    mod.__class__ = _parallel_class(kind, type(mod))
    mod.tp_group = group


# the model config key of each attention module's head count (the plain
# attention and its relative-position subclasses)
_HEADS_KEY = ((MultiHeadedAttention, "model.encoder.attention_heads"),
              (GSTCrossAttention, "model.reference_encoder.gst_heads"),
              (BertSelfAttention, "model.prompt_encoder.bert_num_heads"))


def _heads_key(mod) -> Optional[str]:
    for cls, key in _HEADS_KEY:
        if isinstance(mod, cls):
            return key
    return None


# the modules whose sharded products ``shard_module`` knows how to run:
# the attentions (heads split), the FFNs (hidden width split), BERT's
# blocks, the DiffNet's blocks, and the Sequentials of the DiffNet's step
# MLP and the prompt adaptor
_OWNERS = (MultiHeadedAttention, GSTCrossAttention, BertSelfAttention,
           BertIntermediate, BertOutput, BertSelfOutput, MultiLayeredConv1d,
           PositionwiseFeedForward, ResidualBlock, nn.Sequential)


def _check_known(mname: str, mod: nn.Module, owner: nn.Module):
    """Raise, naming the layer, where JAX's spec shards a product (by its
    name) that the port could only replicate or would run wrong: not a
    ``Linear`` or ``Conv1d``, or held by a module ``shard_module`` does
    not know."""
    if not isinstance(mod, (Linear, Conv1d)) or not isinstance(owner,
                                                               _OWNERS):
        raise ValueError(
            f"tensor parallelism does not know the layer {mname} "
            f"({type(mod).__name__} in {type(owner).__name__}), which JAX's "
            "param_partition_spec shards")


def _check_divides(n: int, world: int, what: str):
    if n % world:
        raise ValueError(f"{what} = {n} does not divide over the {world} "
                         "ranks of the model axis (train.mesh.model)")


def shard_module(model: nn.Module, group, skip: Sequence[str] = ()
                 ) -> nn.Module:
    """Shard ``model`` in place over ``group`` (a ``ModelGroup``): every
    parameter with a ``Shard`` keeps this rank's slice, the products
    gather or reduce as their kind says, the attention modules keep their
    heads' share and the dropouts of sharded activations draw whole masks.
    Modules under a prefix of ``skip`` (e.g. ``decoder.denoise_fn`` when it
    is pipelined instead) stay replicated. A head count or width that does
    not divide raises, naming it, before anything changes. Records
    ``model.tp_shards`` ({name: Shard}) and ``model.tp_group``; returns
    ``model``."""
    r, M = group.rank, group.world
    skip = tuple(p + "." for p in skip)
    mods = [(n, m) for n, m in model.named_modules()
            if not (n and (n + ".").startswith(skip))]
    shards = {}
    owners = dict(mods)
    for mname, mod in mods:
        if mname and module_kind(mname) is not None:
            _check_known(mname, mod, owners[mname.rpartition(".")[0]])
        key = _heads_key(mod)
        if key is not None:
            _check_divides(mod.h, M, f"{key} (the heads of {mname})")
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            spec = param_partition_spec(name, p)
            if spec is not None:
                _check_divides(p.shape[spec.dim] // spec.interleave, M,
                               f"the width of {name} (dim {spec.dim})")
                shards[name] = (mod, leaf, spec)
    with torch.no_grad():
        for mod, leaf, spec in shards.values():
            p = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(
                shard_of(p, spec.dim, r, M, spec.interleave).clone(),
                requires_grad=p.requires_grad))
    for mname, mod in reversed(mods):  # the products before their owners
        kind = module_kind(mname)
        if kind is not None and isinstance(mod, (Linear, Conv1d)):
            _set_class(mod, kind, group)
        if _heads_key(mod) is not None:
            # one copy of each input for q, k, v (and the positions)
            _set_class(mod, "inputs", group)
            for child in mod.children():
                if isinstance(child, _Column):
                    child.tp_copied = True
            mod.h //= M
            drop = (mod.attn_dropout
                    if isinstance(mod, MultiHeadedAttention)
                    else mod.dropout)
            drop.shard = (1, group)
        elif isinstance(mod, (MultiLayeredConv1d, PositionwiseFeedForward)):
            mod.dropout.shard = (-1, group)
        elif isinstance(mod, DiffNet):
            # one copy of cond for the blocks' conditioner projections
            _set_class(mod, "cond", group)
            for block in mod.residual_layers:
                block.conditioner_projection.tp_copied = True
    model.tp_shards = {name: spec for name, (_, _, spec) in shards.items()}
    model.tp_group = group
    return model


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole tensors of ``model``'s sharded parameters, joined over its
    model group (a collective: every rank of the group calls it), by
    ``state_dict`` name; {} for a model that is not sharded."""
    shards = getattr(model, "tp_shards", None) or {}
    params = dict(model.named_parameters())
    return {name: model.tp_group.gather_dim(params[name], spec.dim,
                                            spec.interleave)
            for name, spec in shards.items()}


def local_state_dict(model: nn.Module, state_dict: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """``state_dict`` (whole tensors, e.g. a checkpoint's) with each of
    ``model``'s sharded parameters cut to this rank's slice."""
    shards = getattr(model, "tp_shards", None) or {}
    if not shards:
        return dict(state_dict)
    g = model.tp_group
    return {k: shard_of(v, shards[k].dim, g.rank, g.world,
                        shards[k].interleave).clone()
            if k in shards else v for k, v in state_dict.items()}


def gather_optimizer_state(state) -> dict:
    """``state.optimizer``'s state dict with the moments of sharded
    parameters whole (a collective over the model group)."""
    sd = state.optimizer.state_dict()
    shards = getattr(state.model, "tp_shards", None) or {}
    if not shards:
        return sd
    g = state.model.tp_group
    for i, name in enumerate(state.trainable):
        if name in shards and i in sd["state"]:
            spec = shards[name]
            sd["state"][i] = {k: g.gather_dim(v, spec.dim, spec.interleave)
                              if torch.is_tensor(v) and v.ndim else v
                              for k, v in sd["state"][i].items()}
    return sd


def local_optimizer_state(state, sd: dict) -> dict:
    """A whole optimizer state dict (``gather_optimizer_state``'s) cut to
    this rank's slices."""
    shards = getattr(state.model, "tp_shards", None) or {}
    if not shards:
        return sd
    g = state.model.tp_group
    out = dict(sd, state=dict(sd["state"]))
    for i, name in enumerate(state.trainable):
        if name in shards and i in out["state"]:
            spec = shards[name]
            out["state"][i] = {
                k: shard_of(v, spec.dim, g.rank, g.world,
                            spec.interleave).clone()
                if torch.is_tensor(v) and v.ndim else v
                for k, v in out["state"][i].items()}
    return out
