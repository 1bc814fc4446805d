"""Primitive layers over channel-last ``[B, T, C]`` tensors.

Counterpart of ``promptttspp_tpu/nn/layers.py``. Parameters keep torch's
own layouts (``Conv1d.weight`` is ``[out, in/groups, k]``, ``Linear.weight``
is ``[out, in]``) and the reference's ``state_dict`` names, so the weight
converter (``compat/from_jax.py``) is a fixed transpose per leaf.

Train mode (``module.train()``) switches ``WeightedBatchNorm`` to batch
statistics and ``Dropout`` to drawing masks, together. Dropout draws from
the generator that ``dropout_generator`` lends it for one call, never
from torch's global RNG.

Mixed dtypes promote as in JAX. Under bf16 training (``train/state.py``)
the parameters are bfloat16 while much of the model's activations are
float32 (JAX promotes bf16 with float32 to float32), and a flax layer then
computes in float32 with its bf16-rounded parameters. torch refuses such
operands in a product, a convolution or a norm, so ``Linear``,
``LayerNorm``, ``ChannelLayerNorm`` and ``conv1d_btc`` cast them to their
common dtype first (``promoted``); where the dtypes agree they do nothing.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def swish(x):
    return x * torch.sigmoid(x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    """``mish`` as a module, as JAX computes it."""

    def forward(self, x):
        return mish(x)


def promoted(*tensors):
    """``tensors`` cast to their common dtype, as JAX promotes the operands
    of an operation (bfloat16 with float32 gives float32); ``None`` passes
    through. Returned as given where they agree."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) < 2:
        return tensors
    dtype = functools.reduce(torch.promote_types, dtypes)
    return tuple(None if t is None else t.to(dtype) for t in tensors)


class Linear(nn.Linear):
    """``nn.Linear`` whose input and parameters promote as flax's ``Dense``
    does (``promoted``)."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        return F.linear(*promoted(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose input and parameters promote as flax's
    ``LayerNorm`` does (``promoted``)."""

    def forward(self, x):
        x, w, b = promoted(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def conv1d_btc(x, weight, bias=None, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1):
    """``F.conv1d`` on ``[B, T, C_in]`` -> ``[B, T', C_out]`` with a torch
    weight ``[C_out, C_in/groups, k]``. A 1x1 conv is the same product as a
    linear layer and runs as one. Mixed dtypes promote (``promoted``)."""
    x, weight, bias = promoted(x, weight, bias)
    if (weight.shape[-1] == 1 and groups == 1 and stride == 1
            and padding == 0):
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride, padding, dilation,
                 groups)
    return y.transpose(1, 2)


def same_padding(kernel_size: int, dilation: int = 1):
    """(left, right) padding of a stride-1 conv as XLA's ``"SAME"``: a
    total of ``(k-1) * dilation``, the left half rounded down. For an odd k
    both are the reference's ``(k-1)//2 * dilation``."""
    total = (kernel_size - 1) * dilation
    return total // 2, total - total // 2


def conv1d_same(x, weight, bias, dilation: int = 1, groups: int = 1):
    """Stride-1 conv with XLA's ``"SAME"`` padding (``same_padding``)."""
    left, right = same_padding(weight.shape[-1], dilation)
    if left != right:
        x = F.pad(x.transpose(1, 2), (left, right)).transpose(1, 2)
        left = 0
    return conv1d_btc(x, weight, bias, padding=left, dilation=dilation,
                      groups=groups)


class Conv1d(nn.Conv1d):
    """torch ``Conv1d`` taking and returning ``[B, T, C]``. ``padding=None``
    is XLA's ``"SAME"`` at stride 1, as the JAX modules' convolutions
    (``same_padding``; the reference's ``(k-1)//2 * dilation`` for an odd
    k)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, stride: int = 1, padding=None):
        if padding is None:
            if stride != 1:
                raise ValueError("Conv1d(padding=None) is SAME at stride 1; "
                                 f"give the padding at stride {stride}")
            padding = "same"
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dilation=dilation,
                         groups=groups, bias=bias)

    def forward(self, x):
        if self.padding == "same":
            return conv1d_same(x, self.weight, self.bias, self.dilation[0],
                               self.groups)
        return conv1d_btc(x, self.weight, self.bias, self.stride[0],
                          self.padding[0], self.dilation[0], self.groups)


class ChannelLayerNorm(nn.Module):
    """The reference's ``layers/norm.py`` LayerNorm: ``gamma``/``beta``
    parameters, eps 1e-5, over the channel (last) axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x, gamma, beta = promoted(x, self.gamma, self.beta)
        return F.layer_norm(x, (x.shape[-1],), gamma, beta, self.eps)


def layer_norm(features: int, eps: float = 1e-12) -> LayerNorm:
    """ESPnet LayerNorm (eps 1e-12) over the channel (last) axis."""
    return LayerNorm(features, eps=eps)


class WeightedBatchNorm(nn.Module):
    """Flax's ``BatchNorm`` on ``[B, C, ...]`` (channel at dim 1), with the
    JAX package's per-row weight (``WeightedBatchNorm`` of
    ``promptttspp_tpu/nn/layers.py``).

    Eval: the running statistics (as ``F.batch_norm``). Train: the batch
    statistics in float32, mean and mean of squares over every dim but 1
    and the variance as ``mean2 - mean**2`` (biased), rows of
    ``row_weight`` 0 left out; then ``running = momentum * running +
    (1 - momentum) * batch`` (flax's momentum 0.9 keeps 0.9 of the old
    value). The names are ``BatchNorm1d``'s, so checkpoints load as
    before. Under data parallelism (``data_parallel``) the weighted sums
    and the count are summed over the ranks, with gradient, before the
    mean and variance: the statistics of the global batch, the same on
    every rank."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.data = None  # the DataGroup that data_parallel lends

    def forward(self, x, row_weight=None):
        """x [B, C, ...]; row_weight [B] float or None (every row)."""
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        if row_weight is None and self.data is None:
            mean = xf.mean(dims)
            mean2 = xf.square().mean(dims)
        else:
            w = (torch.ones(x.shape[0], device=x.device)
                 if row_weight is None else row_weight.float())
            w = w.reshape((-1,) + (1,) * (x.ndim - 1))
            n = (w.sum() * math.prod(x.shape[2:])).reshape(1)
            sums = torch.cat([(xf * w).sum(dims),
                              (xf.square() * w).sum(dims), n])
            if self.data is not None:
                sums = self.data.sum(sums)
            C = x.shape[1]
            mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        var = mean2 - mean.square()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        return (y * self.weight.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


class Dropout(nn.Module):
    """Flax's ``Dropout``: in train mode keep each element with probability
    1 - p and scale it by 1 / (1 - p); the mask comes from the generator
    that ``dropout_generator`` lends. Eval mode, or p = 0, is the
    identity.

    ``shard`` (set by ``parallel/tp.py::shard_module``): (dim, model
    group) when x is this rank's slice along ``dim`` of an activation
    split over a model group; the mask is then drawn at the whole width
    and cut to the slice, so every rank draws what one process would."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator = None
        self.data = None  # the DataGroup that data_parallel lends
        self.shard = None

    def forward(self, x, batched: bool = True):
        """``batched`` False: x's leading axis is not the batch's (a table
        broadcast over it), so every rank draws the same mask."""
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in train mode draws from a generator: "
                               "call the model inside dropout_generator()")
        keep_prob = 1.0 - self.p
        shape = list(x.shape)
        if self.shard is not None:
            dim, group = self.shard
            shape[dim] *= group.world
        keep = draw(torch.rand, shape, self.data if batched else None,
                    generator=self.generator, device=x.device) < keep_prob
        if self.shard is not None:
            n = x.shape[dim]
            keep = keep.narrow(dim, group.rank * n, n)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator):
    """Lend ``generator`` to every ``Dropout`` under ``module`` for the
    duration of the block."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


def draw(fn, shape, data=None, **kwargs):
    """``fn(shape, **kwargs)`` (``torch.rand``, ``torch.randn``, ...) or,
    with ``data`` (a ``DataGroup``), ``data.draw``'s draw at the global
    batch's shape cut to this rank's rows."""
    if data is None:
        return fn(shape, **kwargs)
    return data.draw(fn, shape, **kwargs)


@contextlib.contextmanager
def data_parallel(module: nn.Module, data):
    """Lend ``data`` (a ``parallel/distributed.py::DataGroup``, or None) to
    every ``Dropout`` and ``WeightedBatchNorm`` under ``module`` for the
    duration of the block: dropout masks are drawn at the global batch's
    shape and cut to this rank's rows, BatchNorm statistics are summed
    over the ranks."""
    mods = [m for m in module.modules()
            if isinstance(m, (Dropout, WeightedBatchNorm))]
    for m in mods:
        m.data = data
    try:
        yield
    finally:
        for m in mods:
            m.data = None
