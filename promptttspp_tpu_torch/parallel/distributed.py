"""Data parallelism across processes: the process group, each rank's rows
of a global batch, and the global reductions of a training step.

Counterpart of ``promptttspp_tpu/parallel/distributed.py``
(``init_distributed``, ``process_slice``, ``mesh_process_rows``,
``host_batches``). JAX runs one program over a mesh whose batch is one
array sharded by rows, so every reduction of its step is global and XLA
inserts the collectives. The port runs one process per GPU (NCCL; gloo on
the CPU or when asked), each holding a block of the global batch's rows,
and makes the same reductions global by hand (``DataGroup``):

- the loss normalizers (frames, phones, rows) are summed over the ranks, so
  each rank's loss is its rows' sum over the global count;
- ``WeightedBatchNorm`` sums its weighted statistics over the ranks, with
  gradient (``nn/layers.py``);
- every random draw of the step (dropout, the diffusion steps and noise) is
  made at the global batch's shape from the same generator on every rank
  and cut to the rank's rows;
- the trainable gradients are summed over the ranks in a few flat float32
  buckets (``TrainState``).

A step at world size W then computes the gradient of the global batch, as
one process would on the same (padded) batch; the sums only run in another
order. Every rank collates its rows at the global batch's shape buckets
(``host_batches``), because the padded length enters the BatchNorm
statistics.

A model axis (``process_groups``) folds the world into data shards of
``model`` ranks each, which hold the same rows: the ``DataGroup``'s
reductions then run over its data axis's subgroup, not the world, and the
``ModelGroup`` carries the collectives of tensor and pipeline parallelism
(``parallel/tp.py``, ``parallel/pp.py``).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.data.collate import FRAME_QUANTUM, PHONE_QUANTUM

# elements of one flat gradient bucket (100 MB of float32)
GRAD_BUCKET_ELEMS = 25 * 2**20


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device_type: str = "cuda") -> bool:
    """Join the process group when one is configured; returns whether this
    process is in one (a group of one process counts; one process without
    a ``process_id`` is not a group).

    Sources, in order: the arguments (``train.distributed.*``), then
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``). The address is ``host:port`` or a ``tcp://`` URL.
    ``backend`` defaults to NCCL on a GPU and gloo on the CPU; NCCL puts
    one rank on each GPU, gloo can put several on one."""
    if dist.is_initialized():
        return True
    env = os.environ
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if process_id is None and (num_processes or 1) == 1:
        return False  # one process: no group
    if None in (process_id, num_processes, coordinator_address):
        raise ValueError(
            "a process group needs train.distributed.process_id, "
            "train.distributed.num_processes and "
            "train.distributed.coordinator_address (or torchrun's RANK, "
            f"WORLD_SIZE and MASTER_ADDR); got {process_id}, "
            f"{num_processes}, {coordinator_address}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=int(num_processes),
        rank=int(process_id))
    return True


def local_rank() -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else its
    global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device_type: str) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (wrapped around the
    visible GPUs, which only gloo allows), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    n = torch.cuda.device_count()
    r = local_rank()
    if r >= n and dist.get_backend() == "nccl":
        raise ValueError(f"local rank {r} has no GPU of its own ({n} "
                         "visible): NCCL needs one GPU per rank; "
                         "train.distributed.backend=gloo shares them")
    return torch.device("cuda", r % n)


def _all_reduce(x: torch.Tensor, group=None):
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """SUM over a group's ranks, whose gradient is the SUM of the
    gradients: the gradient of a global sum that every rank's loss
    reads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity, whose gradient is summed over the
    group (a replicated activation read by every rank's slice of a
    sharded product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: SUM over the group, whose gradient is the identity
    (each rank's partial product made the replicated activation, whose
    gradient every rank already holds whole)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _gather_dim(x: torch.Tensor, dim: int, rank: int, world: int, group,
                interleave: int = 1) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order, by one SUM of
    zero-padded copies (exact: the other ranks add zeros), which every
    backend takes for CUDA tensors. ``interleave`` k: ``x`` is k equal
    blocks along ``dim`` (gated halves, k = 2), each joined over the
    ranks on its own."""
    n = x.shape[dim] // interleave
    shape = list(x.shape)
    shape[dim] = x.shape[dim] * world
    out = x.new_zeros(shape)
    for j in range(interleave):
        out.narrow(dim, (j * world + rank) * n, n).copy_(
            x.narrow(dim, j * n, n))
    return _all_reduce(out, group)


def shard_of(x: torch.Tensor, dim: int, rank: int, world: int,
             interleave: int = 1) -> torch.Tensor:
    """Rank ``rank``'s part of ``x`` along ``dim``: the ``rank``-th of
    ``world`` equal blocks, or, with ``interleave`` k, that block of each
    of x's k equal blocks (``_gather_dim``'s inverse)."""
    size = x.shape[dim]
    if size % (world * interleave):
        raise ValueError(f"{size} not divisible into {world} shards"
                         + (f" of {interleave} blocks" if interleave > 1
                            else ""))
    n = size // (world * interleave)
    parts = [x.narrow(dim, (j * world + rank) * n, n)
             for j in range(interleave)]
    return parts[0] if interleave == 1 else torch.cat(parts, dim)


class _GatherFromGroup(torch.autograd.Function):
    """Every rank's slice joined along ``dim``; the gradient of the whole,
    which every rank holds alike, is cut back to this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, rank, world, group):
        ctx.args = dim, rank, world
        return _gather_dim(x, dim, rank, world, group)

    @staticmethod
    def backward(ctx, grad):
        return shard_of(grad, *ctx.args).contiguous(), None, None, None, None


class _Group:
    """Ranks ``0 .. world-1`` of one axis (this process is ``rank``):
    ``group`` the process group of that axis (None: the default group) and
    ``ranks`` its members' global ranks, in axis order. A deep copy of a
    model that holds one shares it."""

    def __init__(self, rank: int, world: int, group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.rank, self.world = int(rank), int(world)
        self.group = group
        self.ranks = list(range(self.world)) if ranks is None else \
            [int(r) for r in ranks]

    def __deepcopy__(self, memo):
        return self

    @torch.no_grad()
    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, without gradient."""
        return _all_reduce(x.detach().clone(), self.group)

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> int:
        """Sum ``grads`` (float32) over the ranks in place, in flat buckets
        of up to ``GRAD_BUCKET_ELEMS`` elements; returns the bytes
        reduced."""
        buckets, size = [[]], 0
        for g in grads:
            if buckets[-1] and size + g.numel() > GRAD_BUCKET_ELEMS:
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += g.numel()
        nbytes = 0
        for bucket in filter(None, buckets):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            _all_reduce(flat, self.group)
            torch._foreach_copy_(bucket, [v.view_as(g) for v, g in zip(
                flat.split([g.numel() for g in bucket]), bucket)])
            nbytes += flat.numel() * flat.element_size()
        return nbytes

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module):
        """Give every rank the parameters and buffers of the axis's first
        rank."""
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, self.ranks[0], group=self.group)


class DataGroup(_Group):
    """The data axis of a step: this process is ``rank`` of ``world`` data
    shards, each holding an equal block of the global batch's rows. Its
    reductions run over the data axis's group only: the ranks of one model
    group hold the same rows, which would count ``model`` times over the
    whole world."""

    def rows(self, local: int) -> slice:
        """This rank's rows of a global batch of ``local * world``."""
        return slice(self.rank * local, (self.rank + 1) * local)

    def draw(self, fn, shape: Sequence[int], **kwargs) -> torch.Tensor:
        """``fn(shape, **kwargs)`` (``torch.rand``, ``randn``, ...) drawn
        at the global batch's shape, [world * shape[0], ...], and cut to
        this rank's rows: every rank draws what one process would."""
        shape = tuple(shape)
        full = fn((shape[0] * self.world,) + shape[1:], **kwargs)
        return full[self.rows(shape[0])]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable."""
        return _AllReduceSum.apply(x, self.group)

    def broadcast_object(self, obj, device=None):
        """Global rank 0's ``obj`` (picklable) on every rank of the
        world."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=device)
        return box[0]


class ModelGroup(_Group):
    """The model axis of a step: the ``world`` ranks that hold the same
    rows and split the model between them, by tensor parallelism
    (``parallel/tp.py``: Megatron's conjugate functions ``copy`` and
    ``reduce``, and ``gather``) or by pipeline stages (``parallel/pp.py``:
    ``permute`` around the ring)."""

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x, whose gradient is summed over the ranks."""
        return _CopyToGroup.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, whose gradient passes unchanged."""
        return _ReduceFromGroup.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's x joined along ``dim``, with gradient."""
        return _GatherFromGroup.apply(x, dim % x.ndim, self.rank,
                                      self.world, self.group)

    @torch.no_grad()
    def gather_dim(self, x: torch.Tensor, dim: int,
                   interleave: int = 1) -> torch.Tensor:
        """Every rank's x joined along ``dim``, without gradient
        (``shard_of``'s inverse)."""
        return _gather_dim(x.detach(), dim, self.rank, self.world,
                           self.group, interleave)

    @torch.no_grad()
    def permute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The x of rank ``rank - shift`` (around the ring): every rank
        sends its x to rank ``rank + shift`` and receives one. NCCL sends
        from the device; gloo stages through the host (its point-to-point
        takes CPU tensors)."""
        dst = self.ranks[(self.rank + shift) % self.world]
        src = self.ranks[(self.rank - shift) % self.world]
        staged = dist.get_backend(self.group) != "nccl" and x.is_cuda
        send = (x.cpu() if staged else x).contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dst, self.group),
               dist.P2POp(dist.irecv, recv, src, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device) if staged else recv


def fold(rank: int, data: int, model: int,
         model_spans_processes: bool = False) -> Tuple[int, int]:
    """(data index, model index) of global ``rank`` in a world of ``data *
    model``: rank ``d * model + m`` (the model group on one host), or
    ``m * data + d`` with ``model_spans_processes``, as JAX's
    ``make_mesh`` folds its devices."""
    if model_spans_processes:
        return rank % data, rank // data
    return rank // model, rank % model


def process_groups(model: int = 1, model_spans_processes: bool = False
                   ) -> Tuple[DataGroup, Optional[ModelGroup]]:
    """This process's data and model groups in the default group's world of
    ``data * model`` ranks (``fold``). At ``model`` 1 the data group is
    the world and there is no model group; otherwise every rank creates
    every subgroup, in the same order."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if model == 1:
        return DataGroup(rank, world), None
    if world % model:
        raise ValueError(f"train.mesh.model={model} does not divide the "
                         f"{world} processes")
    data = world // model
    at = {fold(r, data, model, model_spans_processes): r
          for r in range(world)}
    d, m = fold(rank, data, model, model_spans_processes)
    mine = {}
    for i in range(data):
        ranks = [at[i, j] for j in range(model)]
        group = dist.new_group(ranks)
        if i == d:
            mine["model"] = ModelGroup(m, model, group, ranks)
    for j in range(model):
        ranks = [at[i, j] for i in range(data)]
        group = dist.new_group(ranks)
        if j == m:
            mine["data"] = DataGroup(d, data, group, ranks)
    return mine["data"], mine["model"]


def _rank_world(rank: Optional[int], world: Optional[int]):
    """``rank`` and ``world``, each defaulting to this process's in the
    default group, else 0 of 1."""
    inited = dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if inited else 0
    if world is None:
        world = dist.get_world_size() if inited else 1
    return rank, world


def process_slice(n_rows: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> slice:
    """The contiguous block of a global batch's rows that ``rank`` of
    ``world`` holds (default: this process in the default group, else 0
    of 1); ``n_rows`` must divide by ``world``."""
    rank, world = _rank_world(rank, world)
    if n_rows % world:
        raise ValueError(f"global batch of {n_rows} rows not divisible by "
                         f"{world} processes")
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def mesh_process_rows(n_rows: int, rank: int, world: int,
                      row_multiple: Optional[int] = None
                      ) -> Tuple[slice, int]:
    """``(real_slice, slab_rows)``: ``rank``'s share of a global batch of
    ``n_rows`` padded with zero-weight rows up to a multiple of
    ``row_multiple`` (default ``world``). ``real_slice`` is its span of
    real rows (empty for a rank whose slab is all padding), ``slab_rows``
    the rows it holds after padding, the same on every rank."""
    mult = row_multiple or world
    if mult % world:
        raise ValueError(f"row_multiple {mult} must be a multiple of the "
                         f"{world} ranks")
    per = (-(-n_rows // mult) * mult) // world
    return (slice(min(rank * per, n_rows), min((rank + 1) * per, n_rows)),
            per)


def host_batches(sampler: Iterable[Sequence[int]], dataset, collator=None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 prompt_pad_to: Optional[int] = 64,
                 row_multiple: Optional[int] = None):
    """This rank's view of a global batch sampler: every rank walks the
    same seeded sampler and, for each global batch, yields
    ``(local_indices, collate_kwargs)``: its rows
    (``mesh_process_rows``), and the global batch's phone and frame
    buckets from the dataset's metadata (``num_phones``, ``num_tokens``),
    so every rank's arrays have the global shape. Reserved keys, which the
    batch assembly pops: ``_pad_rows_to`` (the slab's rows after padding),
    ``_zero_weight`` (a slab all padding, which borrows the first row at
    weight 0) and ``_global`` (the global batch's indices, whose items
    every rank draws in order, so the prompt draws agree with one
    process's). ``prompt_pad_to`` None pads the prompts to the bucket of
    the global batch's longest. At world size 1 without a
    ``row_multiple`` above 1 it yields ``(indices, {})``. Every rank of a
    model group passes its data shard's ``rank`` and the data axis's
    ``world``, so they get the same rows."""
    rank, world = _rank_world(rank, world)
    if world == 1 and (row_multiple or 1) == 1:
        for idx in sampler:
            yield list(idx), {}
        return
    if not hasattr(dataset, "num_phones"):
        raise ValueError("data parallelism needs dataset.num_phones(i) for "
                         "the global shape buckets")
    for idx in sampler:
        idx = list(idx)
        kwargs = dict(
            t_phones=bucket_shape(max(dataset.num_phones(i) for i in idx),
                                  PHONE_QUANTUM),
            t_frames=bucket_shape(max(dataset.num_tokens(i) for i in idx),
                                  FRAME_QUANTUM),
            prompt_pad_to=prompt_pad_to)
        sl, slab = mesh_process_rows(len(idx), rank, world, row_multiple)
        local = idx[sl]
        kwargs["_pad_rows_to"] = slab
        kwargs["_global"] = idx
        if not local:
            local = [idx[0]]
            kwargs["_zero_weight"] = True
        yield local, kwargs
