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


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks, whose gradient is the SUM of the gradients: the
    gradient of a global sum that every rank's loss reads."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class DataGroup:
    """The data axis of a step: this process is ``rank`` of ``world`` in
    the default process group, each rank holding an equal block of the
    global batch's rows."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = int(rank), int(world)

    @classmethod
    def current(cls) -> "DataGroup":
        """The default process group's."""
        return cls(dist.get_rank(), dist.get_world_size())

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
        return _AllReduceSum.apply(x)

    @torch.no_grad()
    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, without gradient."""
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

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
            dist.all_reduce(flat)
            torch._foreach_copy_(bucket, [v.view_as(g) for v, g in zip(
                flat.split([g.numel() for g in bucket]), bucket)])
            nbytes += flat.numel() * flat.element_size()
        return nbytes

    def broadcast_object(self, obj, device=None):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=device)
        return box[0]

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module):
        """Give every rank rank 0's parameters and buffers."""
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


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
    the global batch's longest. At world size 1 it yields
    ``(indices, {})``."""
    rank, world = _rank_world(rank, world)
    if world == 1:
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
