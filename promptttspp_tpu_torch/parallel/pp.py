"""Pipeline parallelism over the DiffNet's residual stack (GPipe).

Counterpart of ``promptttspp_tpu/parallel/pp.py::denoise_pipelined``. The
DiffNet's blocks form a chain (block i reads block i-1's x and adds its
skip term), so its L blocks split into S stages of L/S consecutive blocks
and a batch into M microbatches. JAX runs the ``M + S - 1`` ticks of the
GPipe timetable as one ``lax.scan`` in a ``shard_map`` over the mesh's
model axis: on tick k stage s works on microbatch k - s and every stage
``ppermute``s its (x, skip sum) to the next. The port runs the same
timetable over one of two transports:

- ``StageDevices``: the devices of a ``Mesh``'s model axis inside one
  process (serving, as ``parallel/sp.py`` spreads frames; a device may
  repeat). Stage s runs on its device with that device's replica of the
  DiffNet, and the permute is a copy to the next stage's device.
- a ``parallel/distributed.py::ModelGroup``: one stage per process
  (training). Every rank holds the whole DiffNet and runs its own stage's
  blocks; the permute is a send to the next rank and a receive from the
  previous one (``ModelGroup.permute``).

Ticks on which a stage holds no microbatch (the bubbles) compute nothing
and send zeros. The timetable is one ``torch.autograd.Function``: its
backward replays the ticks in reverse, recomputes each stage's forward
from the inputs it kept (GPipe's re-materialization), back-propagates
through it and sends the input's gradient to the previous stage. Every
rank thus makes its permutes in the same order, forward and backward,
with nothing left to the autograd engine's scheduling. The blocks'
parameter gradients land in their ``.grad`` directly; over a model group
each rank holds its own stage's, which ``TrainState`` sums over the group.

Over a model group the prologue (input projection, step MLP) and the
epilogue run on every rank alike. Their outputs enter the pipeline through
``ModelGroup.copy`` (whose gradient is summed over the group: each stage
reads cond and the step embedding for its own blocks only, stage 0 alone
reads x), and the last stage's skip sum leaves it through
``ModelGroup.reduce`` (the other ranks add zeros; its gradient passes
unchanged, so it is not multiplied by S).

``batch_axis`` names the data axis the batch is split over (DP x PP); in
the port each rank's batch is already its data shard, so the microbatch
fold is shard-local as in JAX, and the axis only enters the check.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from promptttspp_tpu_torch.models.diffusion import sinusoidal_pos_emb
from promptttspp_tpu_torch.parallel.mesh import replicas


class StageDevices:
    """The pipeline's transport across the devices of one process: stage s
    on ``devices[s]`` (a device may repeat), with one replica of the
    DiffNet per distinct device (made at first use)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.stages = list(range(len(self.devices)))
        self._replicas = None  # (diffnet, {device: replica})

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    def device(self, s: int) -> torch.device:
        return self.devices[s]

    def diffnet(self, diffnet, s: int):
        """The replica of ``diffnet`` on stage s's device."""
        if self._replicas is None or self._replicas[0] is not diffnet:
            self._replicas = (diffnet, replicas(diffnet, self.devices))
        return self._replicas[1][self.devices[s]]

    def permute(self, outs: Dict[int, torch.Tensor], shift: int
                ) -> Dict[int, torch.Tensor]:
        """Stage s's tensor to stage s + shift (around the ring)."""
        S = self.n_stages
        return {(s + shift) % S: t.to(self.devices[(s + shift) % S])
                for s, t in outs.items()}


class StageGroup:
    """The pipeline's transport across the ranks of a model group: this
    process runs stage ``group.rank`` of ``group.world``."""

    def __init__(self, group):
        self.group = group
        self.stages = [group.rank]

    @property
    def n_stages(self) -> int:
        return self.group.world

    def device(self, s: int) -> Optional[torch.device]:
        return None  # the inputs' own

    def diffnet(self, diffnet, s: int):
        return diffnet

    def permute(self, outs: Dict[int, torch.Tensor], shift: int
                ) -> Dict[int, torch.Tensor]:
        (s, t), = outs.items()  # t goes to stage s + shift; s gets one
        return {s: self.group.permute(t, shift)}


def transport_of(pipeline):
    """The transport of a pipeline setting: a ``Mesh`` (the devices of its
    first data row's model axis; its stage replicas are made anew at each
    call, so a caller that repeats keeps a ``StageDevices``), a
    ``ModelGroup``, or a transport."""
    if hasattr(pipeline, "permute") and hasattr(pipeline, "stages"):
        return pipeline
    if hasattr(pipeline, "model_devices"):
        return StageDevices(pipeline.model_devices(0))
    return StageGroup(pipeline)


def stage_apply(blocks, y, cond, t_emb, mask=None):
    """One stage: ``blocks`` (consecutive ResidualBlocks) on y [b,T,R] with
    cond [b,T,H], the step embedding [b,R] and mask [b,T,1] or None ->
    (y, the blocks' skip sum), each block's conditioner projection computed
    here (JAX's ``stage_apply``)."""
    skip_sum = torch.zeros_like(y)
    for block in blocks:
        y, skip = block(y, block.conditioner_projection(cond), t_emb, mask)
        skip_sum = skip_sum + skip
    return y, skip_sum


def _to(t, device):
    return t if t is None or device is None else t.to(device)


def _fold(a: Optional[torch.Tensor], M: int):
    """[B, ...] -> M microbatches of B / M consecutive rows."""
    return None if a is None else list(a.chunk(M, dim=0))


def _schedule_forward(tp, diffnet, h, cond, t_emb, mask, M: int,
                      keep: bool):
    """The M + S - 1 ticks. -> (the last stage's skip sums [B,T,R] on h's
    device, zeros on a rank of a group that does not hold the last stage;
    the inputs each (stage, microbatch) got, when ``keep``)."""
    S, per = tp.n_stages, len(diffnet.residual_layers) // tp.n_stages
    hs, cs, ts, ms = (_fold(a, M) for a in (h, cond, t_emb, mask))
    R = h.shape[-1]
    out = [None] * M
    kept = {}
    inbox = {}
    for k in range(M + S - 1):
        outs = {}
        for s in tp.stages:
            m, dev = k - s, tp.device(s)
            if not 0 <= m < M:  # a bubble
                outs[s] = _to(hs[0].new_zeros(hs[0].shape[:-1] + (2 * R,)),
                              dev)
                continue
            if s == 0:
                y0, sk0 = _to(hs[m], dev), None
            else:
                y0, sk0 = inbox[s][..., :R], inbox[s][..., R:]
                if keep:
                    kept[s, m] = y0
            net = tp.diffnet(diffnet, s)
            y, skip = stage_apply(net.residual_layers[s * per:(s + 1) * per],
                                  y0, _to(cs[m], dev), _to(ts[m], dev),
                                  _to(None if ms is None else ms[m], dev))
            sk = skip if sk0 is None else sk0 + skip
            if s == S - 1:
                out[m] = sk.to(h.device)
            outs[s] = torch.cat([y, sk], dim=-1)
        if k < M + S - 2:
            inbox = tp.permute(outs, 1)
    if S - 1 not in tp.stages:
        return torch.zeros_like(h), kept
    return torch.cat(out, dim=0), kept


class _Pipeline(torch.autograd.Function):
    """The timetable, with a backward that replays it in reverse (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, tp, diffnet, M, h, cond, t_emb, mask):
        out, kept = _schedule_forward(tp, diffnet, h, cond, t_emb, mask, M,
                                      keep=True)
        ctx.tp, ctx.diffnet, ctx.M, ctx.kept = tp, diffnet, M, kept
        ctx.save_for_backward(h, cond, t_emb, mask)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        tp, diffnet, M, kept = ctx.tp, ctx.diffnet, ctx.M, ctx.kept
        h, cond, t_emb, mask = ctx.saved_tensors
        S, per = tp.n_stages, len(diffnet.residual_layers) // tp.n_stages
        R = h.shape[-1]
        leaves = [None if a is None else a.detach().requires_grad_()
                  for a in (h, cond, t_emb)]
        with torch.enable_grad():  # the microbatches as views of leaves
            hs, cs, ts = (_fold(a, M) for a in leaves)
        ms = _fold(mask, M)
        gs = _fold(grad_out, M)
        inbox = {}
        for k in range(M + S - 2, -1, -1):
            outs = {}
            for s in tp.stages:
                m, dev = k - s, tp.device(s)
                g = inbox.get(s)
                if not 0 <= m < M:  # a bubble
                    outs[s] = _to(h.new_zeros(hs[0].shape[:-1] + (2 * R,)),
                                  dev)
                    continue
                with torch.enable_grad():
                    y0 = _to(hs[m], dev) if s == 0 else \
                        kept[s, m].detach().requires_grad_()
                if g is None:  # the last stage's first tick back
                    g_y, g_sk = torch.zeros_like(y0), torch.zeros_like(y0)
                else:
                    g_y, g_sk = g[..., :R], g[..., R:]
                if s == S - 1:
                    g_sk = g_sk + gs[m].to(g_sk.device)
                with torch.enable_grad():
                    net = tp.diffnet(diffnet, s)
                    y, skip = stage_apply(
                        net.residual_layers[s * per:(s + 1) * per], y0,
                        _to(cs[m], dev), _to(ts[m], dev),
                        _to(None if ms is None else ms[m], dev))
                    torch.autograd.backward([y, skip], [g_y, g_sk])
                if s == 0:  # stage 0 read neither x nor skip from the ring
                    outs[s] = torch.zeros_like(torch.cat([g_y, g_sk], -1))
                else:
                    g_y0 = (torch.zeros_like(g_y) if y0.grad is None
                            else y0.grad)
                    outs[s] = torch.cat([g_y0, g_sk], dim=-1)
            if k > 0:
                inbox = tp.permute(outs, -1)
        grads = [None if a is None else
                 (a.grad if a.grad is not None else torch.zeros_like(a))
                 for a in leaves]
        return (None, None, None, *grads, None)


def check_pipeline(n_layers: int, cycle: int, S: int, M: int, B: int,
                   D: int = 1, batch_axis: Optional[str] = None):
    """JAX's checks of ``denoise_pipelined``, raising ValueError with its
    messages: L into S equal stages, a stage a multiple of the dilation
    cycle (S > 1), the (global) batch B into M microbatches x D shards."""
    if n_layers % S != 0:
        raise ValueError(f"{n_layers} layers not divisible into {S} stages")
    per_stage = n_layers // S
    if per_stage % cycle != 0 and S != 1:
        raise ValueError(
            f"stage size {per_stage} must be a multiple of the dilation "
            f"cycle {cycle} so per-slot dilations are stage-invariant")
    if B % (M * D) != 0:
        raise ValueError(
            f"batch {B} not divisible into {M} microbatches"
            + (f" x {D} '{batch_axis}' shards" if batch_axis else ""))


def denoise_pipelined(pipeline, diffnet, x, t, cond, mask=None,
                      n_microbatches: Optional[int] = None,
                      batch_axis: Optional[str] = None, data=None):
    """``diffnet(x, t, diffnet.precompute_cond(cond), mask)`` with the
    residual stack run as the GPipe timetable over ``pipeline``'s model
    axis: a ``Mesh`` (its first data row's model devices), a
    ``ModelGroup`` or a transport (``StageDevices``, ``StageGroup``).

    x [B,T,in_dim] noisy mel, t [B] diffusion steps, cond [B,T,H], mask
    [B,T,1] or None, on x's device. ``n_microbatches`` defaults to one per
    stage. ``batch_axis`` (with ``data``, a ``DataGroup``): x is this
    rank's shard of a batch split over ``data.world`` shards, each folded
    into microbatches on its own (DP x PP)."""
    tp = transport_of(pipeline)
    S = tp.n_stages
    L = len(diffnet.residual_layers)
    M = n_microbatches or S
    D = data.world if batch_axis and data is not None else 1
    check_pipeline(L, diffnet.dilation_cycle_length, S, M, x.shape[0] * D,
                   D, batch_axis)
    group = getattr(tp, "group", None)
    h = torch.relu(diffnet.input_projection(x))
    t_emb = diffnet.mlp(sinusoidal_pos_emb(t, diffnet.residual_channels,
                                           diffnet.scale))
    if group is not None:
        h, cond, t_emb = group.copy(h), group.copy(cond), group.copy(t_emb)
    if torch.is_grad_enabled() and (
            any(a.requires_grad for a in (h, cond, t_emb))
            or any(p.requires_grad
                   for p in diffnet.residual_layers.parameters())):
        if any(tp.diffnet(diffnet, s) is not diffnet for s in tp.stages):
            raise ValueError(
                "a gradient through the pipeline needs every stage on the "
                "DiffNet's own device (a replica elsewhere would take its "
                "gradients); train over a model group instead")
        skip_sum = _Pipeline.apply(tp, diffnet, M, h, cond, t_emb, mask)
    else:
        skip_sum, _ = _schedule_forward(tp, diffnet, h, cond, t_emb, mask, M,
                                        keep=False)
    if group is not None:
        skip_sum = group.reduce(skip_sum)
    out = skip_sum / math.sqrt(L)
    return diffnet.output_projection(torch.relu(
        diffnet.skip_projection(out)))
