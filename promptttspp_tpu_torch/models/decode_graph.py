"""The diffusion decode as CUDA graphs: one per (batch, frame bucket) of a
decoder.

Counterpart of the jitted ``lax.scan`` of
``promptttspp_tpu/models/diffusion.py::GaussianDiffusion.inference``:
JAX compiles the whole K-step decode into one program per shape; here
``GaussianDiffusion.sample`` (every denoiser step of the ancestral or the
PLMS loop, the hoisted conditioner projections and the denormalization) is
captured once per shape as one CUDA graph and replayed as one launch,
instead of the ~25,000 kernel launches the eager loop issues at the
flagship's widths.

A graph reads static buffers: the conditioning, copied in before each
replay, and the random draws (``GaussianDiffusion.fill_draws``), drawn
from the request's generator into the buffer outside the graph, so the
graph and the eager decode consume the same values and give the same bits.
The output is copied out right after the replay, so requests queued on one
bucket do not overwrite each other's result. All graphs of a decoder share
one memory pool; a replay waits for the previous replay of its graph, so
requests on several streams do not share the buffers at once.

A graph is captured at the first decode of its shape (``Synthesizer.
prewarm`` captures ahead, as JAX's prewarm compiles ahead), inside the span
``decode_graph.capture`` (``utils/trace.py``); a capture that fails raises.
On a CPU tensor ``decode`` runs the eager decode.

Any sampler with the same contract is captured the same way: ``n_draws()``,
``out_dim``, ``fill_draws(draws, x_T, zero_noise, generator)``,
``sample(cond, draws)`` and ``inference(cond, x_T, zero_noise,
generator)``, where ``cond`` may be a tuple of tensors whose first is
[B, T, ...]: F5-TTS's sampler (``models/f5tts.py``) takes its reference
mel, ids and frame counts so, each copied into its own static buffer.

Each replay records counters (``utils/trace.py``), since no Python runs
inside it. For the diffusion decode: ``decode.blocks_run``, the DiffNet
residual blocks the graph runs (the decoder's denoiser calls x its L
blocks), and ``decode.blocks_fused``, those of them captured on the fused
block path (``DiffNet.fuses`` at the capture): the same number, or 0. A
sampler with ``replay_counts(cond)`` records what that returns (F5-TTS:
``decode.passes_run``, ``decode.blocks_run`` and ``f5.attn_flops``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

from promptttspp_tpu_torch.models.diffusion import GaussianDiffusion
from promptttspp_tpu_torch.utils import trace


def _tensors(cond) -> Sequence[torch.Tensor]:
    return cond if isinstance(cond, (tuple, list)) else (cond,)


def _replay_counts(decoder, cond) -> Dict[str, int]:
    """The counters each replay of ``decoder``'s graph records."""
    if hasattr(decoder, "replay_counts"):
        return decoder.replay_counts(cond)
    net = decoder.denoise_fn
    blocks_run = decoder.n_denoiser_calls() * len(net.residual_layers)
    fused = decoder.pipeline is None and net.fuses(cond)
    return {"decode.blocks_run": blocks_run,
            "decode.blocks_fused": blocks_run if fused else 0}


class _Graph:
    """One captured decode of ``decoder`` at the shapes of ``cond`` (a
    tensor [B, T, H], or a tuple of tensors whose first is [B, T, ...])."""

    def __init__(self, decoder: GaussianDiffusion, cond,
                 device: torch.device, pool):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.decoder = decoder
        buffers = [torch.zeros(c.shape, dtype=c.dtype, device=device)
                   for c in _tensors(cond)]
        self.cond = (buffers[0] if isinstance(cond, torch.Tensor)
                     else tuple(buffers))
        B, T = buffers[0].shape[0], buffers[0].shape[1]
        self.draws = torch.zeros((decoder.n_draws(), B, T, decoder.out_dim),
                                 device=device)
        # one run on a side stream first, so cuBLAS workspaces and cuDNN
        # plans exist before the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            decoder.sample(self.cond, self.draws)
        stream = torch.cuda.current_stream(device)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = decoder.sample(self.cond, self.draws)
        finally:  # a capture that fails to end leaves its stream current
            torch.cuda.set_stream(stream)
        self.counts = _replay_counts(decoder, self.cond)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        self.done = torch.cuda.Event()
        self.shape = (B, T)
        self.capture_s = time.perf_counter() - t0
        self.buffer_bytes = (sum(b.nbytes for b in buffers)
                             + self.draws.nbytes + self.out.nbytes)
        # the device memory the process holds more after the capture
        self.reserved_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self, cond, x_T, zero_noise, generator):
        torch.cuda.current_stream(self.draws.device).wait_event(self.done)
        for buffer, c in zip(_tensors(self.cond), _tensors(cond)):
            buffer.copy_(c)
        self.decoder.fill_draws(self.draws, x_T, zero_noise, generator)
        self.graph.replay()
        out = self.out.clone()
        self.done.record()
        for name, n in self.counts.items():
            trace.count(name, n)
        return out


class _Graphs:
    """A decoder's graphs by (device, B, T), and their shared pool."""

    def __init__(self):
        self.pool = None
        self.by_shape: Dict[Tuple, _Graph] = {}


def _graphs(decoder: GaussianDiffusion) -> _Graphs:
    graphs = getattr(decoder, "_decode_graphs", None)
    if graphs is None:
        graphs = decoder._decode_graphs = _Graphs()
    return graphs


def decode(decoder: GaussianDiffusion, cond, x_T=None,
           zero_noise: bool = False, generator=None):
    """``decoder.inference(cond, x_T, zero_noise, generator)``: on a CUDA
    tensor as the replay of the graph of cond's shapes (captured now if
    they are new), on a CPU tensor eager. ``cond``: a float32 [B, T, H],
    or the tuple of tensors the sampler takes."""
    first = _tensors(cond)[0]
    if first.device.type == "cpu":
        return decoder.inference(cond, x_T, zero_noise, generator)
    if isinstance(cond, torch.Tensor) and (cond.dtype != torch.float32
                                           or cond.dim() != 3):
        raise ValueError(f"decode takes float32 cond [B, T, H], got "
                         f"{cond.dtype} {tuple(cond.shape)}")
    with torch.inference_mode():
        graphs = _graphs(decoder)
        key = (first.device,) + tuple(
            (tuple(c.shape), c.dtype) for c in _tensors(cond))
        if isinstance(cond, torch.Tensor):
            key = (first.device, first.shape[0], first.shape[1])
        graph = graphs.by_shape.get(key)
        if graph is None:
            if graphs.pool is None:
                graphs.pool = torch.cuda.graph_pool_handle()
            with trace.span("decode_graph.capture"):
                graph = _Graph(decoder, cond, first.device, graphs.pool)
            graphs.by_shape[key] = graph
        if x_T is not None:
            x_T = x_T.to(device=first.device, dtype=torch.float32)
        return graph.replay(cond, x_T, zero_noise, generator)


def captured(decoder: GaussianDiffusion) -> List[Dict]:
    """Each graph of ``decoder`` in the order of capture: B, T, capture
    seconds, the bytes of its static buffers and output, and the growth of
    the device memory the process holds across the capture."""
    return [dict(B=g.shape[0], T=g.shape[1], capture_s=g.capture_s,
                 buffer_bytes=g.buffer_bytes,
                 reserved_bytes=g.reserved_bytes)
            for g in _graphs(decoder).by_shape.values()]
