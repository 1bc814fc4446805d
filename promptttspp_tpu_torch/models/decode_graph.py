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

Each replay records two counters (``utils/trace.py``), since no Python runs
inside it: ``decode.blocks_run``, the DiffNet residual blocks the graph
runs (the decoder's denoiser calls x its L blocks), and
``decode.blocks_fused``, those of them captured on the fused block path
(``DiffNet.fuses`` at the capture): the same number, or 0.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from promptttspp_tpu_torch.models.diffusion import GaussianDiffusion
from promptttspp_tpu_torch.utils import trace


class _Graph:
    """One captured decode of ``decoder`` at cond shape [B, T, H]."""

    def __init__(self, decoder: GaussianDiffusion, B: int, T: int, H: int,
                 device: torch.device, pool):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.decoder = decoder
        self.cond = torch.zeros((B, T, H), device=device)
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
        net = decoder.denoise_fn
        self.blocks_run = decoder.n_denoiser_calls() * len(
            net.residual_layers)
        fused = decoder.pipeline is None and net.fuses(self.cond)
        self.blocks_fused = self.blocks_run if fused else 0
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        self.done = torch.cuda.Event()
        self.shape = (B, T)
        self.capture_s = time.perf_counter() - t0
        self.buffer_bytes = (self.cond.nbytes + self.draws.nbytes
                             + self.out.nbytes)
        # the device memory the process holds more after the capture
        self.reserved_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self, cond, x_T, zero_noise, generator):
        torch.cuda.current_stream(cond.device).wait_event(self.done)
        self.cond.copy_(cond)
        self.decoder.fill_draws(self.draws, x_T, zero_noise, generator)
        self.graph.replay()
        out = self.out.clone()
        self.done.record()
        trace.count("decode.blocks_run", self.blocks_run)
        trace.count("decode.blocks_fused", self.blocks_fused)
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
    tensor as the replay of the graph of cond's shape (captured now if it
    is new), on a CPU tensor eager."""
    if cond.device.type == "cpu":
        return decoder.inference(cond, x_T, zero_noise, generator)
    if cond.dtype != torch.float32 or cond.dim() != 3:
        raise ValueError(f"decode takes float32 cond [B, T, H], got "
                         f"{cond.dtype} {tuple(cond.shape)}")
    B, T, H = cond.shape
    with torch.inference_mode():
        graphs = _graphs(decoder)
        key = (cond.device, B, T)
        graph = graphs.by_shape.get(key)
        if graph is None:
            if graphs.pool is None:
                graphs.pool = torch.cuda.graph_pool_handle()
            with trace.span("decode_graph.capture"):
                graph = _Graph(decoder, B, T, H, cond.device, graphs.pool)
            graphs.by_shape[key] = graph
        if x_T is not None:
            x_T = x_T.to(device=cond.device, dtype=torch.float32)
        return graph.replay(cond, x_T, zero_noise, generator)


def captured(decoder: GaussianDiffusion) -> List[Dict]:
    """Each graph of ``decoder`` in the order of capture: B, T, capture
    seconds, the bytes of its static buffers and output, and the growth of
    the device memory the process holds across the capture."""
    return [dict(B=g.shape[0], T=g.shape[1], capture_s=g.capture_s,
                 buffer_bytes=g.buffer_bytes,
                 reserved_bytes=g.reserved_bytes)
            for g in _graphs(decoder).by_shape.values()]
