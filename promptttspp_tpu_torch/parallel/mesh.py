"""Device meshes and the zero-weight row padding of data parallelism.

Counterpart of ``promptttspp_tpu/parallel/mesh.py`` (``make_mesh``,
``pad_batch_to_rows``, ``pad_batch_to_multiple``). A ``Mesh`` is a
[data, model] grid of ``torch.device``s for the serving paths that spread
one request over devices (``parallel/sp.py``,
``vocoders/streaming.py::vocode_sharded``); training spreads its batch
over processes instead (``parallel/distributed.py``). The model axis holds
the devices that one request's pipelined decode spreads its stages over
(``parallel/pp.py``); in training, the model axis is a process group
instead (``parallel/distributed.py::ModelGroup``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

class Mesh:
    """A [data, model] grid of devices; ``shape`` is {"data": D, "model":
    M}. A device may appear more than once: two shards on one device run
    one after the other."""

    def __init__(self, devices):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError(f"a mesh needs a non-empty [data, model] grid, "
                             f"got {devices!r}")
        self.devices = grid
        self.shape = {"data": len(grid), "model": len(grid[0])}

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard, in order."""
        return [row[0] for row in self.devices]

    def model_devices(self, d: int = 0) -> List[torch.device]:
        """The devices of data row ``d`` along the model axis, in order."""
        return list(self.devices[d])

    def __repr__(self):
        return f"Mesh({self.devices}, shape={self.shape})"


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None,
              model_spans_processes: bool = False) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device; none raises), all on the data axis unless ``data`` or
    ``model`` says how many. The devices fold row by row into [data,
    model] (device ``d * model + m`` at (d, m)); ``model_spans_processes``
    transposes the fold (device ``m * data + d``), as JAX's does, so that
    with devices ordered by process the model axis crosses them."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh() found no CUDA device; pass "
                               "devices=[...] (e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if data is None:
        data = len(devices) // model
    if data * model != len(devices):
        raise ValueError(f"{data}x{model} != {len(devices)} devices")
    if model_spans_processes:
        return Mesh([[devices[m * data + d] for m in range(model)]
                     for d in range(data)])
    return Mesh([devices[i * model:(i + 1) * model] for i in range(data)])


def canonical(device) -> torch.device:
    """``device`` with its index: a device named without one ("cuda",
    "cpu") is the current CUDA device, or the CPU's 0."""
    d = torch.device(device)
    if d.index is not None:
        return d
    return torch.device(d.type, torch.cuda.current_device()
                        if d.type == "cuda" else 0)


def replicas(module: nn.Module,
             devices: Sequence) -> Dict[torch.device, nn.Module]:
    """One copy of ``module`` per distinct device of ``devices`` (the
    module itself on its own device, named with or without its index), in
    eval mode: the per-device replicas of the serving paths that spread
    over a mesh."""
    home = canonical(next(module.parameters()).device)
    out = {}
    for d in map(torch.device, devices):
        if d not in out:
            out[d] = module if canonical(d) == home else \
                copy.deepcopy(module).to(d).eval()
    return out


def pad_batch_to_rows(batch: Dict, rows: int) -> Dict:
    """Pad the batch's leading axis to exactly ``rows`` with zero rows.

    Pad rows keep 1-frame and 1-phone lengths, so every mask stays valid,
    and carry ``batch_weight`` 0 (real rows keep theirs, 1 by default), so
    every loss and BatchNorm statistic leaves them out."""
    b = len(batch["phone_lengths"])
    if rows < b:
        raise ValueError(f"cannot pad {b} rows down to {rows}")
    pad = rows - b
    weight = batch.get("batch_weight", np.ones((b,), np.float32))
    if pad == 0:
        out = dict(batch)
        out["batch_weight"] = weight
        return out
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == b:
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
        else:
            out[k] = v
    out["phone_lengths"][b:] = 1
    out["frame_lengths"][b:] = 1
    out["batch_weight"] = np.concatenate(
        [weight, np.zeros((pad,), np.float32)])
    return out


def pad_batch_to_multiple(batch: Dict, multiple: int) -> Dict:
    """Pad the batch's leading axis to a multiple of ``multiple`` (see
    ``pad_batch_to_rows``)."""
    b = len(batch["phone_lengths"])
    return pad_batch_to_rows(batch, b + (-b) % multiple)
