"""Seeded weights for a model, made by the benchmark on the device.

Every floating parameter of a module is drawn from one generator on the
module's device, in one call, in sorted name order, and scaled by a rule
on its shape and its owner's kind, torch's default initialisation in
spirit:

- the scale and shift of a normalisation layer (an owner whose class name
  holds "Norm"): 1 + 0.1 u and 0.1 u;
- a tensor of two or more dimensions: u / sqrt(fan_in), fan_in the product
  of its dimensions after the first (torch's convention, a transposed
  convolution's included);
- any other vector (a bias, a Snake alpha): u / sqrt(fan_in) of the first
  tensor of two or more dimensions of its owner, else 0.1 u;

with u uniform in [-1, 1). ``pins`` then set named tensors to constants.
The program's model and the reference's frozen copy have the same names,
shapes and owner kinds, so the same seed gives both the same values.
Buffers (BatchNorm statistics, tables) are left as each side built them.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def sub_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for tag in tags:
        words.extend(tag.encode())
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def _scales(module: torch.nn.Module):
    """-> [(name, parameter, scale, shift)] in sorted name order."""
    owners = dict(module.named_modules())
    rows = []
    for name, p in sorted(module.named_parameters()):
        if not p.is_floating_point():
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = owners[owner_name]
        if "Norm" in type(owner).__name__ and p.dim() == 1:
            shift = 1.0 if leaf in ("weight", "gamma") else 0.0
            rows.append((name, p, 0.1, shift))
        elif p.dim() >= 2:
            rows.append((name, p, 1.0 / math.sqrt(p[0].numel()), 0.0))
        else:
            wide = [q for _, q in owner.named_parameters(recurse=False)
                    if q.dim() >= 2]
            scale = 1.0 / math.sqrt(wide[0][0].numel()) if wide else 0.1
            rows.append((name, p, scale, 0.0))
    return rows


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int,
         pins: Optional[Mapping[str, float]] = None) -> Dict[str, int]:
    """Overwrite ``module``'s floating parameters from ``seed`` (module
    docstring); returns {"tensors", "elements"}."""
    rows = _scales(module)
    device = rows[0][1].device
    sizes = [p.numel() for _, p, _, _ in rows]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([r[2] for r in rows], device=device), counts)
    shift = torch.repeat_interleave(
        torch.tensor([r[3] for r in rows], device=device), counts)
    flat = shift + scale * (2.0 * u - 1.0)
    del u, scale, shift
    params = [p for _, p, _, _ in rows]
    parts = [part.view_as(p) for part, p in zip(flat.split(sizes), params)]
    torch._foreach_copy_(params, parts)
    named = {name: p for name, p, _, _ in rows}
    for name, value in (pins or {}).items():
        if name not in named:
            raise KeyError(f"pinned weight {name!r} is not a parameter")
        named[name].fill_(float(value))
    return {"tensors": len(rows), "elements": int(sum(sizes))}
