"""The reference's torch checkpoints -> the port's modules.

Counterpart of ``promptttspp_tpu/compat/torch_ckpt.py``. The port's modules
carry the reference's ``state_dict`` names, so a checkpoint loads by name:

- Weight norm: each ``<name>.weight_g`` / ``<name>.weight_v`` pair is folded
  into ``<name>.weight`` = g * v / ||v||, the norm over all dims but 0 in
  float64, as JAX folds it: Conv1d's [out, in, K] and ConvTranspose1d's
  [in, out, K] alike (the reference normalises both over dim 0's slices).
- Shapes: a tensor whose shape differs from the port's only in dims of size
  1 (the reference's [1, C, 1] snake ``alpha`` and predictor LayerNorm
  ``gamma``/``beta`` against the port's [C]) is reshaped; any other
  mismatch raises.
- Buffers the reference stores and the port derives are checked against
  the port's own values and then dropped: the anti-aliasing ``filter``
  taps, the diffusion tables (``decoder.betas`` ...) and BERT's
  ``position_ids``. A disagreement raises.
- Dropped without a check: BERT's pooler, which inference does not read.
  BatchNorm's ``num_batches_tracked`` loads where present; a file without
  it keeps the port's.
- A parameter or buffer of the port that the file lacks raises, naming the
  keys; so does a key of the file that the port has no place for.

Files: the reference trainer's ``{epoch, model, optimizer, ...}`` (the
port's trainer writes it too, as ``ckpt/last`` and ``ckpt/epoch-NNNN``),
the vocoder's ``{generator: ...}``, a bare state dict (``.ckpt``, ``.pth``,
``.pt`` or no suffix; unpickled, so load only files you trust), an
``.npz`` of name -> array, or an ``.npz`` of a JAX-trained model written by
``scripts/orbax_to_npz.py`` (keys ``params/...`` and ``batch_stats/...``,
mapped by ``compat/from_jax.py::jax_params_to_state_dict``). A directory is
an orbax checkpoint, which the port cannot read: convert it with that
script first.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from promptttspp_tpu_torch.compat.from_jax import jax_params_to_state_dict
from promptttspp_tpu_torch.models.bert import BertEmbeddings, BertModel
from promptttspp_tpu_torch.models.diffusion import (
    GaussianDiffusion, schedule_tables)
from promptttspp_tpu_torch.vocoders.activations import (
    AntiAliasActivation, kaiser_sinc_filter1d)

# the vocoder's convolutions that carry weight norm in the reference
# (BigVGAN's conv_pre, upsamples, AMPBlock convs and conv_post)
BIGVGAN_WEIGHT_NORMED = re.compile(
    r"^(conv_pre|upsamples\.\d+|mrfs\.\d+\.\d+\.layers\.\d+\.conv[12]"
    r"|conv_post)\.weight$")


# a derived buffer's largest difference from the port's value, absolute and
# relative: float32 rounding of the same float64 formula (the AA taps
# differ by up to 3e-8)
DERIVED_TOL = 1e-6


def fold_weight_norm(g, v) -> np.ndarray:
    """w = g * v / ||v|| with the norm over all dims except 0, in float64;
    the result has v's dtype."""
    g, v = np.asarray(g), np.asarray(v)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes,
                          keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(
        v.dtype)


def torch_state_dict(path, kind: str = "model") -> Dict[str, torch.Tensor]:
    """A checkpoint file -> name -> tensor on the CPU. ``kind`` "model"
    takes the file's ``model`` entry, any other kind its ``generator``
    entry; a file without that entry is the state dict itself."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of a JAX-trained "
            "model): convert it with `python scripts/orbax_to_npz.py "
            f"{path} <out.npz>` where orbax is installed, and pass the .npz")
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
        if any(k.startswith("params/") for k in arrays):
            return jax_params_to_state_dict(unflatten_jax_npz(arrays))
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    if path.suffix not in (".ckpt", ".pth", ".pt", ""):
        raise ValueError(f"unsupported checkpoint {path}: .ckpt, .pth, .pt, "
                         ".npz or no suffix (the trainer's ckpt/last)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    key = "model" if kind == "model" else "generator"
    return dict(ckpt[key] if key in ckpt else ckpt)


def unflatten_jax_npz(arrays: Mapping[str, np.ndarray]) -> Dict:
    """The flat ``params/...`` and ``batch_stats/...`` arrays of
    ``scripts/orbax_to_npz.py`` -> {"params": tree, "batch_stats": tree}
    (nested dicts); any other key raises."""
    out: Dict = {}
    for key, value in arrays.items():
        top, *path = key.split("/")
        if top not in ("params", "batch_stats") or not path:
            raise ValueError(f"{key}: not a params/ or batch_stats/ array")
        node = out.setdefault(top, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def derived_buffers(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The buffers a reference checkpoint of ``module`` stores that the
    port computes instead, at the port's values."""
    out = {}
    for prefix, m in module.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, AntiAliasActivation):
            taps = kaiser_sinc_filter1d(0.5 / 2, 0.6 / 2, 12)[None, None]
            out[f"{p}up.filter"] = out[f"{p}down.lowpass.filter"] = taps
        elif isinstance(m, GaussianDiffusion):
            tables = schedule_tables(m.K_step,
                                     m.options["schedule_type"])
            out.update({p + k: v.astype(np.float32)
                        for k, v in tables.items()})
        elif isinstance(m, BertEmbeddings):
            n = m.position_embeddings.num_embeddings
            out[f"{p}position_ids"] = np.arange(n)[None]
    return out


def _unread_prefixes(module: torch.nn.Module):
    return tuple(f"{prefix}.pooler." if prefix else "pooler."
                 for prefix, m in module.named_modules()
                 if isinstance(m, BertModel))


def _squeezed(shape):
    return tuple(d for d in shape if d != 1)


def fold_all(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every weight_g / weight_v pair folded."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("weight_v"):
            continue
        if k.endswith("weight_g"):
            base = k[: -len("_g")]
            if base + "_v" not in state_dict:
                raise ValueError(f"{k} without {base}_v")
            out[base] = torch.from_numpy(fold_weight_norm(
                state_dict[k], state_dict[base + "_v"]))
        else:
            out[k] = torch.as_tensor(v)
    return out


def load_reference_state_dict(module: torch.nn.Module,
                              state_dict: Mapping) -> torch.nn.Module:
    """Load a reference state dict into ``module`` (the rules of the module
    docstring)."""
    sd = fold_all(state_dict)
    own = module.state_dict()
    derived = derived_buffers(module)
    unread = _unread_prefixes(module)
    loaded, unknown = {}, []
    for k, v in sd.items():
        if k in own:
            want = own[k]
            if tuple(v.shape) != tuple(want.shape):
                if _squeezed(v.shape) != _squeezed(want.shape):
                    raise ValueError(
                        f"shape mismatch at {k}: checkpoint "
                        f"{tuple(v.shape)}, port {tuple(want.shape)}")
                v = v.reshape(want.shape)
            loaded[k] = v.to(want.dtype)
        elif k in derived:
            ref = derived[k]
            got = v.numpy()
            if _squeezed(got.shape) != _squeezed(ref.shape) or not np.allclose(
                    got.reshape(ref.shape), ref, rtol=DERIVED_TOL,
                    atol=DERIVED_TOL):
                raise ValueError(f"{k}: the checkpoint's values differ from "
                                 "those the port derives")
        elif not k.startswith(unread):
            unknown.append(k)
    missing = sorted(k for k in own if k not in loaded
                     and not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} keys of the "
                         f"port: {missing[:8]}")
    if unknown:
        raise ValueError(f"checkpoint has {len(unknown)} keys the port has "
                         f"no place for: {sorted(unknown)[:8]}")
    module.load_state_dict({**own, **loaded}, strict=True)
    return module


def to_reference_state_dict(
        module: torch.nn.Module,
        weight_normed: Optional[Callable[[str], bool]] = None
) -> Dict[str, torch.Tensor]:
    """``module``'s weights in the reference's checkpoint layout: its state
    dict plus the derived buffers, with each ``weight`` for which
    ``weight_normed(key)`` holds split into ``weight_g`` (the norm over all
    dims but 0) and ``weight_v`` (the weight)."""
    out = {}
    for k, v in module.state_dict().items():
        v = v.detach().cpu()
        if weight_normed is not None and weight_normed(k):
            dims = tuple(range(1, v.ndim))
            out[k + "_g"] = torch.sqrt(torch.sum(
                v.double() ** 2, dim=dims, keepdim=True)).to(v.dtype)
            out[k + "_v"] = v.clone()
        else:
            out[k] = v.clone()
    out.update({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in derived_buffers(module).items()})
    return out
