"""JAX parameter trees -> the port's ``state_dict``.

The inverse of ``promptttspp_tpu/compat/torch_ckpt.py::convert_tree``,
written out here (the port imports nothing of the JAX package). Input is
``{"params": tree, "batch_stats": tree}`` of numpy-convertible leaves, as
``flax`` returns them from ``init``; output maps the reference's torch
names to tensors.

Path rules: flax list modules ``name_N`` become ``name.N`` for the
reference's ModuleList and Sequential names (the ESPnet suite's
``decoders``, ``embed``, ``conv`` and ``out`` among them), the U-Net's
nested ``downs_I_J`` / ``ups_I_J`` become ``downs.I.J``, and the names
that flax joins with an underscore where the reference nests two modules
(``mid_attn_fn``, the VITS block's ``attention_norm`` ...) are split; the
flagship's
two renamed subtrees are the phoneme embedding (``phoneme_embedding`` ->
``phoneme_emb``) and BERT (flat flax names -> Hugging Face
``bert.model.*`` names, under a prompt encoder or either half of
``SepPromptEncoder``). Leaf rules:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``
- Conv1d ``kernel [K, in/g, out]`` -> ``weight [out, in/g, K]``
- Conv2d ``kernel [kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``
- ConvTranspose ``kernel_t [K, in, out]`` -> ``weight [in, out, K]``
- LayerNorm/BatchNorm/GroupNorm ``scale`` -> ``weight`` (a ``scale``
  beside submodules, ConvNeXt's layer scale, keeps its name);
  ``embedding`` -> ``weight``
- batch_stats ``mean``/``var`` -> ``running_mean``/``running_var`` (plus
  torch's ``num_batches_tracked``)
- everything else (bias, gamma, beta, alpha, pos_bias_u/v, the GRU's
  torch-named ``weight_ih_l0`` ..., ``gst_embs``) by name
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# the reference's ModuleList names among the ported modules
_LIST_MODULES = {"encoders", "layers", "convs", "norms", "upsamples", "mrfs",
                 "noise_convs", "mlp", "adaptor", "residual_layers",
                 "decoders", "embed", "conv", "out", "blocks", "flows",
                 "in_block", "mid_block", "out_block", "net", "time_mlp",
                 "to_out"}
# the U-Net's lists of lists: downs_0_3_fn -> downs.0.3.fn
_NESTED_LISTS = ("downs_", "ups_")
# flax names that join two of the reference's module names
_JOINED = {"mid_attn_fn": "mid_attn.fn",
           "attention_attention_layer": "attention.attention_layer",
           "attention_norm": "attention.norm", "ffn_ffn": "ffn.ffn",
           "ffn_norm": "ffn.norm"}
# the modules that hold a BERT as ``bert`` (the prompt encoder, and the two
# halves of ``SepPromptEncoder``)
_BERT_OWNERS = {"prompt_encoder", "style_enc", "spk_enc"}
# subtrees of the JAX model that the port does not have: none
NOT_PORTED = ()

_BERT_PARTS = {
    "attention_self": "attention.self",
    "attention_output_dense": "attention.output.dense",
    "attention_output_LayerNorm": "attention.output.LayerNorm",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
    "output_LayerNorm": "output.LayerNorm",
}


def _part(p: str) -> str:
    if p in _JOINED:
        return _JOINED[p]
    if p.startswith(_NESTED_LISTS) and p.split("_")[1].isdigit():
        return p.replace("_", ".")
    head, _, tail = p.rpartition("_")
    if tail.isdigit() and head in _LIST_MODULES:
        return f"{head}.{tail}"
    return p


def _bert_parts(parts):
    out = ["model"]
    for p in parts:
        if p.startswith("embeddings_"):
            out.append("embeddings." + p[len("embeddings_"):])
        elif p.startswith("encoder_layer_"):
            out.append("encoder.layer." + p[len("encoder_layer_"):])
        else:
            out.append(_BERT_PARTS.get(p, p))
    return out


def torch_module_key(path: Tuple[str, ...]) -> str:
    """flax module path (without the leaf) -> torch module name."""
    parts = list(path)
    if parts[:1] == ["phoneme_embedding"]:
        parts[0] = "phoneme_emb"
    for i in range(len(parts) - 1):
        if parts[i] in _BERT_OWNERS and parts[i + 1] == "bert":
            return ".".join([_part(p) for p in parts[:i + 2]]
                            + _bert_parts(parts[i + 2:]))
    return ".".join(_part(p) for p in parts)


def _leaves(tree, path=(), parent=None
            ) -> Iterable[Tuple[Tuple[str, ...], np.ndarray, Mapping]]:
    """(path, array, the mapping that holds it) of every leaf."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if not path and k in NOT_PORTED:
                continue
            yield from _leaves(v, path + (str(k),), tree)
    else:
        yield path, np.asarray(tree), parent


def _param(name: str, arr: np.ndarray,
           parent: Mapping = None) -> Tuple[str, np.ndarray]:
    """The torch name and layout of the leaf ``name`` of ``parent``."""
    if name == "scale" and parent is not None and any(
            isinstance(v, Mapping) for v in parent.values()):
        return name, arr  # beside submodules: ConvNeXt's layer scale
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", arr.transpose(2, 1, 0)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.shape}")
    if name == "kernel_t":
        return "weight", arr.transpose(1, 2, 0)
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def jax_params_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} (flax trees) -> port state_dict.
    Subtrees the port does not have yet (``NOT_PORTED``) are left out."""
    sd = {}
    for path, arr, parent in _leaves(variables.get("params", {})):
        name, val = _param(path[-1], arr, parent)
        sd[f"{torch_module_key(path[:-1])}.{name}".lstrip(".")] = \
            torch.from_numpy(np.array(val))
    for path, arr, _ in _leaves(variables.get("batch_stats", {})):
        base = torch_module_key(path[:-1])
        names = {"mean": "running_mean", "var": "running_var"}
        if path[-1] not in names:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[f"{base}.{names[path[-1]]}"] = torch.from_numpy(np.array(arr))
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_jax_variables(module: torch.nn.Module, variables: Mapping):
    """Load converted JAX variables into ``module``; every parameter and
    buffer must match, with no key missing or left over."""
    module.load_state_dict(jax_params_to_state_dict(variables), strict=True)
    return module
