"""Construction of the flagship model, the demo model and the vocoder.

The widths are Python constants copied from
``conf/model/prompttts_mdn_v2_wo_erg_final.yaml`` (``MODEL_YAML`` as
written, ``_target_`` keys dropped; ``MODEL`` with the interpolations
resolved), its ``_demo`` variant (``MODEL_DEMO_YAML``, ``MODEL_DEMO``:
legacy relative positions, as the published demo checkpoint was trained)
and ``conf/vocoder/bigvgan_f0.yaml`` (``VOCODER``), because the machine with
the GPU reads no YAML; a CPU test holds them equal to the YAML files.
``build_model`` builds the port's modules from a config of that shape (the
flagship's or a smaller one) with seeded random weights; trained weights
load through ``compat/torch_ckpt.py`` (the reference's torch checkpoints)
or ``compat/from_jax.py`` (a JAX parameter tree).
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch

from promptttspp_tpu_torch.config import resolve
from promptttspp_tpu_torch.models.bert import BertConfig
from promptttspp_tpu_torch.models.diffusion import DiffNet, GaussianDiffusion
from promptttspp_tpu_torch.models.frame_prior import FramePriorNetwork
from promptttspp_tpu_torch.models.phoneme_embedding import PhonemeEmbedding
from promptttspp_tpu_torch.models.prompt_encoder import PromptEncoder
from promptttspp_tpu_torch.models.prompttts import PromptTTSMDNDurCFG
from promptttspp_tpu_torch.models.style_encoder import StyleEncoder
from promptttspp_tpu_torch.models.variance_adaptor import (
    MDNPredictor, Predictor, VarianceAdaptor)
from promptttspp_tpu_torch.nn.conformer import ConformerEncoder
from promptttspp_tpu_torch.nn.layers import Conv1d
from promptttspp_tpu_torch.nn.mdn import MDNLayer
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN

# conf/model/prompttts_mdn_v2_wo_erg_final.yaml as written (interpolations
# kept, so an override of a width moves the widths that follow it)
MODEL_YAML = {
    "norm_style_emb": True,
    "mdn_disable_amp": True,
    "phoneme_embedding": {"num_vocab": 90, "channels": 256,
                          "do_scale": False, "init_normal": False},
    "encoder": {
        "idim": 256, "attention_dim": 256, "attention_heads": 2,
        "linear_units": 1024, "num_blocks": 4,
        "positionwise_layer_type": "conv1d",
        "positionwise_conv_kernel_size": 9, "dropout_rate": 0.2,
        "pos_enc_layer_type": "rel_pos",
        "selfattention_layer_type": "rel_selfattn",
        "activation_type": "swish", "macaron_style": True,
        "use_cnn_module": True, "cnn_module_kernel": 7,
        "return_mask": False, "rel_pos_type": "new"},
    "variance_adaptor": {
        "duration_predictor": {
            "channels": "${...phoneme_embedding.channels}",
            "out_channels": 1, "kernel_size": 3, "dropout": 0.5,
            "num_layers": 2, "num_gaussians": 4, "detach": True,
            "disable_amp": "${...mdn_disable_amp}"},
        "pitch_predictor": {
            "channels": "${...phoneme_embedding.channels}",
            "out_channels": 2, "kernel_size": 5,
            "dropout": "${..duration_predictor.dropout}", "num_layers": 5,
            "detach": False},
        "pitch_emb": {"in_channels": 1,
                      "out_channels": "${...phoneme_embedding.channels}",
                      "kernel_size": 1},
        "energy_predictor": None,
        "energy_emb": None,
        "frame_prior_network": {
            "out_channels": "${...phoneme_embedding.channels}",
            "hidden_channels": "${...phoneme_embedding.channels}",
            "n_layers": 6, "kernel_size": 17, "p_dropout": 0.1}},
    "reference_encoder": {
        "idim": 80, "gst_tokens": 10, "gst_heads": 4, "conv_layers": 6,
        "conv_chans_list": [128, 128, 256, 256, 512, 512],
        "conv_kernel_size": 3, "conv_stride": 2, "gru_layers": 1,
        "gru_units": "${..phoneme_embedding.channels}"},
    "prompt_encoder": {"model_name": "bert-base-uncased", "in_channels": 768,
                       "mid_channels": 512,
                       "out_channels": "${..phoneme_embedding.channels}"},
    "style_mdn": {"in_dim": "${..phoneme_embedding.channels}",
                  "out_dim": "${..phoneme_embedding.channels}",
                  "num_gaussians": 10, "dim_wise": True},
    "decoder": {
        "in_dim": "${..encoder.attention_dim}", "out_dim": 80,
        "norm_scale": 6.0,
        "denoise_fn": {
            "in_dim": 80,
            "encoder_hidden_dim": "${...phoneme_embedding.channels}",
            "residual_layers": 20, "residual_channels": 256,
            "kernel_size": 3, "dilation_cycle_length": 4}},
}
# its _demo variant (conf/model/prompttts_mdn_v2_wo_erg_final_demo.yaml)
MODEL_DEMO_YAML = copy.deepcopy(MODEL_YAML)
MODEL_DEMO_YAML["encoder"]["rel_pos_type"] = "legacy"
# both with the interpolations resolved
MODEL = resolve(MODEL_YAML)
MODEL_DEMO = resolve(MODEL_DEMO_YAML)

VOCODER = {
    "sampling_rate": 24000, "harmonic_num": 8, "in_channel": 80,
    "upsample_initial_channel": 512, "upsample_rates": [6, 5, 4, 2],
    "upsample_kernel_sizes": [12, 10, 8, 4],
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}

# bert-base-uncased (prompt_encoder.model_name)
BERT_BASE = BertConfig()


def bert_config_of(prompt_encoder: Mapping) -> BertConfig:
    """The BERT that JAX's PromptEncoder builds from its config fields:
    hidden size ``in_channels``, ``bert_num_layers`` and ``bert_num_heads``
    (12 each by default), intermediate size 4 x hidden."""
    hidden = prompt_encoder["in_channels"]
    return BertConfig(
        hidden_size=hidden,
        num_hidden_layers=prompt_encoder.get("bert_num_layers", 12),
        num_attention_heads=prompt_encoder.get("bert_num_heads", 12),
        intermediate_size=4 * hidden)


def _seeded(device: torch.device, seed: int, build):
    """Run ``build`` with torch's RNG seeded, creating tensors on
    ``device``, without disturbing the caller's RNG state."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        with device:
            module = build()
    return module.eval().requires_grad_(False)


# Switches of the model config that the port implements at one value only
# (the flagship's). The init options (phoneme_embedding.init_normal) are not
# read: the port's weights are torch's seeded defaults or a checkpoint's.
_FIXED = {
    (): dict(norm_style_emb=True, mdn_disable_amp=True),
    ("phoneme_embedding",): dict(do_scale=False),
    ("encoder",): dict(
        positionwise_layer_type="conv1d", pos_enc_layer_type="rel_pos",
        selfattention_layer_type="rel_selfattn", macaron_style=True,
        use_cnn_module=True, activation_type="swish", return_mask=False),
    ("variance_adaptor",): dict(energy_predictor=None, energy_emb=None),
    ("style_mdn",): dict(dim_wise=True),
    # The fields of the JAX GaussianDiffusion (promptttspp_tpu/models/
    # diffusion.py) that a config can set, other than the ones
    # _model_from_config reads, at JAX's defaults: no pipelined decode.
    # GaussianDiffusion's in_dim is read by nothing in JAX.
    ("decoder",): dict(pipeline_mesh=None, pipeline_microbatches=None,
                       pipeline_batch_axis=None),
}


# The defaults of the JAX dataclass fields behind the _FIXED keys (JAX's
# PromptTTSMDNDurCFG, PhonemeEmbedding, ConformerEncoder, VarianceAdaptor,
# MDNLayer, GaussianDiffusion): a config that omits a key builds the JAX
# model with these, so the port reads an absent key the same way.
_JAX_DEFAULTS = {
    (): dict(norm_style_emb=False, mdn_disable_amp=False),
    ("phoneme_embedding",): dict(do_scale=True),
    ("encoder",): dict(
        positionwise_layer_type="linear", pos_enc_layer_type="abs_pos",
        selfattention_layer_type="selfattn", macaron_style=False,
        use_cnn_module=False, activation_type="swish", return_mask=False),
    ("variance_adaptor",): dict(energy_predictor=None, energy_emb=None),
    ("style_mdn",): dict(dim_wise=False),
    ("decoder",): dict(pipeline_mesh=None, pipeline_microbatches=None,
                       pipeline_batch_axis=None),
}


def _check_fixed(cfg: Mapping, bert_config: BertConfig):
    """Raise, naming the key, where ``cfg`` (or JAX's default for a key it
    omits) asks for a switch value that the port does not implement."""
    for path, fixed in _FIXED.items():
        section = cfg
        for key in path:
            section = section[key]
        for key, value in fixed.items():
            name = ".".join(path + (key,))
            if key in section:
                if section[key] != value:
                    raise ValueError(f"model config {name}={section[key]!r} "
                                     "is not ported")
            elif _JAX_DEFAULTS[path][key] != value:
                raise ValueError(
                    f"model config {name} is absent: JAX builds its default "
                    f"{_JAX_DEFAULTS[path][key]!r}, which is not ported")
    enc = cfg["encoder"]
    if enc["idim"] != enc["attention_dim"]:
        raise ValueError("encoder idim != attention_dim is not ported")
    if cfg["prompt_encoder"]["in_channels"] != bert_config.hidden_size:
        raise ValueError("prompt_encoder.in_channels != BERT hidden size")


def _model_from_config(cfg: Mapping, bert_config: BertConfig):
    """The port's model of ``cfg``; an absent dropout rate or ``detach``
    is the default of JAX's dataclass field."""
    _check_fixed(cfg, bert_config)
    pe, enc, va = (cfg["phoneme_embedding"], cfg["encoder"],
                   cfg["variance_adaptor"])
    dp, pp, fp = (va["duration_predictor"], va["pitch_predictor"],
                  va["frame_prior_network"])
    dec, dn = cfg["decoder"], cfg["decoder"]["denoise_fn"]
    pr, sm, ref = (cfg["prompt_encoder"], cfg["style_mdn"],
                   cfg["reference_encoder"])
    return PromptTTSMDNDurCFG(
        phoneme_emb=PhonemeEmbedding(pe["num_vocab"], pe["channels"]),
        encoder=ConformerEncoder(
            enc["attention_dim"], enc["attention_heads"],
            enc["linear_units"], enc["num_blocks"],
            enc["positionwise_conv_kernel_size"], enc["cnn_module_kernel"],
            enc.get("rel_pos_type"), enc.get("dropout_rate", 0.1),
            enc.get("positional_dropout_rate", 0.1),
            enc.get("attention_dropout_rate", 0.0)),
        variance_adaptor=VarianceAdaptor(
            duration_predictor=MDNPredictor(
                dp["channels"], dp["out_channels"], dp["kernel_size"],
                dp["num_layers"], dp["num_gaussians"], dp["dropout"],
                dp.get("detach", False)),
            pitch_predictor=Predictor(pp["channels"], pp["out_channels"],
                                      pp["kernel_size"], pp["num_layers"],
                                      pp["dropout"], pp.get("detach", False)),
            pitch_emb=Conv1d(va["pitch_emb"]["in_channels"],
                             va["pitch_emb"]["out_channels"],
                             va["pitch_emb"]["kernel_size"]),
            frame_prior_network=FramePriorNetwork(
                fp["hidden_channels"], fp["n_layers"], fp["kernel_size"],
                fp["p_dropout"], fp.get("pos_enc_p_dropout", 0.1))),
        reference_encoder=StyleEncoder(
            ref["idim"], ref["gst_tokens"], ref.get("gst_token_dim", 256),
            ref["gst_heads"], ref["conv_layers"], ref["conv_chans_list"],
            ref["conv_kernel_size"], ref["conv_stride"], ref["gru_layers"],
            ref["gru_units"]),
        prompt_encoder=PromptEncoder(bert_config, pr["mid_channels"],
                                     pr["out_channels"]),
        decoder=GaussianDiffusion(
            DiffNet(dn["in_dim"], dn["encoder_hidden_dim"],
                    dn["residual_layers"], dn["residual_channels"],
                    dn["kernel_size"], dn["dilation_cycle_length"],
                    dn.get("scale", 1.0)),
            out_dim=dec["out_dim"], norm_scale=dec.get("norm_scale"),
            K_step=dec.get("K_step", 100),
            schedule_type=dec.get("schedule_type", "linear"),
            a_min=dec.get("a_min", 0.0), a_max=dec.get("a_max", 20.0),
            pndm_speedup=dec.get("pndm_speedup"),
            infer_io_dtype=dec.get("infer_io_dtype")),
        style_mdn=MDNLayer(sm["in_dim"], sm["out_dim"], sm["num_gaussians"]),
    )


def build_model(cfg: Mapping = MODEL, device="cuda", seed: int = 0,
                bert_config: Optional[BertConfig] = None):
    """PromptTTS++ (prompt and reference branches) from a config of
    ``MODEL``'s shape, with random weights drawn from ``seed``, in eval mode
    and without gradients on ``device`` (a trainer switches both).
    ``bert_config`` defaults to the BERT that JAX builds from
    ``cfg["prompt_encoder"]`` (``bert_config_of``, JAX's dropout rates)."""
    dev = resolve_device(device)
    if bert_config is None:
        bert_config = bert_config_of(cfg["prompt_encoder"])
    return _seeded(dev, seed, lambda: _model_from_config(cfg, bert_config))


def build_flagship_model(device="cuda", seed: int = 0,
                         frames_per_phone: float = 10.0):
    """The flagship model with its duration head biased so every phone
    lasts ``frames_per_phone`` frames (a 64-phone request then decodes the
    standard 640-frame bucket, 6.4 s of audio)."""
    model = build_model(MODEL, device, seed)
    return bias_duration_head(model, frames_per_phone)


def build_vocoder(device="cuda", seed: int = 1, cfg: Mapping = VOCODER):
    """F0-aware BigVGAN with random weights drawn from ``seed``."""
    dev = resolve_device(device)
    cfg = copy.deepcopy(dict(cfg))
    return _seeded(dev, seed, lambda: F0AwareBigVGAN(**cfg))


@torch.no_grad()
def bias_duration_head(model, frames_per_phone: float = 10.0):
    """Pin the random duration MDN to a constant ``frames_per_phone``: mu
    head -> log(fpp) (zero weight), log_sigma head -> -7."""
    head = model.variance_adaptor.duration_predictor.out_layer
    head.mu.weight.zero_()
    head.mu.bias.fill_(float(np.log(frames_per_phone)))
    head.log_sigma.weight.zero_()
    head.log_sigma.bias.fill_(-7.0)
    return model
