"""Construction of the flagship model and vocoder.

The widths are Python constants copied from
``conf/model/prompttts_mdn_v2_wo_erg_final.yaml`` (``MODEL``, interpolations
resolved, ``_target_`` keys dropped) and ``conf/vocoder/bigvgan_f0.yaml``
(``VOCODER``), because the machine with the GPU reads no YAML; a CPU test
holds them equal to the YAML files. ``build_model`` builds the port's
modules from a config of that shape (the flagship's or a smaller one) with
seeded random weights; real checkpoints load through
``compat/from_jax.py``.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np
import torch

from promptttspp_tpu_torch.models.bert import BertConfig
from promptttspp_tpu_torch.models.diffusion import DiffNet, GaussianDiffusion
from promptttspp_tpu_torch.models.frame_prior import FramePriorNetwork
from promptttspp_tpu_torch.models.phoneme_embedding import PhonemeEmbedding
from promptttspp_tpu_torch.models.prompt_encoder import PromptEncoder
from promptttspp_tpu_torch.models.prompttts import PromptTTSMDNDurCFG
from promptttspp_tpu_torch.models.variance_adaptor import (
    MDNPredictor, Predictor, VarianceAdaptor)
from promptttspp_tpu_torch.nn.conformer import ConformerEncoder
from promptttspp_tpu_torch.nn.layers import Conv1d
from promptttspp_tpu_torch.nn.mdn import MDNLayer
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN

MODEL = {
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
            "channels": 256, "out_channels": 1, "kernel_size": 3,
            "dropout": 0.5, "num_layers": 2, "num_gaussians": 4,
            "detach": True, "disable_amp": True},
        "pitch_predictor": {
            "channels": 256, "out_channels": 2, "kernel_size": 5,
            "dropout": 0.5, "num_layers": 5, "detach": False},
        "pitch_emb": {"in_channels": 1, "out_channels": 256,
                      "kernel_size": 1},
        "energy_predictor": None,
        "energy_emb": None,
        "frame_prior_network": {
            "out_channels": 256, "hidden_channels": 256, "n_layers": 6,
            "kernel_size": 17, "p_dropout": 0.1}},
    "reference_encoder": {
        "idim": 80, "gst_tokens": 10, "gst_heads": 4, "conv_layers": 6,
        "conv_chans_list": [128, 128, 256, 256, 512, 512],
        "conv_kernel_size": 3, "conv_stride": 2, "gru_layers": 1,
        "gru_units": 256},
    "prompt_encoder": {"model_name": "bert-base-uncased", "in_channels": 768,
                       "mid_channels": 512, "out_channels": 256},
    "style_mdn": {"in_dim": 256, "out_dim": 256, "num_gaussians": 10,
                  "dim_wise": True},
    "decoder": {
        "in_dim": 256, "out_dim": 80, "norm_scale": 6.0,
        "denoise_fn": {
            "in_dim": 80, "encoder_hidden_dim": 256, "residual_layers": 20,
            "residual_channels": 256, "kernel_size": 3,
            "dilation_cycle_length": 4}},
}

VOCODER = {
    "sampling_rate": 24000, "harmonic_num": 8, "in_channel": 80,
    "upsample_initial_channel": 512, "upsample_rates": [6, 5, 4, 2],
    "upsample_kernel_sizes": [12, 10, 8, 4],
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}

# bert-base-uncased (prompt_encoder.model_name)
BERT_BASE = BertConfig()


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
# (the flagship's); dropout rates and init options do not apply in eval.
_FIXED = {
    (): dict(norm_style_emb=True, mdn_disable_amp=True),
    ("phoneme_embedding",): dict(do_scale=False),
    ("encoder",): dict(
        positionwise_layer_type="conv1d", pos_enc_layer_type="rel_pos",
        selfattention_layer_type="rel_selfattn", rel_pos_type="new",
        macaron_style=True, use_cnn_module=True, activation_type="swish",
        return_mask=False),
    ("variance_adaptor",): dict(energy_predictor=None, energy_emb=None),
    ("style_mdn",): dict(dim_wise=True),
}


def _check_fixed(cfg: Mapping, bert_config: BertConfig):
    for path, fixed in _FIXED.items():
        section = cfg
        for key in path:
            section = section[key]
        for key, value in fixed.items():
            if section.get(key, value) != value:
                raise ValueError(f"model config {'.'.join(path + (key,))}="
                                 f"{section[key]!r} is not ported")
    enc = cfg["encoder"]
    if enc["idim"] != enc["attention_dim"]:
        raise ValueError("encoder idim != attention_dim is not ported")
    if cfg["prompt_encoder"]["in_channels"] != bert_config.hidden_size:
        raise ValueError("prompt_encoder.in_channels != BERT hidden size")


def _model_from_config(cfg: Mapping, bert_config: BertConfig):
    _check_fixed(cfg, bert_config)
    pe, enc, va = (cfg["phoneme_embedding"], cfg["encoder"],
                   cfg["variance_adaptor"])
    dp, pp, fp = (va["duration_predictor"], va["pitch_predictor"],
                  va["frame_prior_network"])
    dec, dn = cfg["decoder"], cfg["decoder"]["denoise_fn"]
    pr, sm = cfg["prompt_encoder"], cfg["style_mdn"]
    return PromptTTSMDNDurCFG(
        phoneme_emb=PhonemeEmbedding(pe["num_vocab"], pe["channels"]),
        encoder=ConformerEncoder(
            enc["attention_dim"], enc["attention_heads"],
            enc["linear_units"], enc["num_blocks"],
            enc["positionwise_conv_kernel_size"], enc["cnn_module_kernel"]),
        variance_adaptor=VarianceAdaptor(
            duration_predictor=MDNPredictor(
                dp["channels"], dp["out_channels"], dp["kernel_size"],
                dp["num_layers"], dp["num_gaussians"]),
            pitch_predictor=Predictor(pp["channels"], pp["out_channels"],
                                      pp["kernel_size"], pp["num_layers"]),
            pitch_emb=Conv1d(va["pitch_emb"]["in_channels"],
                             va["pitch_emb"]["out_channels"],
                             va["pitch_emb"]["kernel_size"]),
            frame_prior_network=FramePriorNetwork(
                fp["hidden_channels"], fp["n_layers"], fp["kernel_size"])),
        prompt_encoder=PromptEncoder(bert_config, pr["mid_channels"],
                                     pr["out_channels"]),
        decoder=GaussianDiffusion(
            DiffNet(dn["in_dim"], dn["encoder_hidden_dim"],
                    dn["residual_layers"], dn["residual_channels"],
                    dn["kernel_size"], dn["dilation_cycle_length"]),
            out_dim=dec["out_dim"], norm_scale=dec["norm_scale"],
            K_step=dec.get("K_step", 100)),
        style_mdn=MDNLayer(sm["in_dim"], sm["out_dim"], sm["num_gaussians"]),
    )


def build_model(cfg: Mapping = MODEL, device="cuda", seed: int = 0,
                bert_config: BertConfig = BERT_BASE):
    """PromptTTS++ (prompt branch) from a config of ``MODEL``'s shape, with
    random weights drawn from ``seed``, in eval mode on ``device``."""
    dev = resolve_device(device)
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
