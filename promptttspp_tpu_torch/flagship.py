"""Construction of the flagship model, the demo model and the vocoder.

The widths are Python constants copied from
``conf/model/prompttts_mdn_v2_wo_erg_final.yaml`` (``MODEL_YAML`` as
written, ``_target_`` keys dropped; ``MODEL`` with the interpolations
resolved), its ``_demo`` variant (``MODEL_DEMO_YAML``, ``MODEL_DEMO``:
legacy relative positions, as the published demo checkpoint was trained)
and ``conf/vocoder/bigvgan_f0.yaml`` (``VOCODER``), because the machine with
the GPU reads no YAML; a CPU test holds them equal to the YAML files.
``build_model`` builds the port's modules from a config of that shape (the
flagship's, a smaller one, or one with any of the model's switches at
another value JAX builds; an absent key is JAX's default) with seeded
random weights; trained weights
load through ``compat/torch_ckpt.py`` (the reference's torch checkpoints)
or ``compat/from_jax.py`` (a JAX parameter tree).

F5-TTS v1 Base with Vocos: ``F5TTS_V1_BASE`` and ``VOCOS_MEL_24KHZ`` are
``conf/torch/model/f5tts_v1_base.yaml`` and
``conf/torch/vocoder/vocos_mel_24khz.yaml`` as written (the port's own
configuration groups, which the JAX package does not build), held to
them by a CPU test; ``build_f5tts`` and ``build_vocos`` build the port's
models from them, with seeded random weights.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch

from promptttspp_tpu_torch.config import resolve
from promptttspp_tpu_torch.models.bert import BertConfig
from promptttspp_tpu_torch.models.diffusion import DiffNet, GaussianDiffusion
from promptttspp_tpu_torch.models.f5tts import DiT, F5TTS
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
from promptttspp_tpu_torch.vocoders.vocos import Vocos

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

F5TTS_V1_BASE = {
    "arch": {"dim": 1024, "depth": 22, "heads": 16, "dim_head": 64,
             "ff_mult": 2, "text_dim": 512, "conv_layers": 4,
             "text_num_embeds": 2546},
    "mel_spec": {"target_sample_rate": 24000, "n_mel_channels": 100,
                 "hop_length": 256, "win_length": 1024, "n_fft": 1024,
                 "mel_spec_type": "vocos"},
    "sampler": {"nfe_step": 32, "cfg_strength": 2.0,
                "sway_sampling_coef": -1.0},
    "dtype": "float16",
}

VOCOS_MEL_24KHZ = {"n_mels": 100, "dim": 512, "intermediate_dim": 1536,
                   "num_layers": 8, "n_fft": 1024, "hop_length": 256}

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


# Switches of the model config that a config cannot give the port: the
# pipeline mesh of JAX's GaussianDiffusion (a trainer or Synthesizer sets
# the pipeline; the microbatch count and batch axis are read). The init
# options (phoneme_embedding.init_normal) are not read: the port's weights
# are torch's seeded defaults or a checkpoint's.
_FIXED = {("decoder",): dict(pipeline_mesh=None)}


# The defaults of the JAX dataclass fields that the port reads from a
# config (JAX's PromptTTSMDNDurCFG, PhonemeEmbedding, ConformerEncoder,
# VarianceAdaptor, MDNPredictor, Predictor, FramePriorNetwork, MDNLayer,
# StyleEncoder, GaussianDiffusion, DiffNet): a config that omits a key
# builds the JAX model with these, so the port reads an absent key the
# same way.
_JAX_DEFAULTS = {
    (): dict(norm_style_emb=False, mdn_disable_amp=False, style_mdn=None),
    ("phoneme_embedding",): dict(do_scale=True),
    ("encoder",): dict(
        attention_heads=4, linear_units=2048, num_blocks=6,
        dropout_rate=0.1, positional_dropout_rate=0.1,
        attention_dropout_rate=0.0, normalize_before=True,
        positionwise_layer_type="linear", positionwise_conv_kernel_size=1,
        macaron_style=False, pos_enc_layer_type="abs_pos",
        selfattention_layer_type="selfattn", activation_type="swish",
        use_cnn_module=False, cnn_module_kernel=31, return_mask=False,
        rel_pos_type=None),
    ("variance_adaptor",): dict(energy_predictor=None, energy_emb=None,
                                frame_prior_network=None),
    ("variance_adaptor", "duration_predictor"): dict(
        num_gaussians=4, dim_wise=True, detach=False, disable_amp=False),
    ("variance_adaptor", "pitch_predictor"): dict(detach=False),
    ("variance_adaptor", "energy_predictor"): dict(detach=False),
    ("variance_adaptor", "frame_prior_network"): dict(pos_enc_p_dropout=0.1),
    ("style_mdn",): dict(num_gaussians=30, dim_wise=False),
    ("reference_encoder",): dict(gst_token_dim=256),
    ("decoder",): dict(
        K_step=100, schedule_type="linear", norm_scale=None, a_min=0.0,
        a_max=20.0, pndm_speedup=None, infer_io_dtype=None,
        pipeline_mesh=None, pipeline_microbatches=None,
        pipeline_batch_axis=None),
    ("decoder", "denoise_fn"): dict(scale=1.0),
}


def _get(section: Mapping, path: tuple, key: str):
    """``section[key]``, or JAX's default where the config omits it."""
    return section.get(key, _JAX_DEFAULTS[path][key])


def _check_fixed(cfg: Mapping, bert_config: BertConfig):
    """Raise, naming the key, where ``cfg`` asks for a value that the port
    cannot build: a ``_FIXED`` switch at another value, or an encoder whose
    output JAX's model cannot read. (The modules raise on a layer type JAX
    does not know, naming its key.)"""
    for path, fixed in _FIXED.items():
        section = cfg
        for key in path:
            section = section[key]
        for key, value in fixed.items():
            if key in section and section[key] != value:
                name = ".".join(path + (key,))
                raise ValueError(f"model config {name}={section[key]!r} "
                                 "is not ported")
    if _get(cfg["encoder"], ("encoder",), "return_mask"):
        raise ValueError("model config encoder.return_mask=True: the model "
                         "adds the encoder's output to the style vector, "
                         "and JAX's fails on the (output, mask) pair too")
    if cfg["prompt_encoder"]["in_channels"] != bert_config.hidden_size:
        raise ValueError("prompt_encoder.in_channels != BERT hidden size")


def _predictor(cfg: Mapping, path: tuple) -> Predictor:
    return Predictor(cfg["channels"], cfg["out_channels"],
                     cfg["kernel_size"], cfg["num_layers"], cfg["dropout"],
                     _get(cfg, path, "detach"))


def _variance_adaptor(va: Mapping) -> VarianceAdaptor:
    path = ("variance_adaptor",)
    dp, fp = va["duration_predictor"], _get(va, path, "frame_prior_network")
    ep, ee = _get(va, path, "energy_predictor"), _get(va, path, "energy_emb")
    dget = lambda key: _get(dp, path + ("duration_predictor",), key)  # noqa
    conv = lambda c: Conv1d(c["in_channels"], c["out_channels"],  # noqa
                            c.get("kernel_size", 1))
    return VarianceAdaptor(
        duration_predictor=MDNPredictor(
            dp["channels"], dp["out_channels"], dp["kernel_size"],
            dp["num_layers"], dget("num_gaussians"), dp["dropout"],
            dget("detach"), dget("dim_wise"), dget("disable_amp")),
        pitch_predictor=_predictor(va["pitch_predictor"],
                                   path + ("pitch_predictor",)),
        pitch_emb=conv(va["pitch_emb"]),
        frame_prior_network=None if fp is None else FramePriorNetwork(
            fp["hidden_channels"], fp["n_layers"], fp["kernel_size"],
            fp["p_dropout"],
            _get(fp, path + ("frame_prior_network",), "pos_enc_p_dropout")),
        energy_predictor=None if ep is None else _predictor(
            ep, path + ("energy_predictor",)),
        energy_emb=None if ee is None else conv(ee))


def _model_from_config(cfg: Mapping, bert_config: BertConfig):
    """The port's model of ``cfg``; an absent key means the default of
    JAX's dataclass field (``_JAX_DEFAULTS``)."""
    _check_fixed(cfg, bert_config)
    pe, enc = cfg["phoneme_embedding"], cfg["encoder"]
    dec, dn = cfg["decoder"], cfg["decoder"]["denoise_fn"]
    pr, ref = cfg["prompt_encoder"], cfg["reference_encoder"]
    sm = _get(cfg, (), "style_mdn")
    eget = lambda key: _get(enc, ("encoder",), key)  # noqa: E731
    dget = lambda key: _get(dec, ("decoder",), key)  # noqa: E731
    return PromptTTSMDNDurCFG(
        phoneme_emb=PhonemeEmbedding(
            pe["num_vocab"], pe["channels"],
            _get(pe, ("phoneme_embedding",), "do_scale")),
        encoder=ConformerEncoder(
            enc["idim"], enc["attention_dim"], eget("attention_heads"),
            eget("linear_units"), eget("num_blocks"), eget("dropout_rate"),
            eget("positional_dropout_rate"), eget("attention_dropout_rate"),
            eget("normalize_before"), eget("positionwise_layer_type"),
            eget("positionwise_conv_kernel_size"), eget("macaron_style"),
            eget("pos_enc_layer_type"), eget("selfattention_layer_type"),
            eget("activation_type"), eget("use_cnn_module"),
            eget("cnn_module_kernel"), eget("return_mask"),
            eget("rel_pos_type")),
        variance_adaptor=_variance_adaptor(cfg["variance_adaptor"]),
        reference_encoder=StyleEncoder(
            ref["idim"], ref["gst_tokens"],
            _get(ref, ("reference_encoder",), "gst_token_dim"),
            ref["gst_heads"], ref["conv_layers"], ref["conv_chans_list"],
            ref["conv_kernel_size"], ref["conv_stride"], ref["gru_layers"],
            ref["gru_units"]),
        prompt_encoder=PromptEncoder(bert_config, pr["mid_channels"],
                                     pr["out_channels"]),
        decoder=GaussianDiffusion(
            DiffNet(dn["in_dim"], dn["encoder_hidden_dim"],
                    dn["residual_layers"], dn["residual_channels"],
                    dn["kernel_size"], dn["dilation_cycle_length"],
                    _get(dn, ("decoder", "denoise_fn"), "scale")),
            out_dim=dec["out_dim"], norm_scale=dget("norm_scale"),
            K_step=dget("K_step"), schedule_type=dget("schedule_type"),
            a_min=dget("a_min"), a_max=dget("a_max"),
            pndm_speedup=dget("pndm_speedup"),
            infer_io_dtype=dget("infer_io_dtype"),
            pipeline_microbatches=dget("pipeline_microbatches"),
            pipeline_batch_axis=dget("pipeline_batch_axis")),
        style_mdn=None if sm is None else MDNLayer(
            sm["in_dim"], sm["out_dim"],
            _get(sm, ("style_mdn",), "num_gaussians"),
            _get(sm, ("style_mdn",), "dim_wise")),
        norm_style_emb=_get(cfg, (), "norm_style_emb"),
        mdn_disable_amp=_get(cfg, (), "mdn_disable_amp"),
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


def build_f5tts(cfg: Mapping = F5TTS_V1_BASE, device="cuda", seed: int = 0):
    """F5-TTS (DiT and sampler) from a config of ``F5TTS_V1_BASE``'s shape,
    with random weights drawn from ``seed``, the DiT in ``cfg["dtype"]``."""
    dev = resolve_device(device)
    arch, smp = cfg["arch"], cfg["sampler"]

    def build():
        dit = DiT(mel_dim=cfg["mel_spec"]["n_mel_channels"], **arch)
        return F5TTS(dit, nfe=smp["nfe_step"],
                     cfg_strength=smp["cfg_strength"],
                     sway_coef=smp["sway_sampling_coef"])

    model = _seeded(dev, seed, build)
    model.dit.to(getattr(torch, cfg["dtype"]))
    return model


def build_vocos(device="cuda", seed: int = 1,
                cfg: Mapping = VOCOS_MEL_24KHZ):
    """Vocos with random weights drawn from ``seed``, in float32."""
    return _seeded(resolve_device(device), seed, lambda: Vocos(**cfg))
