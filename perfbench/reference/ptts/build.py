"""The model and the vocoder from a configuration of the shape of the
port's ``flagship.MODEL`` / ``flagship.VOCODER`` (frozen copy of the
port's ``flagship.py`` builders). Weights are whatever the caller loads:
the benchmark fills them from its seed (``perfbench/harness/weights.py``).
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch

from perfbench.reference.ptts.models.bert import BertConfig
from perfbench.reference.ptts.models.diffusion import DiffNet, GaussianDiffusion
from perfbench.reference.ptts.models.frame_prior import FramePriorNetwork
from perfbench.reference.ptts.models.phoneme_embedding import PhonemeEmbedding
from perfbench.reference.ptts.models.prompt_encoder import PromptEncoder
from perfbench.reference.ptts.models.prompttts import PromptTTSMDNDurCFG
from perfbench.reference.ptts.models.style_encoder import StyleEncoder
from perfbench.reference.ptts.models.variance_adaptor import (
    MDNPredictor, Predictor, VarianceAdaptor)
from perfbench.reference.ptts.nn.conformer import ConformerEncoder
from perfbench.reference.ptts.nn.layers import Conv1d
from perfbench.reference.ptts.nn.mdn import MDNLayer
from perfbench.reference.ptts.vocoders.bigvgan_f0 import F0AwareBigVGAN


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


def build_model(cfg: Mapping, device="cuda"):
    """The model of ``cfg`` on ``device``, in eval mode, without
    gradients."""
    dev = torch.device(device)
    with dev:
        model = _model_from_config(cfg, bert_config_of(cfg["prompt_encoder"]))
    return model.eval().requires_grad_(False)


def build_vocoder(cfg: Mapping, device="cuda"):
    """The F0-aware BigVGAN of ``cfg`` on ``device``."""
    dev = torch.device(device)
    with dev:
        vocoder = F0AwareBigVGAN(**copy.deepcopy(dict(cfg)))
    return vocoder.eval().requires_grad_(False)
