"""Port of the ESPnet transformer suite and of the modules it shares with
the model's config switches, against the JAX package on the CPU:

- the reference's goldens loaded straight into the port's modules (their
  ``state_dict`` names are the reference's): the decoder (three
  self-attention types and ``forward_one_step``), the light/dynamic
  convolutions, the 2-D subsamplers, the transformer encoder, and the
  streaming pieces of the conformer (stream positional encoding,
  ``mid_out``, a block's one-frame cache);
- the JAX modules with perturbed weights, through
  ``compat/from_jax.py``: the decoder's 1-D convolutions, its linear
  input, scaled encoding, ``concat_after`` and post-norm; the
  transformer encoder's input layers and block options; the conformer's
  FFN, attention and positional-encoding switches; the positional
  encodings; the MDN head without ``dim_wise``; the phoneme embeddings;
  ``SepPromptEncoder``; the ESPnet masks; and the initialization families'
  fans.

Tolerances are the JAX tests' against the goldens, and float32 summation
order against JAX.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.compat.torch_ckpt import load_reference_state_dict
from tests.test_torch_acoustic import (
    jax_variables_from, jit_apply, perturbed)

GOLDENS = Path(__file__).parent / "goldens"
# tests/test_decoder.py's bars against the reference's goldens
GOLDEN_TOL = dict(atol=3e-5, rtol=1e-4)
# float32 on both sides, sums in another order
TOL = dict(atol=2e-5, rtol=1e-4)


def _golden(name, prefix=""):
    """-> (state dict under ``prefix``, the golden's arrays)."""
    data = dict(np.load(GOLDENS / f"{name}.npz"))
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith(prefix) and "." in k}
    return sd, data


def _twins(jmodule, make_port, *args, seed=0):
    """-> (JAX variables, the port's module on them): the port's module
    built under a seeded RNG, its weights laid out in JAX's tree (no JAX
    init compiles) and perturbed."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        module = make_port()
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(seed), *args)
    variables = perturbed(jax_variables_from(shapes, module.state_dict()),
                          seed)
    return variables, _port(module, variables)


def _port(module, variables):
    load_jax_variables(module, variables)
    return module.eval().requires_grad_(False)


def _t(a):
    a = np.array(a)  # a writable copy (JAX's arrays are read-only)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" \
        else torch.from_numpy(a)


# ------------------------------------------------------------ goldens
def _golden_decoder(variant):
    from promptttspp_tpu_torch.nn.decoder import Decoder

    sd, data = _golden(f"decoder_{variant}")
    dec = Decoder(
        odim=20, selfattention_layer_type=variant, attention_dim=32,
        attention_heads=4, conv_wshare=4, conv_kernel_length="5_5",
        conv_usebias=True, linear_units=64, num_blocks=2, dropout_rate=0.0,
        positional_dropout_rate=0.0)
    dec = load_reference_state_dict(dec, sd).eval()
    ys = _t(np.where(data["ys"] == -1, 0, data["ys"]))
    return dec, data, ys


@pytest.mark.parametrize("variant",
                         ["selfattn", "lightconv2d", "dynamicconv2d"])
def test_decoder_matches_golden(variant):
    """The reference's golden straight into the port's decoder; padded
    target positions are arbitrary in both, and the reference's light
    convolution biases are uninitialized memory (NaN where they are NaN,
    as in JAX's test)."""
    dec, data, ys = _golden_decoder(variant)
    with torch.no_grad():
        out, _ = dec(ys, _t(data["tgt_mask"]) > 0, _t(data["memory"]),
                     _t(data["mem_mask"]) > 0)
    valid = data["tgt_mask"].any(axis=2)
    np.testing.assert_allclose(out.numpy()[valid], data["out"][valid],
                               **GOLDEN_TOL)


def test_decoder_one_step_matches_golden():
    from promptttspp_tpu_torch.ops.masks import subsequent_mask

    dec, data, ys = _golden_decoder("selfattn")
    cache = None
    for t in range(1, 5):
        with torch.no_grad():
            logp, cache = dec.forward_one_step(
                ys[:1, :t], subsequent_mask(t)[None], _t(data["memory"][:1]),
                None, cache=cache)
        np.testing.assert_allclose(logp.numpy(), data["onestep"][t - 1],
                                   **GOLDEN_TOL)


@pytest.mark.parametrize("name", ["LightweightConvolution",
                                  "DynamicConvolution"])
def test_lightconv_matches_golden(name):
    from promptttspp_tpu_torch.nn import lightconv

    prefix, key = (("lc.", "out_lc") if name.startswith("Light")
                   else ("dc.", "out_dc"))
    sd, data = _golden("lightconv", prefix)
    mod = load_reference_state_dict(
        getattr(lightconv, name)(4, 16, 0.0, "5", 0, use_bias=True), sd)
    with torch.no_grad():
        out = mod.eval()(_t(data["x"]), mask=_t(data["mask"])[:, None, :])
    # tests/test_lightconv.py's bar
    np.testing.assert_allclose(out.numpy(), data[key], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name,cls", [("4", "Conv2dSubsampling"),
                                      ("6", "Conv2dSubsampling6"),
                                      ("8", "Conv2dSubsampling8")])
def test_subsampling_matches_golden(name, cls):
    from promptttspp_tpu_torch.nn import subsampling

    sd, data = _golden(f"subsampling_{name}")
    sub = load_reference_state_dict(getattr(subsampling, cls)(40, 32), sd)
    with torch.no_grad():
        out, mask = sub.eval()(_t(data["x"]), _t(data["mask"]) > 0)
    np.testing.assert_allclose(out.numpy(), data["out"], **GOLDEN_TOL)
    np.testing.assert_array_equal(mask.numpy(), data["out_mask"] > 0)


@pytest.mark.parametrize("case,kw", [
    ("conv2d", dict(input_layer="conv2d",
                    selfattention_layer_type="selfattn",
                    positionwise_layer_type="linear")),
    ("linear_lightconv", dict(input_layer="linear",
                              selfattention_layer_type="lightconv",
                              conv_kernel_length="5_5",
                              positionwise_layer_type="conv1d",
                              positionwise_conv_kernel_size=3)),
])
def test_transformer_encoder_matches_golden(case, kw):
    from promptttspp_tpu_torch.nn.transformer_encoder import (
        TransformerEncoder)

    sd, data = _golden(f"trans_encoder_{case}")
    enc = load_reference_state_dict(TransformerEncoder(
        idim=40, attention_dim=32, attention_heads=4, linear_units=64,
        num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
        attention_dropout_rate=0.0, conv_wshare=4, conv_usebias=True, **kw),
        sd)
    with torch.no_grad():
        out, mask = enc.eval()(_t(data["x"]), _t(data["mask"]) > 0)
    valid = data["out_mask"][:, 0, :] > 0
    np.testing.assert_allclose(out.numpy()[valid], data["out"][valid],
                               **GOLDEN_TOL)
    np.testing.assert_array_equal(mask.numpy(), data["out_mask"] > 0)


def test_stream_positional_encoding_matches_golden():
    from promptttspp_tpu_torch.nn.embedding import StreamPositionalEncoding

    _, data = _golden("esp_streaming")
    pe = StreamPositionalEncoding(32)
    x = _t(data["pe_x"])
    np.testing.assert_allclose(pe(x).numpy(), data["pe_out0"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pe(x, start_idx=4).numpy(), data["pe_out4"],
                               atol=1e-5, rtol=1e-5)
    # a chunk encoded at its offset is the whole stream's slice
    full = pe(torch.randn(2, 12, 32, generator=torch.Generator()
                          .manual_seed(0)))
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(pe(x[:, 4:], start_idx=4).numpy(),
                               full[:, 4:].numpy(), atol=1e-6)


def test_encoder_mid_out_matches_golden():
    """Every block's output, each through ``after_norm``
    (tests/test_esp_streaming.py's bar: the reference's padded steps are
    not masked, so the valid ones are compared)."""
    from promptttspp_tpu_torch.nn.conformer import Encoder

    sd, data = _golden("esp_streaming", "enc.")
    enc = Encoder(
        32, 32, 2, 64, 3, 0.0, 0.0, 0.0, positionwise_layer_type="conv1d",
        positionwise_conv_kernel_size=3, macaron_style=True,
        pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn",
        use_cnn_module=True, cnn_module_kernel=7, mid_out=True)
    enc = load_reference_state_dict(enc, sd).eval()
    x, lens = _t(data["enc_x"]), data["enc_lens"]
    non_pad = torch.from_numpy(np.arange(x.shape[1])[None] < lens[:, None])
    with torch.no_grad():
        outs = enc(x, non_pad[:, None, :] & non_pad[:, :, None],
                   non_pad[:, :, None].float())
    assert len(outs) == 3
    valid = non_pad.numpy()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy()[valid], data[f"mid_{i}"][valid],
                                   atol=2e-4, rtol=1e-3, err_msg=f"block {i}")


@pytest.mark.parametrize("attn", ["selfattn", "rel_selfattn"])
def test_encoder_layer_cache_matches_golden(attn):
    from promptttspp_tpu_torch.nn.conformer import EncoderLayer

    prefix, key = (("abs.", "cache_out_abs") if attn == "selfattn"
                   else ("rel.", "cache_out_rel"))
    sd, data = _golden("esp_streaming", prefix)
    layer = EncoderLayer(32, 2, 64, 3, 7, attn, positionwise_layer_type=(
        "conv1d"), macaron_style=True, use_cnn_module=True)
    layer = load_reference_state_dict(layer, sd).eval()
    x, cache = _t(data["cache_x"]), _t(data["cache"])
    pos_emb = None if attn == "selfattn" else _t(data["cache_pos_emb"])
    with torch.no_grad():
        out = layer(x, pos_emb, torch.ones(1, 1, x.shape[1], dtype=torch.bool),
                    torch.ones(1, 1, 1), cache=cache)
    assert torch.equal(out[:, :-1], cache)
    np.testing.assert_allclose(out.numpy(), data[key], **TOL)


# ------------------------------------------------------- against JAX
DEC_KW = dict(odim=12, attention_dim=16, attention_heads=2, conv_wshare=2,
              conv_kernel_length="3_5", conv_usebias=True, linear_units=24,
              num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0)
# the cases the goldens (selfattn, lightconv2d, dynamicconv2d with token
# input, pre-norm, one-step for selfattn) leave out
DEC_CASES = {
    "lightconv": dict(selfattention_layer_type="lightconv"),
    "dynamicconv": dict(selfattention_layer_type="dynamicconv"),
    "linear_scaled_concat_postnorm": dict(
        input_layer="linear", pos_enc_type="scaled", concat_after=True,
        normalize_before=False),
}


def _decoder_inputs(linear: bool, seed=0):
    from promptttspp_tpu.ops.masks import target_mask

    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 12, (2, 7))
    ids[1, 5:] = -1
    mask = np.asarray(target_mask(jnp.asarray(ids), -1))
    ys = (rng.randn(2, 7, 12).astype(np.float32) if linear
          else np.where(ids == -1, 0, ids).astype(np.int32))
    memory = rng.randn(2, 9, 16).astype(np.float32)
    mem_mask = np.ones((2, 1, 9), bool)
    mem_mask[1, :, 6:] = False
    return ys, mask, memory, mem_mask


@pytest.mark.parametrize("case", list(DEC_CASES))
def test_decoder_matches_jax(case):
    """The whole decoder and three ``forward_one_step`` steps (the
    per-layer cache) on the same weights."""
    from promptttspp_tpu.nn.decoder import Decoder as JaxDecoder
    from promptttspp_tpu.ops.masks import subsequent_mask
    from promptttspp_tpu_torch.nn.decoder import Decoder

    kw = dict(DEC_KW, **DEC_CASES[case])
    args = _decoder_inputs(kw.get("input_layer") == "linear")
    jdec = JaxDecoder(**kw)
    variables, dec = _twins(jdec, lambda: Decoder(**kw),
                            *map(jnp.asarray, args))
    ref, _ = jax.jit(jdec.apply)(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        out, _ = dec(*map(_t, args))
    valid = args[1].any(axis=2)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               **TOL)
    ys, memory = args[0], args[2]
    jcache, cache = None, None
    for t in range(1, 4):
        ref, jcache = jit_apply(
            jdec, variables, type(jdec).forward_one_step,
            jnp.asarray(ys[:1, :t]), subsequent_mask(t)[None],
            jnp.asarray(memory[:1]), None, cache=jcache)
        with torch.no_grad():
            out, cache = dec.forward_one_step(
                _t(ys[:1, :t]), _t(np.asarray(subsequent_mask(t))[None]),
                _t(memory[:1]), None, cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")


ENC_KW = dict(attention_dim=16, attention_heads=2, conv_wshare=2,
              conv_kernel_length="3_5", conv_usebias=True, linear_units=24,
              num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
              attention_dropout_rate=0.0)
ENC_CASES = {
    "conv2d6_dynamicconv_conv1dlinear": dict(
        idim=24, input_layer="conv2d6", selfattention_layer_type="dynamicconv",
        positionwise_layer_type="conv1d-linear",
        positionwise_conv_kernel_size=3),
    "conv2d8_lightconv2d_concat": dict(
        idim=24, input_layer="conv2d8", selfattention_layer_type="lightconv2d",
        concat_after=True),
    "embed_dynamicconv2d_scaled": dict(
        idim=30, input_layer="embed", selfattention_layer_type="dynamicconv2d",
        pos_enc_type="scaled"),
    "none_selfattn_postnorm": dict(idim=16, input_layer=None,
                                   normalize_before=False),
    "no_pos_enc_lightconv": dict(idim=16, input_layer="no_pos_enc",
                                 selfattention_layer_type="lightconv"),
}


@pytest.mark.parametrize("case", list(ENC_CASES))
def test_transformer_encoder_matches_jax(case):
    from promptttspp_tpu.nn.transformer_encoder import (
        TransformerEncoder as JaxEncoder)
    from promptttspp_tpu_torch.nn.transformer_encoder import (
        TransformerEncoder)

    kw = dict(ENC_KW, **ENC_CASES[case])
    rng = np.random.RandomState(1)
    T = 40
    xs = (rng.randint(0, kw["idim"], (2, T)).astype(np.int32)
          if kw["input_layer"] == "embed"
          else rng.randn(2, T, kw["idim"]).astype(np.float32))
    masks = np.ones((2, 1, T), bool)
    masks[1, :, 29:] = False
    jenc = JaxEncoder(**kw)
    variables, enc = _twins(jenc, lambda: TransformerEncoder(**kw),
                            jnp.asarray(xs), jnp.asarray(masks))
    ref, ref_mask = jax.jit(jenc.apply)(variables, jnp.asarray(xs),
                                        jnp.asarray(masks))
    with torch.no_grad():
        out, mask = enc(_t(xs), _t(masks))
    valid = np.asarray(ref_mask)[:, 0, :]
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               **TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


CONFORMER_KW = dict(idim=16, attention_dim=16, attention_heads=2,
                    linear_units=24, num_blocks=2, dropout_rate=0.0,
                    positional_dropout_rate=0.0, attention_dropout_rate=0.0,
                    positionwise_conv_kernel_size=3, cnn_module_kernel=5)
CONFORMER_CASES = {
    # JAX's defaults: linear FFN, plain attention, absolute positions, no
    # macaron, no conv module
    "defaults": {},
    "conv1dlinear_scaled_macaron_cnn": dict(
        positionwise_layer_type="conv1d-linear",
        pos_enc_layer_type="scaled_abs_pos", macaron_style=True,
        use_cnn_module=True),
    "legacy_rel_cnn_postnorm": dict(
        positionwise_layer_type="conv1d", pos_enc_layer_type="rel_pos",
        selfattention_layer_type="rel_selfattn", use_cnn_module=True,
        normalize_before=False),
    "new_rel_input_linear_return_mask": dict(
        idim=12, pos_enc_layer_type="rel_pos",
        selfattention_layer_type="rel_selfattn", rel_pos_type="new",
        macaron_style=True, return_mask=True),
}


@pytest.mark.parametrize("case", list(CONFORMER_CASES))
def test_conformer_switches_match_jax(case):
    """``ConformerEncoder`` with each of JAX's FFN, attention and
    positional-encoding types, macaron and the conv module on and off,
    post-norm, an input Linear (``idim != attention_dim``) and
    ``return_mask``; in eval and in train mode (BatchNorm batch
    statistics), on the same weights."""
    from promptttspp_tpu.nn.conformer import ConformerEncoder as JaxEnc
    from promptttspp_tpu_torch.nn.conformer import ConformerEncoder

    kw = dict(CONFORMER_KW, **CONFORMER_CASES[case])
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, kw["idim"]).astype(np.float32)
    lens = np.array([11, 7], np.int32)
    jenc = JaxEnc(**kw)
    variables, enc = _twins(jenc, lambda: ConformerEncoder(**kw),
                            jnp.asarray(x), jnp.asarray(lens))
    for train in (False, True):
        ref = jit_apply(jenc, variables, None, jnp.asarray(x),
                        jnp.asarray(lens), train=train,
                        mutable=["batch_stats"] if train else False)
        ref = ref[0] if train else ref
        enc.train(train)
        with torch.no_grad():
            out = enc(_t(x), _t(lens))
        if kw.get("return_mask"):
            np.testing.assert_array_equal(out[1].numpy(),
                                          np.asarray(ref[1]))
            out, ref = out[0], ref[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"train={train}")


def test_positional_encodings_match_jax():
    """The reversed absolute encoding, and the scaled one with a learned
    alpha, against JAX's on the same input."""
    from promptttspp_tpu.nn import embedding as jemb
    from promptttspp_tpu_torch.nn import embedding

    x = np.random.RandomState(3).randn(2, 9, 16).astype(np.float32)
    ref = jemb.PositionalEncoding(16, 0.0, reverse=True).apply(
        {}, jnp.asarray(x))
    out = embedding.PositionalEncoding(16, reverse=True)(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    jscaled = jemb.ScaledPositionalEncoding(16, 0.0)
    variables = {"params": {"alpha": np.array([0.7], np.float32)}}
    ref = jscaled.apply(variables, jnp.asarray(x))
    scaled = _port(embedding.ScaledPositionalEncoding(16), variables)
    np.testing.assert_allclose(scaled(_t(x)).numpy(), np.asarray(ref),
                               atol=1e-6)


def test_mdn_without_dim_wise_matches_jax():
    """One GMM of G diagonal components (JAX's default): the head's
    outputs, the loss with 3-D log_pi (reduced and per frame, masked),
    the most probable component, and a draw that takes one component for
    every dim."""
    from promptttspp_tpu.nn import mdn as jmdn
    from promptttspp_tpu_torch.nn import mdn

    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 8).astype(np.float32)
    target = rng.randn(2, 5, 3).astype(np.float32)
    mask = np.ones((2, 5, 1), bool)
    mask[1, 3:] = False
    jlayer = jmdn.MDNLayer(8, 3, num_gaussians=4, dim_wise=False)
    variables, layer = _twins(jlayer, lambda: mdn.MDNLayer(8, 3, 4),
                              jnp.asarray(x))
    ref = jax.jit(jlayer.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = layer(_t(x))
    assert out[0].shape == (2, 5, 4) and out[1].shape == (2, 5, 4, 3)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    for kw in (dict(), dict(reduce=False, mask=mask)):
        jkw = {k: jnp.asarray(v) if k == "mask" else v for k, v in kw.items()}
        tkw = {k: _t(v) if k == "mask" else v for k, v in kw.items()}
        ref_loss = jmdn.mdn_loss(*ref, jnp.asarray(target), **jkw)
        loss = mdn.mdn_loss(*out, _t(target), **tkw)
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **TOL)
    for o, r in zip(mdn.mdn_get_most_probable_sigma_and_mu(*out),
                    jmdn.mdn_get_most_probable_sigma_and_mu(*ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    sigma, mu = mdn.mdn_sample_sigma_and_mu(
        *out, generator=torch.Generator().manual_seed(0))
    hit = (mu[:, :, None, :] == out[2]).all(-1) \
        & (sigma[:, :, None, :] == out[1].exp()).all(-1)
    assert hit.any(-1).all()


def test_phoneme_embeddings_match_jax():
    from promptttspp_tpu.models import phoneme_embedding as jpe
    from promptttspp_tpu_torch.models import phoneme_embedding as pe

    ids = np.random.RandomState(5).randint(0, 20, (2, 7)).astype(np.int32)
    mask = (np.arange(7)[None] < np.array([[7], [4]]))[..., None] \
        .astype(np.float32)
    for name in ("PhonemeEmbedding", "PhonemeEmbedding2"):
        jmod = getattr(jpe, name)(20, 8)
        variables, mod = _twins(jmod, lambda: getattr(pe, name)(20, 8),
                                jnp.asarray(ids), jnp.asarray(mask))
        ref = jax.jit(jmod.apply)(variables, jnp.asarray(ids),
                                  jnp.asarray(mask))
        out = mod(_t(ids), _t(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sep_prompt_encoder_matches_jax():
    import dataclasses

    from promptttspp_tpu.models.bert import BertConfig as JaxBert
    from promptttspp_tpu.models.prompt_encoder import (
        SepPromptEncoder as JaxSep)
    from promptttspp_tpu_torch.models.bert import BertConfig
    from promptttspp_tpu_torch.models.prompt_encoder import SepPromptEncoder

    bert = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=24,
                max_position_embeddings=16, hidden_dropout=0.0,
                attention_dropout=0.0)
    rng = np.random.RandomState(6)
    ids = [rng.randint(1, 40, (2, 6)).astype(np.int32) for _ in range(2)]
    masks = [np.ones((2, 6), np.int32) for _ in range(2)]
    masks[1][1, 4:] = 0
    args = (ids[0], masks[0], ids[1], masks[1])
    jsep = JaxSep(in_channels=16, mid_channels=12, out_channels=8,
                  bert_config=JaxBert(**bert))
    port_bert = BertConfig(**{f.name: bert[f.name] for f in
                              dataclasses.fields(BertConfig)
                              if f.name in bert})
    variables, sep = _twins(jsep, lambda: SepPromptEncoder(port_bert, 12, 8),
                            *map(jnp.asarray, args))
    ref = jit_apply(jsep, variables, type(jsep).infer,
                    *map(jnp.asarray, args))
    with torch.no_grad():
        out = sep.infer(*map(_t, args))
        np.testing.assert_allclose(sep(*map(_t, args)).numpy(),
                                   np.asarray(ref[0]), **TOL)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_masks_match_jax():
    from promptttspp_tpu.ops import masks as jmasks
    from promptttspp_tpu_torch.ops import masks

    ys = np.array([[3, 4, 5, -1, -1], [6, 7, 8, 9, 2]], np.int32)
    np.testing.assert_array_equal(masks.subsequent_mask(5).numpy(),
                                  np.asarray(jmasks.subsequent_mask(5)))
    np.testing.assert_array_equal(
        masks.target_mask(_t(ys), -1).numpy(),
        np.asarray(jmasks.target_mask(jnp.asarray(ys), -1)))
    for o, r in zip(masks.add_sos_eos(_t(ys), 1, 2, -1),
                    jmasks.add_sos_eos(jnp.asarray(ys), 1, 2, -1)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the reference's list construction: [sos] + ys, ys + [eos]
    ys_in, ys_out = masks.add_sos_eos(_t(ys), 1, 2, -1)
    assert ys_in[0].tolist() == [1, 3, 4, 5, 2, 2]
    assert ys_out[0].tolist() == [3, 4, 5, 2, -1, -1]


def test_initialization_families_use_jax_fans():
    """Each family's draw respects its bound or scale at the fans JAX
    counts on the same parameter in its own layout (a Dense or Conv kernel
    transposed, an embedding table as it is); 1-D parameters are zero;
    ``pytorch`` leaves the module unchanged."""
    from promptttspp_tpu_torch.nn.initialization import (
        fans, initialize, lecun_normal_init)
    from promptttspp_tpu_torch.nn.layers import Conv1d, Linear

    def jax_fans(shape):  # promptttspp_tpu/nn/initialization.py::_draw
        rec = int(np.prod(shape[:-2]))
        return shape[-2] * rec, shape[-1] * rec

    net = torch.nn.ModuleDict(dict(
        dense=Linear(64, 32), conv=Conv1d(16, 32, 3),
        emb=torch.nn.Embedding(50, 24)))
    jax_shapes = {"dense": (64, 32), "conv": (3, 16, 32), "emb": (50, 24)}
    for name, shape in jax_shapes.items():
        mod = net[name]
        assert fans(mod, "weight", mod.weight) == jax_fans(shape), name
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    initialize(net, "pytorch", gen)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    for family in ("xavier_uniform", "xavier_normal", "kaiming_uniform",
                   "kaiming_normal"):
        initialize(net, family, gen)
        assert torch.all(net["dense"].bias == 0)
        assert torch.all(net["conv"].bias == 0)
        for name, shape in jax_shapes.items():
            w = net[name].weight
            fan_in, fan_out = jax_fans(shape)
            if family == "xavier_uniform":
                assert w.abs().max() <= (6.0 / (fan_in + fan_out)) ** 0.5
            if family == "kaiming_uniform":
                assert w.abs().max() <= (6.0 / fan_in) ** 0.5
            if family == "kaiming_normal":
                assert abs(w.std() - (2.0 / fan_in) ** 0.5) \
                    < 0.2 * (2.0 / fan_in) ** 0.5, name
    lecun_normal_init(net, gen)
    w = net["emb"].weight
    assert abs(w.std() - 50 ** -0.5) < 0.2 * 50 ** -0.5
    with pytest.raises(ValueError, match="Unknown initialization"):
        initialize(net, "orthogonal", gen)
