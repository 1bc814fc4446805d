"""The port's reference-checkpoint loader (``compat/torch_ckpt.py``) and the
demo model's legacy relative-position conformer, against the reference's
goldens and the JAX package on the CPU.

- the legacy positional encoding and shift against JAX's, the legacy
  conformer against ``conformer_legacy.npz`` and against JAX's
  ``ConformerEncoder(rel_pos_type="legacy")`` on the same weights;
- ``fold_weight_norm`` bit for bit against JAX's;
- ``bigvgan_f0.npz`` through the loader: the golden wav, and JAX's
  ``convert_reference_checkpoint`` of the same file;
- a tiny acoustic model written in the reference's checkpoint format: the
  port's request up to the decode, and ``generate_style_emb``, against
  JAX's on the same file;
- what the loader refuses: a missing key, a shape mismatch, an unknown key,
  a derived buffer that disagrees, an orbax directory.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.compat import torch_ckpt
from promptttspp_tpu_torch.nn import embedding
from promptttspp_tpu_torch.nn.conformer import ConformerEncoder

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
# tests/test_parity.py:50-66
CONFORMER_TOL = dict(atol=2e-4, rtol=1e-3)
# tests/test_vocoder.py:57
VOCODER_TOL = dict(atol=5e-5, rtol=1e-3)
# float32 on both sides, another summation order
TOL = dict(atol=1e-4, rtol=1e-4)
VOC_GOLDEN_KW = dict(sampling_rate=24000, harmonic_num=3, in_channel=20,
                     upsample_initial_channel=32,
                     upsample_rates=(6, 5, 4, 2),
                     upsample_kernel_sizes=(12, 10, 8, 4),
                     resblock_kernel_sizes=(3, 7),
                     resblock_dilations=((1, 3), (1, 3)))


def _golden(name, io_keys):
    sd = torch_ckpt.torch_state_dict(GOLDENS / f"{name}.npz")
    return sd, {k: sd.pop(k).numpy() for k in io_keys}


def _golden_conformer(rel_pos_type="legacy"):
    enc = ConformerEncoder(
        64, 64, 2, 128, 2, 0.0, 0.0, 0.0, positionwise_layer_type="conv1d",
        positionwise_conv_kernel_size=9, macaron_style=True,
        pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn",
        use_cnn_module=True, cnn_module_kernel=7, rel_pos_type=rel_pos_type)
    return enc.eval().requires_grad_(False)


@pytest.mark.parametrize("T", [1, 17, 640, 5000, 5001])
def test_legacy_encoding_matches_jax(T):
    """pos_emb = the first T rows of the reversed 5000-row table (positions
    4999 .. 5000-T), regrown only past 5000 rows, equal to JAX's bit for
    bit; one table per device for every T up to 5000."""
    from promptttspp_tpu.nn.embedding import LegacyRelPositionalEncoding

    d = 16
    x = np.random.RandomState(T).randn(1, T, d).astype(np.float32)
    jx, jpos = LegacyRelPositionalEncoding(d, 0.0).apply(
        {}, jnp.asarray(x), deterministic=True)
    px, ppos = embedding.LegacyRelPositionalEncoding(d)(torch.from_numpy(x))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    first = embedding.sinusoid_table(5000, d, reverse=True)[0]
    np.testing.assert_array_equal(ppos[0, 0].numpy(),
                                  first if T <= 5000 else
                                  embedding.sinusoid_table(T, d)[T - 1])
    if T <= 5000:
        _, again = embedding.LegacyRelPositionalEncoding(d)(
            torch.zeros(1, 3, d))
        assert again.untyped_storage().data_ptr() == \
            ppos.untyped_storage().data_ptr()


def test_legacy_shift_matches_jax():
    from promptttspp_tpu.nn.attention import _rel_shift_legacy

    from promptttspp_tpu_torch.nn.attention import rel_shift_legacy

    x = np.random.RandomState(0).randn(2, 3, 7, 7).astype(np.float32)
    np.testing.assert_array_equal(
        rel_shift_legacy(torch.from_numpy(x)).numpy(),
        np.asarray(_rel_shift_legacy(jnp.asarray(x))))


@pytest.mark.parametrize("rel_pos_type", ["legacy", None])
def test_legacy_conformer_matches_golden(rel_pos_type):
    """conformer_legacy.npz through the loader; rel_pos_type None is the
    legacy variant, as in JAX."""
    sd, io = _golden("conformer_legacy", ("x", "lens", "out"))
    enc = torch_ckpt.load_reference_state_dict(
        _golden_conformer(rel_pos_type), sd)
    out = enc(torch.from_numpy(io["x"]), torch.from_numpy(io["lens"]))
    np.testing.assert_allclose(out.numpy(), io["out"], **CONFORMER_TOL)


def test_new_conformer_is_not_the_legacy_one():
    sd, io = _golden("conformer_legacy", ("x", "lens", "out"))
    enc = torch_ckpt.load_reference_state_dict(_golden_conformer("new"), sd)
    out = enc(torch.from_numpy(io["x"]), torch.from_numpy(io["lens"]))
    assert np.abs(out.numpy() - io["out"]).max() > 1e-2


@pytest.mark.parametrize("T,lens", [(40, (40, 23)), (130, (130, 1))])
def test_legacy_conformer_matches_jax(T, lens):
    """The golden's weights in JAX's legacy ConformerEncoder (through JAX's
    converter) and in the port's, at other lengths than the golden's."""
    from promptttspp_tpu.nn.conformer import ConformerEncoder as JaxEnc
    from tests.test_parity import convert_variables

    sd, _ = _golden("conformer_legacy", ("x", "lens", "out"))
    x = np.random.RandomState(T).randn(2, T, 64).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jenc = JaxEnc(
        idim=64, attention_dim=64, attention_heads=2, linear_units=128,
        num_blocks=2, positionwise_layer_type="conv1d",
        positionwise_conv_kernel_size=9, dropout_rate=0.0,
        pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn",
        macaron_style=True, use_cnn_module=True, cnn_module_kernel=7,
        rel_pos_type="legacy")
    args = (jnp.asarray(x), jnp.asarray(lens))
    variables = convert_variables(jenc, {k: v.numpy() for k, v in sd.items()},
                                  args)
    ref = np.asarray(jenc.apply(variables, *args))
    enc = torch_ckpt.load_reference_state_dict(_golden_conformer(), sd)
    out = enc(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("shape", [(16, 20, 7), (32, 16, 12), (1, 2, 7),
                                   (48, 48), (8, 4, 3, 3)])
def test_fold_weight_norm_matches_jax(shape):
    """Conv1d [out, in, K], ConvTranspose1d [in, out, K] (both normalised
    over dims 1.., as the reference and JAX do), Linear and Conv2d."""
    from promptttspp_tpu.compat.torch_ckpt import fold_weight_norm

    rng = np.random.RandomState(len(shape))
    v = rng.randn(*shape).astype(np.float32)
    g = np.abs(rng.randn(shape[0], *([1] * (len(shape) - 1)))).astype(
        np.float32)
    ours = torch_ckpt.fold_weight_norm(torch.from_numpy(g),
                                       torch.from_numpy(v))
    np.testing.assert_array_equal(ours, fold_weight_norm(g, v))
    assert ours.dtype == np.float32


def _jax_vocoder_cfg():
    from promptttspp_tpu.config import compose

    kw = VOC_GOLDEN_KW
    return compose(REPO / "conf", "synthesize", overrides=[
        f"vocoder.in_channel={kw['in_channel']}",
        f"vocoder.harmonic_num={kw['harmonic_num']}",
        f"vocoder.upsample_initial_channel={kw['upsample_initial_channel']}",
        "vocoder.resblock_kernel_sizes=[3,7]",
        "vocoder.resblock_dilations=[[1,3],[1,3]]"])


def test_bigvgan_f0_golden_through_the_loader():
    """bigvgan_f0.npz (weight-normed convolutions, the transposed ones
    included; [1, C, 1] snake alphas; AA filter buffers) through the port's
    loader: the golden wav, JAX's converted parameters bit for bit, and
    JAX's wav on the converted checkpoint."""
    from promptttspp_tpu.compat.torch_ckpt import convert_reference_checkpoint
    from promptttspp_tpu.config import instantiate

    from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN

    sd, io = _golden("bigvgan_f0", ("mel", "f0", "wav"))
    voc = torch_ckpt.load_reference_state_dict(
        F0AwareBigVGAN(**VOC_GOLDEN_KW).eval().requires_grad_(False), sd)
    mel = io["mel"].transpose(0, 2, 1)
    f0 = io["f0"].transpose(0, 2, 1)
    with torch.no_grad():
        wav = voc(torch.from_numpy(mel), torch.from_numpy(f0),
                  deterministic=True).numpy()
    np.testing.assert_allclose(wav, io["wav"].transpose(0, 2, 1),
                               **VOCODER_TOL)

    cfg = _jax_vocoder_cfg()
    jvars = convert_reference_checkpoint(
        "vocoder", {k: v.numpy() for k, v in sd.items()}, cfg)
    params = jax.device_get(jvars["params"])
    np.testing.assert_array_equal(
        voc.conv_pre.weight.numpy(),
        np.asarray(params["conv_pre"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(
        voc.upsamples[0].weight.numpy(),
        np.asarray(params["upsamples_0"]["kernel_t"]).transpose(1, 2, 0))
    jwav = instantiate(cfg.vocoder).apply(jvars, jnp.asarray(mel),
                                          jnp.asarray(f0),
                                          deterministic=True)
    np.testing.assert_allclose(wav, np.asarray(jwav), **VOCODER_TOL)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    from tests.test_torch_cuda import write_tiny_cli_setup

    root = tmp_path_factory.mktemp("ckpt")
    write_tiny_cli_setup(root)
    return root


def test_reference_checkpoint_round_trip(tiny_files):
    """The tiny model and vocoder written in the reference's format load
    back: every unfolded tensor bit for bit, the folded (weight-normed)
    ones to float32 rounding."""
    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import conf
    from tests.test_torch_cuda import tiny_cli_overrides

    cfg = conf.compose("synthesize", tiny_cli_overrides())
    for kind, build in (
            ("model", lambda: flagship.build_model(cfg["model"], "cpu", 1)),
            ("vocoder", lambda: flagship.build_vocoder(
                "cpu", 2, cfg=cfg["vocoder"]))):
        sd = torch_ckpt.torch_state_dict(tiny_files / f"{kind}.ckpt", kind)
        module = torch_ckpt.load_reference_state_dict(build(), sd)
        folded = 0
        for k, v in module.state_dict().items():
            if k in sd:
                assert torch.equal(v, sd[k]), k
            else:
                folded += 1
                np.testing.assert_allclose(v.numpy(), sd[k + "_v"].numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
        assert folded == (0 if kind == "model" else 1 + 4 + 2 * 2 * 4 + 1)


def test_tiny_model_file_matches_jax(tiny_files):
    """A tiny acoustic model written in the reference's format, read by the
    port's loader and by JAX's ``convert_reference_checkpoint``: the same
    request (most probable style, no noise) gives the same frame lengths,
    decoder conditioning, F0 and vuv, and ``generate_style_emb`` the same
    prompt and reference style vectors. (The decode on such a file is held
    to JAX's in tests/test_torch_cli.py, through the two apps.)"""
    from promptttspp_tpu.compat.torch_ckpt import (
        convert_reference_checkpoint, torch_state_dict)
    from promptttspp_tpu.config import compose, instantiate

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.bin import conf
    from tests.test_torch_acoustic import _t
    from tests.test_torch_cuda import tiny_cli_overrides

    path = tiny_files / "model.ckpt"
    jcfg = compose(REPO / "conf", "synthesize",
                   overrides=tiny_cli_overrides())
    model = instantiate(jcfg.model)
    variables = convert_reference_checkpoint(
        "model", torch_state_dict(path, "model"), jcfg)
    port = torch_ckpt.load_reference_state_dict(flagship.build_model(
        conf.compose("synthesize", tiny_cli_overrides())["model"], "cpu"),
        torch_ckpt.torch_state_dict(path, "model"))

    rng = np.random.RandomState(3)
    phoneme = rng.randint(1, 90, (2, 16)).astype(np.int32)
    plens = np.array([16, 9], np.int32)
    phoneme[1, 9:] = 0
    ids = rng.randint(5, 29, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    ref_mel = rng.randn(2, 96, 80).astype(np.float32)
    ref_lens = np.array([96, 61], np.int32)
    kw = dict(prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
              use_max=True, noise_scale=0.0)
    jflens = np.asarray(model.apply(
        variables, jnp.asarray(phoneme), jnp.asarray(plens),
        method=type(model).infer_frame_lengths, **kw))
    max_frames = 64 * int(np.ceil(int(jflens.max()) / 64))
    ref = model.apply(variables, jnp.asarray(phoneme), jnp.asarray(plens),
                      max_frames, method=type(model).infer_cond, **kw)
    jstyle = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(ref_mel), jnp.asarray(ref_lens),
                         use_max=True, noise_scale=0.0,
                         method=type(model).generate_style_emb)
    with torch.no_grad():
        flens = port.infer_frame_lengths(_t(phoneme), _t(plens), _t(ids),
                                         _t(mask))
        out = port.infer_cond(_t(phoneme), _t(plens), max_frames, _t(ids),
                              _t(mask), use_max=True, noise_scale=0.0)
        style = port.generate_style_emb(
            _t(ids), _t(mask), torch.from_numpy(ref_mel), _t(ref_lens),
            use_max=True, noise_scale=0.0)
    np.testing.assert_array_equal(flens.numpy(), jflens)
    for name, o, r in zip(("cond", "flens", "fmask", "log_cf0", "vuv",
                           "raw"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    for name, o, r in zip(("prompt_emb", "ref_emb"), style, jstyle):
        assert o.shape == (2, 1, 64)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_loader_refuses_what_it_cannot_place(tmp_path):
    """A missing parameter, a shape mismatch, a key the port has no place
    for and a derived buffer that disagrees each raise, naming the key; an
    orbax directory (a JAX-trained checkpoint) and an unknown suffix
    raise."""
    from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN

    sd, _ = _golden("bigvgan_f0", ("mel", "f0", "wav"))
    voc = lambda: F0AwareBigVGAN(**VOC_GOLDEN_KW)  # noqa: E731
    cases = {
        "conv_post.bias": lambda d: d.pop("conv_post.bias"),
        "m_source.l_linear.weight": lambda d: d.update({
            "m_source.l_linear.weight": torch.zeros(2, 4)}),
        "mrfs.9.extra": lambda d: d.update({"mrfs.9.extra": torch.zeros(1)}),
        "act_post.up.filter": lambda d: d.update({
            "act_post.up.filter": d["act_post.up.filter"] * 1.01}),
        "conv_pre.weight_g": lambda d: d.pop("conv_pre.weight_v"),
    }
    for key, edit in cases.items():
        bad = dict(sd)
        edit(bad)
        with pytest.raises(ValueError, match=key.replace(".", r"\.")):
            torch_ckpt.load_reference_state_dict(voc(), bad)
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        torch_ckpt.torch_state_dict(tmp_path / "orbax_ckpt", "model")
    with pytest.raises(ValueError, match="unsupported"):
        torch_ckpt.torch_state_dict(tmp_path / "weights.safetensors")


def test_checkpoint_entries_and_unread_keys(tmp_path):
    """``{model: ...}`` / ``{generator: ...}`` entries or a bare state
    dict; BERT's ``position_ids`` is checked and dropped, its pooler
    dropped, a missing ``num_batches_tracked`` keeps the port's."""
    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    sd = torch_ckpt.to_reference_state_dict(model)
    bert = "prompt_encoder.bert.model."
    assert torch.equal(sd[bert + "embeddings.position_ids"],
                       torch.arange(TINY_BERT.max_position_embeddings)[None])
    assert "decoder.betas" in sd
    sd[bert + "pooler.dense.weight"] = torch.zeros(32, 32)
    sd.pop("encoder.encoder.encoders.0.conv_module.norm.num_batches_tracked")
    for i, payload in enumerate(({"epoch": 1, "model": sd, "optimizer": {}},
                                 sd)):
        torch.save(payload, tmp_path / f"m{i}.pth")
        other = flagship.build_model(tiny_model_config(), "cpu", 1,
                                     TINY_BERT)
        torch_ckpt.load_reference_state_dict(
            other, torch_ckpt.torch_state_dict(tmp_path / f"m{i}.pth"))
        for k, v in model.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), k
    bad = dict(sd)
    bad[bert + "embeddings.position_ids"] = torch.zeros(1, 32,
                                                        dtype=torch.long)
    with pytest.raises(ValueError, match="position_ids"):
        torch_ckpt.load_reference_state_dict(model, bad)
    torch.save({"generator": {"x": torch.zeros(1)}}, tmp_path / "v.pt")
    assert list(torch_ckpt.torch_state_dict(tmp_path / "v.pt",
                                            "vocoder")) == ["x"]
