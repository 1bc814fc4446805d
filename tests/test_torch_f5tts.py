"""F5-TTS v1 with Vocos in the port (``models/f5tts.py``, ``nn/dit.py``,
``vocoders/vocos.py``, ``ops/stft.py::istft``, the HTK mel of
``ops/mel.py``, the Synthesizer's F5 front), each against the plain
reference ``reference/f5tts_plain.py`` on seeded weights, at a small size:
dim 64, depth 2, 4 heads, text_dim 32, one text layer, NFE 4, Vocos dim 32
with 2 layers. Also the shared code the flagship runs: ConvNeXt at its
default eps and the decode graph's counters of the diffusion decode."""

import copy
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from perfbench.harness import weights
from promptttspp_tpu_torch import flagship, infer
from promptttspp_tpu_torch.infer import Synthesizer
from promptttspp_tpu_torch.models import decode_graph
from promptttspp_tpu_torch.models.f5tts import (DiT, F5TTS, duration,
                                                sway_grid)
from promptttspp_tpu_torch.nn.convnext import ConvNeXt1d
from promptttspp_tpu_torch.ops import mel as mel_ops
from promptttspp_tpu_torch.ops.stft import istft
from promptttspp_tpu_torch.reference import f5tts_plain as plain
from promptttspp_tpu_torch.utils import trace
from promptttspp_tpu_torch.vocoders.vocos import Vocos

REPO = Path(__file__).resolve().parent.parent
ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=100,
            text_num_embeds=40, text_dim=32, conv_layers=1)
VOC = dict(dim=32, intermediate_dim=48, num_layers=2)
NFE = 4
TOL = dict(atol=2e-5, rtol=1e-4)
# (reference frames, transcript ids, ids to speak): 3 requests of
# different lengths, the longest 40 + 40 / 9 * 7 = 71 frames
REQUESTS = ((20, 5, 7), (40, 9, 7), (12, 6, 10))


def _pair(seed=3):
    """The port's model and Vocos and the plain ones, on the weights of
    ``seed``."""
    model = F5TTS(DiT(**ARCH), nfe=NFE).eval()
    vocoder = Vocos(**VOC).eval()
    ref, ref_voc = plain.F5TTS(**ARCH), plain.Vocos(**VOC)
    for a, b, tag in ((model, ref, "model"), (vocoder, ref_voc, "vocoder")):
        weights.fill(a, weights.sub_seed(seed, tag))
        weights.fill(b, weights.sub_seed(seed, tag))
    return model, vocoder, ref, ref_voc


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    return [dict(wav=(0.1 * rng.standard_normal((n - 1) * 256))
                 .astype(np.float32),
                 ref_text=rng.integers(0, 39, nt).tolist(),
                 text=rng.integers(0, 39, ng).tolist(), seed=100 + i)
            for i, (n, nt, ng) in enumerate(REQUESTS)]


def _synth(model, vocoder):
    return Synthesizer(model, vocoder, to_mel=mel_ops.VOCOS_MEL,
                       upsample=256, frame_quantum=32, device="cpu")


def _serve(synth, reqs):
    return synth.synthesize([r["text"] for r in reqs],
                            reference_wavs=[r["wav"] for r in reqs],
                            reference_texts=[r["ref_text"] for r in reqs],
                            seed=[r["seed"] for r in reqs])


def test_parameters_have_the_plain_references_names_and_shapes():
    model, vocoder, ref, ref_voc = _pair()
    for a, b in ((model, ref), (vocoder, ref_voc)):
        assert {n: tuple(p.shape) for n, p in a.named_parameters()} == \
            {n: tuple(p.shape) for n, p in b.named_parameters()}
        for (n, p), (_, q) in zip(sorted(a.named_parameters()),
                                  sorted(b.named_parameters())):
            assert torch.equal(p, q), n


@torch.no_grad()
def test_dit_forward_both_guided_halves_match_the_plain_reference():
    model, _, ref, _ = _pair()
    g = torch.Generator().manual_seed(0)
    lengths, T, B = [30, 19], 32, 2
    frames = torch.arange(T)[None, :, None]
    mask = frames < torch.tensor(lengths)[:, None, None]
    x = torch.randn((B, T, 100), generator=g)
    cond = torch.randn((B, T, 100), generator=g)
    ids = torch.randint(1, 40, (B, T), generator=g)
    ids[0, 11:], ids[1, 7:] = 0, 0
    dit = model.dit
    text = torch.cat([dit.text_embed(ids, mask),
                      dit.text_embed(ids, mask, drop=True)])
    t = torch.full((2 * B,), 0.37)
    out = dit(torch.cat([x, x]), torch.cat([cond, torch.zeros_like(cond)]),
              text, t, torch.cat([mask, mask]))
    for half, drop in ((0, False), (1, True)):
        for i, n in enumerate(lengths):
            text_r = ref.dit.text_embed(ids[i, :n], drop=drop)
            c = torch.zeros_like(cond[i, :n]) if drop else cond[i, :n]
            want = ref.dit(x[i, :n], c, text_r, torch.tensor(0.37))
            torch.testing.assert_close(out[half * B + i, :n], want, **TOL)


def test_sway_grid_is_the_published_warp():
    t = np.linspace(0.0, 1.0, 33)
    want = t - (np.cos(np.pi / 2 * t) - 1 + t)
    np.testing.assert_allclose(sway_grid(32, -1.0), want.astype(np.float32),
                               atol=1e-7)
    assert sway_grid(32, -1.0)[0] == 0.0 and sway_grid(32, -1.0)[-1] == 1.0
    np.testing.assert_array_equal(sway_grid(8, -1.0),
                                  plain.sway_grid(8, -1.0).numpy())
    assert duration(282, 42, 154) == 282 + int(282 / 42 * 154)


def test_sampler_and_vocos_match_the_plain_reference():
    model, vocoder, ref, ref_voc = _pair()
    reqs = _requests()
    wavs, mels = _serve(_synth(model, vocoder), reqs)
    for r, wav, mel in zip(reqs, wavs, mels):
        ref_mel = plain.log_mel(torch.as_tensor(r["wav"]))
        want_mel, want_wav = plain.synthesize(
            ref, ref_voc, ref_mel, r["ref_text"], r["text"], r["seed"],
            nfe=NFE)
        assert mel.shape == tuple(want_mel.shape)
        assert wav.shape == (mel.shape[0] * 256,)
        np.testing.assert_allclose(mel, want_mel.numpy(), atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(wav, want_wav.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("group", [3, 2])
def test_a_batch_of_three_equals_each_request_alone(group, monkeypatch):
    """Decoded as one group at the longest request's bucket, or in the
    Synthesizer's groups of two sorted by frame count (the longest alone,
    at its own bucket)."""
    monkeypatch.setattr(infer, "F5_DECODE_GROUP", group)
    model, vocoder, _, _ = _pair()
    reqs = _requests(1)
    synth = _synth(model, vocoder)
    wavs, mels = _serve(synth, reqs)
    for i, r in enumerate(reqs):
        wav, mel = _serve(synth, [r])
        np.testing.assert_allclose(mels[i], mel[0], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(wavs[i], wav[0], atol=1e-6, rtol=1e-5)


@torch.no_grad()
def test_vocos_batched_with_lengths_matches_the_plain_reference():
    _, vocoder, _, ref_voc = _pair(5)
    g = torch.Generator().manual_seed(1)
    lengths = [24, 9, 17]
    mel = torch.randn((3, 24, 100), generator=g)
    mel[1, 9:] = 123.0  # what lies past an item's end never reaches it
    wav = vocoder(mel, torch.tensor(lengths))
    assert wav.shape == (3, 24 * 256)
    for i, n in enumerate(lengths):
        want = ref_voc(mel[i, :n])
        torch.testing.assert_close(wav[i, : n * 256], want, **TOL)
        assert torch.all(wav[i, n * 256 + 384:] == 0)


def test_istft_matches_the_plain_reference_and_masks_frames():
    g = torch.Generator().manual_seed(2)
    spec = torch.complex(torch.randn((2, 11, 513), generator=g),
                         torch.randn((2, 11, 513), generator=g))
    y = istft(spec, 1024, 256)
    assert y.shape == (2, 11 * 256)
    for i in range(2):
        torch.testing.assert_close(y[i], plain.istft(spec[i], 1024, 256),
                                   **TOL)
    keep = torch.arange(11)[None, :] < torch.tensor([[11], [6]])
    y = istft(spec, 1024, 256, keep)
    torch.testing.assert_close(y[1, : 6 * 256],
                               plain.istft(spec[1, :6], 1024, 256), **TOL)
    # a constant window: the squared overlap-add of the periodic Hann
    # window at hop n / 4 is 1.5 away from the ends
    ones = torch.fft.rfft(torch.ones(1024) / torch.hann_window(1024)
                          .clamp(min=1e-3))
    assert torch.isfinite(istft(ones.expand(1, 8, -1), 1024, 256)).all()


def test_htk_mel_filterbank_is_its_formula():
    fb = mel_ops.mel_filterbank(24000, 1024, 100, 0.0, 12000.0, "htk", None)
    assert fb.shape == (513, 100) and fb.dtype == np.float32
    np.testing.assert_allclose(
        fb, plain.htk_mel_filterbank(24000, 1024, 100, 0.0, 12000.0),
        atol=1e-6)
    # each triangle peaks at 1 on the bin nearest its centre
    mels = np.linspace(0.0, 2595.0 * math.log10(1.0 + 12000.0 / 700.0), 102)
    centres = 700.0 * (10.0 ** (mels[1:-1] / 2595.0) - 1.0)
    bins = np.linspace(0.0, 12000.0, 513)
    for m in (10, 50, 99):
        k = int(np.argmax(fb[:, m]))
        assert abs(bins[k] - centres[m]) <= bins[1] - bins[0]
    # slaney stays the default
    np.testing.assert_array_equal(
        mel_ops.mel_filterbank(24000, 512, 80, 63.0, 12000.0),
        mel_ops.mel_filterbank(24000, 512, 80, 63.0, 12000.0, "slaney",
                               "slaney"))
    wav = torch.randn(5000, generator=torch.Generator().manual_seed(4))
    got = mel_ops.VOCOS_MEL(wav)
    assert got.shape == (5000 // 256 + 1, 100)
    torch.testing.assert_close(got, plain.log_mel(wav), **TOL)


@torch.no_grad()
def test_convnext_at_its_default_eps_is_unchanged():
    torch.manual_seed(0)
    net = ConvNeXt1d(16, 32, 2)
    for p in net.parameters():
        p.uniform_(-0.5, 0.5)
    assert all(m.eps == 1e-5 for m in net.modules()
               if isinstance(m, torch.nn.LayerNorm))
    x = torch.randn(2, 9, 16)
    mask = (torch.arange(9)[None, :, None] < torch.tensor([9, 5])[:, None,
                                                                 None])
    mask = mask.float()

    def ln(y, m):
        return torch.nn.functional.layer_norm(y, (16,), m.weight, m.bias,
                                              1e-5)

    y = ln(x, net.norm_pre)
    for layer in net.layers:
        h = torch.nn.functional.conv1d(
            y.transpose(1, 2), layer.dw_conv.weight, layer.dw_conv.bias,
            padding=3, groups=16).transpose(1, 2)
        h = layer.pw_conv2(torch.nn.functional.gelu(
            layer.pw_conv1(ln(h, layer.norm))))
        y = (y + layer.scale * h) * mask
    torch.testing.assert_close(net(x, mask), ln(y, net.norm_post) * mask,
                               rtol=0, atol=0)
    assert all(m.eps == 1e-6 for m in Vocos(**VOC).modules()
               if isinstance(m, torch.nn.LayerNorm))


def test_f5_and_vocos_constants_equal_the_yaml():
    model = yaml.safe_load((REPO / "conf/torch/model/f5tts_v1_base.yaml")
                           .read_text())
    voc = yaml.safe_load((REPO / "conf/torch/vocoder/vocos_mel_24khz.yaml")
                         .read_text())
    assert model == flagship.F5TTS_V1_BASE
    assert voc == flagship.VOCOS_MEL_24KHZ
    small = copy.deepcopy(flagship.F5TTS_V1_BASE)
    small["arch"].update({k: v for k, v in ARCH.items() if k != "mel_dim"})
    small["sampler"]["nfe_step"] = NFE
    built = flagship.build_f5tts(small, device="cpu")
    assert built.dit.dtype == torch.float16 and built.nfe == NFE
    assert built.cfg_strength == 2.0 and built.sway_coef == -1.0
    assert isinstance(flagship.build_vocos("cpu", cfg=dict(
        flagship.VOCOS_MEL_24KHZ, **VOC)), Vocos)


def test_replay_counts_hold_their_formulas():
    model = F5TTS(DiT(**ARCH), nfe=NFE)
    B, T = 3, 96
    cond = (torch.zeros(B, T, 100), torch.zeros(B, T, dtype=torch.long),
            torch.zeros(B, dtype=torch.long), torch.zeros(B,
                                                          dtype=torch.long))
    counts = decode_graph._replay_counts(model, cond)
    assert counts == {"decode.passes_run": 2 * NFE,
                      "decode.blocks_run": 2 * NFE * ARCH["depth"],
                      "f5.attn_flops": 4 * 2 * B * ARCH["heads"] * T * T
                      * ARCH["dim_head"] * ARCH["depth"] * NFE}


def test_diffusion_decode_counts_are_what_they_were():
    from tests.test_torch_cuda import tiny_model_config

    model = flagship.build_model(tiny_model_config(), "cpu")
    dec = model.decoder
    cond = torch.zeros(2, 64, dec.denoise_fn.residual_layers[0]
                       .conditioner_projection.in_channels)
    n = dec.n_denoiser_calls() * len(dec.denoise_fn.residual_layers)
    assert decode_graph._replay_counts(dec, cond) == {
        "decode.blocks_run": n, "decode.blocks_fused": 0}


def test_decode_on_the_cpu_runs_the_eager_sampler():
    model, _, _, _ = _pair()
    B, T = 2, 32
    g = torch.Generator().manual_seed(3)
    cond = (torch.randn(B, T, 100, generator=g),
            torch.randint(1, 40, (B, T), generator=g),
            torch.tensor([32, 20]), torch.tensor([10, 5]))
    x_T = torch.randn(B, T, 100, generator=g)
    with torch.no_grad():
        got = decode_graph.decode(model, cond, x_T)
        want = model.sample(cond, x_T[None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="x_T"):
        model.inference(cond, None)


@pytest.mark.parametrize("group, decoded", [(3, 3 * 96), (2, 2 * 64 + 96)])
def test_serving_records_the_spans_and_counters(group, decoded,
                                                monkeypatch):
    monkeypatch.setattr(infer, "F5_DECODE_GROUP", group)
    model, vocoder, _, _ = _pair()
    synth = _synth(model, vocoder)
    reqs = _requests(2)
    trace.clear()
    with trace.recording():
        _serve(synth, reqs)
    names = {s.name for s in trace.spans()}
    assert {"synth.request", "synth.inputs", "synth.acoustic",
            "synth.decode", "synth.vocoder", "synth.readback"} <= names
    counts = {c.name: c.n for c in trace.counts()}
    lens = [duration(n, nt, ng) for n, nt, ng in REQUESTS]
    assert counts["synth.frames_useful"] == sum(lens)
    assert counts["synth.frames_decoded"] == decoded
    trace.clear()


def test_f5_front_refuses_what_it_does_not_serve():
    model, vocoder, _, _ = _pair()
    with pytest.raises(ValueError, match="F5TTS"):
        Synthesizer(model, vocoder, speculative=True, device="cpu")
    synth = _synth(model, vocoder)
    r = _requests()[0]
    with pytest.raises(ValueError, match="reference_texts"):
        synth.synthesize([r["text"]], reference_wavs=[r["wav"]])
    synth.max_frames_cap = 32
    with pytest.raises(ValueError, match="cap"):
        _serve(synth, [r])
