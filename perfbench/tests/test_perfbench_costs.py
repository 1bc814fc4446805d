"""The yardstick's arithmetic against hand counts, and the analytic FLOPs
against torch's own count of the reference's matrix products and
convolutions at the flagship's widths."""


import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.costs import flops, kernels
from perfbench.harness import cell as cells
from perfbench.reference.ptts import build

CFG = cells.load("serve_offline_b16")["config"]
MODEL = CFG["model"]


def test_decode_per_frame_by_hand():
    # per frame and step: input 80->256, 20 x (dilated 256->512 k3 +
    # output 256->512), skip 256->256, output 256->80; 100 steps; the 20
    # conditioner projections 256->512 once per decode
    step = 2 * (80 * 256 + 20 * (256 * 512 * 3 + 256 * 512)
                + 256 * 256 + 256 * 80)
    assert step == 21_184_512
    cond = 2 * 20 * 256 * 512
    per_row = 2 * (256 * 1024 * 2) + 20 * 2 * 256 * 256  # mlp, projections
    T = 1000
    assert flops.decode(MODEL, T) == cond * T + 100 * (step * T + per_row)


def test_vocoder_by_hand():
    voc = dict(sampling_rate=24000, harmonic_num=2, in_channel=4,
               upsample_initial_channel=8, upsample_rates=[2],
               upsample_kernel_sizes=[4], resblock_kernel_sizes=[3],
               resblock_dilations=[[1]])
    T = 10
    got = flops.vocoder(voc, T)
    # one stage: 8 -> 4 channels at 20 samples; one AMPLayer (two 4x4 k3
    # mixes); the noise conv 1 -> 4 (k1), conv_pre 4 -> 8 k7, the
    # transposed conv 8 -> 4 k4 over 10 inputs, conv_post 4 -> 1 k7, the
    # source's linear 3 -> 1, the layer's bias and residual adds
    assert got["mix"] == 2 * (2 * 4 * 4 * 3 * 20)
    assert got["aa"] == 2 * kernels.AA_FLOPS * 4 * 20 + \
        kernels.AA_FLOPS * 4 * 20
    assert got["other"] == 2 * 4 * 8 * 7 * 10 + 2 * 8 * 4 * 4 * 10 \
        + 2 * 4 * 20 + 3 * 4 * 20 + 2 * 4 * 7 * 20 + 2 * 3 * 20


def test_kernel_bound_by_hand():
    B, T, C, k = 1, 3840, 256, 3
    t_bytes, t_mix, t_fp32 = kernels.k2_bf16_bound(B, T, C, k)
    assert t_bytes == pytest.approx(((2 * T * C + 4 * C) * 4
                                     + 2 * k * C * C * 2) / 3.35e12)
    assert t_mix == pytest.approx(4 * k * C * C * T / 989e12)
    assert t_fp32 == pytest.approx((2 * T * C * 92 + 3 * T * C) / 67e12)
    assert kernels.AA_FLOPS == 92
    # the 36 layers of a 640-frame request (PERF.md: 0.401 ms)
    assert kernels.vocoder_k2_bf16_bound_s(CFG["vocoder"], 1, 640) * 1e3 \
        == pytest.approx(0.401, abs=0.001)


def _count(fn):
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def ref():
    return build.build_model(MODEL, "cpu")


def test_acoustic_model_against_torch_count(ref):
    Tp, L, Tf = 7, 9, 23
    ph = torch.randint(1, 90, (1, Tp))
    pl = torch.tensor([Tp])
    ids = torch.randint(1000, 2000, (1, L))
    mask = torch.ones(1, L, dtype=torch.long)
    x, pm = ref._encode_phones(ph, pl)
    assert _count(lambda: ref._encode_phones(ph, pl)) == \
        flops.conformer(MODEL["encoder"], Tp)
    b = flops.bert(MODEL["prompt_encoder"], L)
    assert _count(lambda: ref._style(ids, mask, None, None, True, 0.5,
                                     None)) == \
        sum(b["layers"]) + b["adaptor"] + flops.style_mdn(MODEL)
    # the phone-to-frame expansion runs as a one-hot product, a gather
    # that the analytic count leaves out
    expansion = 2 * Tp * Tf * MODEL["phoneme_embedding"]["channels"]
    assert _count(lambda: ref.variance_adaptor.infer(x, pm, Tf)) == \
        flops.variance_adaptor(MODEL, Tp, Tf) + expansion


def test_diffnet_and_reference_encoder_against_torch_count(ref):
    T = 23
    cond = torch.randn(1, T, 256)
    cp = ref.decoder.denoise_fn.precompute_cond(cond)
    assert _count(lambda: ref.decoder.denoise_fn.precompute_cond(cond)) \
        == flops.diffnet_cond(MODEL, T)
    assert _count(lambda: ref.decoder.denoise_fn(
        torch.randn(1, T, 80), torch.tensor([5]), cp)) == \
        flops.diffnet_step(MODEL, T)
    mel = torch.randn(1, 64, 80)
    assert _count(lambda: ref.reference_encoder(mel, torch.tensor([64]))) \
        == flops.reference_encoder(MODEL, 64)


def test_train_step_counts_frozen_bert_once():
    f = flops.train_forward(MODEL, 50, 400, 20)
    assert flops.train_step(MODEL, 50, 400, 20) == \
        f["frozen"] + 3 * f["trained"]
    assert f["frozen"] == 11 * flops.bert_layer(768, 3072, 20)
