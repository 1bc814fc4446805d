"""Analytic FLOPs of the model, from its configuration and a request's or
a batch row's unpadded lengths: 2 per multiply-add of every matrix
product and convolution (attention's scores and values included);
elementwise work (activations, norms, softmax, the diffusion update) is
not counted, but for AA, the anti-aliased Snake, counted at
``kernels.AA_FLOPS`` per element as the kernel bounds count it.

Each function takes the model configuration (``configs/<name>.json``'s
``model``, or ``vocoder``) and lengths: ``Tp`` phones, ``Tf`` frames,
``L`` prompt tokens. Work that a batch does once for all its rows (the
relative positions' projection) is counted per row, at the row's own
length.
"""

from __future__ import annotations

from typing import Dict

from perfbench.costs.kernels import AA_FLOPS


def conv1d(cin: int, cout: int, k: int, T: int) -> int:
    return 2 * cin * cout * k * T


def conformer(enc: Dict, T: int) -> int:
    """The conformer encoder over ``T`` phones (macaron and plain
    feed-forwards of type "conv1d", "conv1d-linear" or "linear",
    relative-position or plain attention, the convolution module)."""
    d, U = enc["attention_dim"], enc.get("linear_units", 2048)
    kf = enc.get("positionwise_conv_kernel_size", 1)
    kind = enc.get("positionwise_layer_type", "linear")
    w1 = conv1d(d, U, kf if kind in ("conv1d", "conv1d-linear") else 1, T)
    w2 = conv1d(U, d, kf if kind == "conv1d" else 1, T)
    ff = w1 + w2
    per_block = ff * (2 if enc.get("macaron_style", False) else 1)
    per_block += 4 * conv1d(d, d, 1, T) + 2 * 2 * T * T * d
    pos = enc.get("pos_enc_layer_type", "abs_pos")
    if pos == "rel_pos":
        P = (2 * T - 1) if enc.get("rel_pos_type") != "legacy" else T
        per_block += conv1d(d, d, 1, P) + 2 * d * T * P
    if enc.get("use_cnn_module", False):
        per_block += conv1d(d, 2 * d, 1, T) + 2 * d * enc.get(
            "cnn_module_kernel", 31) * T + conv1d(d, d, 1, T)
    return enc.get("num_blocks", 6) * per_block


def bert_layer(h: int, inter: int, L: int) -> int:
    return 4 * conv1d(h, h, 1, L) + 2 * 2 * L * L * h \
        + conv1d(h, inter, 1, L) + conv1d(inter, h, 1, L)


def bert(pe: Dict, L: int) -> Dict[str, int]:
    """The prompt's BERT: {"layers": [each layer's], "adaptor": the MLP
    on the [CLS] vector}."""
    h = pe["in_channels"]
    n = pe.get("bert_num_layers", 12)
    layers = [bert_layer(h, 4 * h, L)] * n
    mid, out = pe["mid_channels"], pe["out_channels"]
    adaptor = 2 * (h * mid + mid * mid + mid * out)
    return {"layers": layers, "adaptor": adaptor}


def mdn_layer(cin: int, out: int, G: int, dim_wise: bool, T: int) -> int:
    return conv1d(cin, G * out if dim_wise else G, 1, T) \
        + 2 * conv1d(cin, G * out, 1, T)


def style_mdn(cfg: Dict) -> int:
    sm = cfg.get("style_mdn")
    if sm is None:
        return 0
    return mdn_layer(sm["in_dim"], sm["out_dim"], sm.get("num_gaussians", 30),
                     sm.get("dim_wise", False), 1)


def variance_adaptor(cfg: Dict, Tp: int, Tf: int) -> int:
    """Durations over the phones; the frame prior, pitch (and energy)
    predictors and embeddings over the frames."""
    va, C = cfg["variance_adaptor"], cfg["phoneme_embedding"]["channels"]
    dp = va["duration_predictor"]
    total = dp["num_layers"] * conv1d(C, C, dp["kernel_size"], Tp) \
        + mdn_layer(C, dp["out_channels"], dp.get("num_gaussians", 4),
                    dp.get("dim_wise", True), Tp)
    fp = va.get("frame_prior_network")
    if fp:
        total += fp["n_layers"] * conv1d(C, C, fp["kernel_size"], Tf)
    for pred, emb in (("pitch_predictor", "pitch_emb"),
                      ("energy_predictor", "energy_emb")):
        p = va.get(pred)
        if not p:
            continue
        total += p["num_layers"] * conv1d(C, C, p["kernel_size"], Tf) \
            + conv1d(C, p["out_channels"], 1, Tf)
        e = va[emb]
        total += conv1d(e["in_channels"], e["out_channels"],
                        e.get("kernel_size", 1), Tf)
    return total


def diffnet_step(cfg: Dict, T: int) -> int:
    """One denoiser call over ``T`` frames, its conditioner projections
    apart (``diffnet_cond``)."""
    dn = cfg["decoder"]["denoise_fn"]
    R, D, n = dn["residual_channels"], dn["in_dim"], dn["residual_layers"]
    k = dn["kernel_size"]
    mlp = 2 * (R * 4 * R + 4 * R * R)
    per_layer = 2 * R * R + conv1d(R, 2 * R, k, T) + conv1d(R, 2 * R, 1, T)
    return conv1d(D, R, 1, T) + mlp + n * per_layer + conv1d(R, R, 1, T) \
        + conv1d(R, D, 1, T)


def diffnet_cond(cfg: Dict, T: int) -> int:
    dn = cfg["decoder"]["denoise_fn"]
    return dn["residual_layers"] * conv1d(dn["encoder_hidden_dim"],
                                          2 * dn["residual_channels"], 1, T)


def decode(cfg: Dict, T: int) -> int:
    """The diffusion decode: the conditioner projections once, then
    ``K_step`` denoiser calls (ancestral sampling)."""
    K = cfg["decoder"].get("K_step", 100)
    return diffnet_cond(cfg, T) + K * diffnet_step(cfg, T)


def acoustic_infer(cfg: Dict, Tp: int, Tf: int, L: int) -> int:
    """``infer_cond``: the encoder, the prompt's style, the variance
    adaptor."""
    b = bert(cfg["prompt_encoder"], L)
    return conformer(cfg["encoder"], Tp) + sum(b["layers"]) + b["adaptor"] \
        + style_mdn(cfg) + variance_adaptor(cfg, Tp, Tf)


def vocoder(voc: Dict, Tf: int) -> Dict[str, int]:
    """The F0-aware BigVGAN over ``Tf`` frames: {"mix": the AMPLayers'
    channel mixes (bf16 at the default precision), "aa": every anti-aliased
    Snake, "other": every other convolution, the AMPLayers' bias and
    residual adds, the source's linear layer}."""
    C0, rates = voc["upsample_initial_channel"], voc["upsample_rates"]
    mix = aa = 0
    other = conv1d(voc["in_channel"], C0, 7, Tf)
    T = Tf
    for i, (u, k) in enumerate(zip(rates, voc["upsample_kernel_sizes"])):
        cin, ch = C0 // 2 ** i, C0 // 2 ** (i + 1)
        other += 2 * cin * ch * k * T  # the transposed convolution
        T *= u
        rest = 1
        for r in rates[i + 1:]:
            rest *= r
        other += conv1d(1, ch, 2 * rest if i + 1 < len(rates) else 1, T)
        for kk, dils in zip(voc["resblock_kernel_sizes"],
                            voc["resblock_dilations"]):
            mix += len(dils) * 2 * conv1d(ch, ch, kk, T)
            aa += len(dils) * 2 * AA_FLOPS * ch * T
            other += len(dils) * 3 * ch * T
    last = C0 // 2 ** len(rates)
    aa += AA_FLOPS * last * T
    other += conv1d(last, 1, 7, T) + 2 * (voc["harmonic_num"] + 1) * T
    return {"mix": mix, "aa": aa, "other": other}


def reference_encoder(cfg: Dict, Tf: int) -> int:
    """The GST reference encoder over a ``Tf``-frame mel (training): the
    strided 2-D convolutions, the GRU over their output, the style-token
    attention."""
    ref = cfg["reference_encoder"]
    k, s = ref["conv_kernel_size"], ref["conv_stride"]
    pad = (k - 1) // 2
    H, W, cin, total = Tf, ref["idim"], 1, 0
    for cout in ref["conv_chans_list"]:
        H = (H + 2 * pad - k) // s + 1
        W = (W + 2 * pad - k) // s + 1
        total += 2 * cin * cout * k * k * H * W
        cin = cout
    hid = ref["gru_units"]
    total += H * 2 * 3 * hid * (W * cin + hid)
    G, heads = ref["gst_tokens"], ref["gst_heads"]
    dim = ref.get("gst_token_dim", 256)
    total += conv1d(hid, dim, 1, 1) + 2 * conv1d(dim // heads, dim, 1, G) \
        + 2 * 2 * G * dim + conv1d(dim, dim, 1, 1)
    return total


def train_forward(cfg: Dict, Tp: int, Tf: int, L: int) -> Dict[str, int]:
    """The training forward of one row: {"frozen": the BERT embeddings'
    and layers' before the last (no gradient reaches them), "trained":
    the rest (the last BERT layer, the prompt adaptor and style MDN, the
    encoder, the reference encoder, the variance adaptor, one denoiser
    call with its conditioner projections)}."""
    b = bert(cfg["prompt_encoder"], L)
    trained = b["layers"][-1] + b["adaptor"] + style_mdn(cfg) \
        + conformer(cfg["encoder"], Tp) + reference_encoder(cfg, Tf) \
        + variance_adaptor(cfg, Tp, Tf) + diffnet_cond(cfg, Tf) \
        + diffnet_step(cfg, Tf)
    return {"frozen": sum(b["layers"][:-1]), "trained": trained}


def train_step(cfg: Dict, Tp: int, Tf: int, L: int) -> int:
    """Forward and backward of one row: the frozen part's forward, and
    three times the forward of the part the gradient runs through."""
    f = train_forward(cfg, Tp, Tf, L)
    return f["frozen"] + 3 * f["trained"]
