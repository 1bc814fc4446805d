"""Tiny versions of the configurations and cells, for runs of the whole
harness on the CPU (the flagship's structure at small widths and
depths)."""

from __future__ import annotations

import copy

from perfbench.harness import cell as cells


def tiny_model(model):
    m = copy.deepcopy(model)
    C = 32
    m["phoneme_embedding"]["channels"] = C
    m["encoder"].update(idim=C, attention_dim=C, attention_heads=2,
                        linear_units=64, num_blocks=1)
    va = m["variance_adaptor"]
    for key in ("duration_predictor", "pitch_predictor"):
        va[key].update(channels=C, num_layers=1)
    va["pitch_emb"]["out_channels"] = C
    va["frame_prior_network"].update(out_channels=C, hidden_channels=C,
                                     n_layers=1)
    m["reference_encoder"].update(conv_chans_list=[4, 4, 8, 8, 16, 16],
                                  gru_units=C, gst_token_dim=C)
    m["prompt_encoder"].update(in_channels=32, mid_channels=32,
                               out_channels=C, bert_num_layers=2,
                               bert_num_heads=2)
    m["style_mdn"].update(in_dim=C, out_dim=C, num_gaussians=2)
    m["decoder"].update(in_dim=C, K_step=6)
    m["decoder"]["denoise_fn"].update(encoder_hidden_dim=C,
                                      residual_layers=2,
                                      residual_channels=16)
    return m


TINY_VOCODER = {
    "sampling_rate": 24000, "harmonic_num": 2, "in_channel": 80,
    "upsample_initial_channel": 16, "upsample_rates": [2, 2],
    "upsample_kernel_sizes": [4, 4], "resblock_kernel_sizes": [3],
    "resblock_dilations": [[1, 3]],
}


def spec(name: str, **params):
    """The spec of cell ``name`` at tiny sizes, its params updated."""
    s = cells.load(name)
    cfg = s["config"] = copy.deepcopy(s["config"])
    cfg["model"] = tiny_model(cfg["model"])
    if "vocoder" in cfg:
        cfg["vocoder"] = TINY_VOCODER
        cfg["synthesizer"]["upsample"] = 4
    s["cell"] = copy.deepcopy(s["cell"])
    s["cell"]["params"].update(params)
    return s


def train_spec(**params):
    """The training cell at tiny sizes: a small corpus in small token
    buckets (several batches an epoch)."""
    s = spec("train_b10k", **params)
    s["config"]["dataset"]["max_tokens"] = 800
    s["config"]["train"]["num_workers"] = 2
    return s
