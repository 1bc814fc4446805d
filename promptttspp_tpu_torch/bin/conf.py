"""The configs of the port's entry points: ``conf/synthesize.yaml``
(``bin/synthesize.py``, ``bin/eval.py``), ``conf/demo.yaml`` (``app.py``),
``conf/train.yaml`` (``bin/train.py``) and ``conf/preprocess.yaml``
(``bin/{preprocess,compute_mel,split_df,filter_eval}.py``) with their
groups (``conf/path/default.yaml``, ``conf/transforms/mel.yaml``,
``conf/optimizer/adamw.yaml``, ``conf/train/noam.yaml``,
``conf/dataset/mel.yaml``, the model and vocoder of ``flagship.py``), as
Python constants with the interpolations kept as written and the
``_target_`` keys dropped: the machine with the GPU reads no YAML. A CPU
test holds ``compose``'s result equal to the JAX ``compose`` of the same
YAML files and overrides.

The port adds one key, ``device`` (``cuda``; ``device=cpu`` runs on the
CPU). ``model=<name>`` and ``vocoder=<name>`` switch a group among those
the port has.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Dict, Sequence

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.config import apply_overrides, resolve

# conf/path/default.yaml
PATH = {
    "root": "path/to/your/promptttspp_tpu",
    "data_root": "${.root}/data_prep/out/libritts_r_per_spk_cleaned",
    "data_csv_file": "${.root}/metadata/metadata_w_style_prompt_tags.csv",
    "data_dir": "${.root}/dump/libritts_r_per_spk_cleaned",
    "text_dir": "${.data_dir}/text",
    "feats_dir": "${.data_dir}/feats",
    "df_dir": "${.data_dir}/df",
    "filtered_df_dir": "${.data_dir}/df_filtered",
    "mel_dir": "${.data_dir}/mel63",
    "data_file": "${.df_dir}/data.csv",
    "train_file": "${.filtered_df_dir}/trn.csv",
    "valid_file": "${.filtered_df_dir}/val.csv",
    "eval_file": "${.df_dir}/eval.csv",
    "filtered_eval_file": "${.filtered_df_dir}/eval_filtered.csv",
    "speaker_file": "${.root}/data_prep/external/speakers.tsv",
    "f0_stats_file": "${.root}/metadata/libritts_r_f0_stats.yaml",
    "prompt_candidate_file": "${.root}/metadata/style_prompt_candidates.csv",
    "spk_prompt_candidate_file":
        "${.root}/metadata/speaker_prompt_candidates.csv",
    "bert_vocab_file": "${.root}/metadata/bert-base-uncased-vocab.txt",
    "bert_weights_file": None,
}

# conf/transforms/mel.yaml
TRANSFORMS = {
    "sample_rate": 24000, "n_fft": 512, "win_length": 480, "hop_length": 240,
    "power": 1, "f_min": 63, "f_max": 12000, "n_mels": 80,
    "mel_scale": "slaney", "norm": "slaney", "center": True,
}

# conf/synthesize.yaml (its own keys)
SYNTHESIZE = {
    "output_dir": "./out/synthesis",
    "model_ckpt": None,
    "vocoder_ckpt": None,
    "num_eval_utts": 50,
    "use_max": True,
    "noise_scale": 0.5,
    "seed": 1234,
}
SYNTHESIZE_HYDRA_RUN_DIR = "./out/hydra/synthesize"

# conf/demo.yaml (its own keys)
DEMO = {
    "model_ckpt": None,
    "vocoder_ckpt": None,
    "mel_stats_file": "${path.mel_dir}/stats.yaml",
    "use_max": True,
    "noise_scale": 0.5,
    "host": "0.0.0.0",
    "port": 7860,
}
DEMO_HYDRA_RUN_DIR = "./"

# conf/optimizer/adamw.yaml
OPTIMIZER = {"lr": 0.001, "betas": [0.9, 0.98], "weight_decay": 0.0}

# conf/train/noam.yaml
TRAIN_GROUP = {
    "seed": 42, "num_epochs": 1000, "save_interval": 20, "batch_size": 32,
    "num_workers": 8, "bf16": False, "fp16": False,
    "lr_scheduler": {"warmup_steps": 4000}, "per_epoch_scheduler": False,
}


def _split(split_file: str):
    return {
        "file_path": "${...path." + split_file + "}",
        "data_root": "${...path.data_root}",
        "feats_dir": "${...path.feats_dir}",
        "mel_dir": "${...path.mel_dir}",
        "prompt_candidate_file": "${...path.prompt_candidate_file}",
        "spk_prompt_candidate_file": "${...path.spk_prompt_candidate_file}",
    }


# conf/dataset/mel.yaml
DATASET = {"collator": {}, "train": _split("train_file"),
           "valid": _split("valid_file"), "dynamic_batch": True,
           "max_tokens": 10000}

# conf/train.yaml (its own keys)
TRAIN = {"output_dir": "./out", "ckpt_path": None, "pretrained": None}
TRAIN_HYDRA_RUN_DIR = "./out/hydra/train"

# conf/preprocess.yaml (its own keys)
PREPROCESS = {
    "sample_rate": 24000, "n_fft": 512, "hop_length": 240,
    "eval_ids": [121, 237, 260, 908, 1089, 1188, 1284, 1580, 1995, 2300],
    "min_sec": 3.0, "max_sec": 10.0, "n_jobs": 8, "debug": False,
    "use_tpu_features": True, "batch_size": 16, "f0_method": "yin",
}
PREPROCESS_HYDRA_RUN_DIR = "./out/hydra/preprocess"

# the group choices the port has (conf/model/*.yaml, conf/vocoder/*.yaml)
MODELS = {"prompttts_mdn_v2_wo_erg_final": flagship.MODEL_YAML,
          "prompttts_mdn_v2_wo_erg_final_demo": flagship.MODEL_DEMO_YAML}
VOCODERS = {"bigvgan_f0": flagship.VOCODER}

# the port's own key: the device its entry points run on
DEVICE = "cuda"


def base_config(name: str) -> Dict[str, Any]:
    """The unresolved config of ``synthesize``, ``demo``, ``train`` or
    ``preprocess``."""
    if name == "preprocess":
        cfg = {**PREPROCESS, "path": PATH, "transforms": TRANSFORMS,
               "hydra": {"run": {"dir": PREPROCESS_HYDRA_RUN_DIR}},
               "device": DEVICE}
        return copy.deepcopy(cfg)
    if name == "train":
        cfg = {"model": MODELS["prompttts_mdn_v2_wo_erg_final"],
               "optimizer": OPTIMIZER, "train": TRAIN_GROUP,
               "dataset": DATASET, "transforms": TRANSFORMS, "path": PATH,
               **TRAIN, "hydra": {"run": {"dir": TRAIN_HYDRA_RUN_DIR}},
               "device": DEVICE}
        return copy.deepcopy(cfg)
    if name == "synthesize":
        own, model, run_dir = (SYNTHESIZE, "prompttts_mdn_v2_wo_erg_final",
                               SYNTHESIZE_HYDRA_RUN_DIR)
    elif name == "demo":
        own, model, run_dir = (DEMO, "prompttts_mdn_v2_wo_erg_final_demo",
                               DEMO_HYDRA_RUN_DIR)
    else:
        raise ValueError(f"unknown config {name!r}: synthesize, demo, "
                         "train or preprocess")
    cfg = {"model": MODELS[model], "transforms": TRANSFORMS, "path": PATH,
           "vocoder": VOCODERS["bigvgan_f0"], **own,
           "hydra": {"run": {"dir": run_dir}}, "device": DEVICE}
    return copy.deepcopy(cfg)


def compose(name: str, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The ``synthesize``, ``demo``, ``train`` or ``preprocess`` config with
    ``overrides`` applied and every interpolation resolved."""
    cfg = base_config(name)
    values = []
    for ov in overrides:
        key, eq, val = ov.partition("=")
        if eq and key in ("model", "vocoder"):
            choices = MODELS if key == "model" else VOCODERS
            if val not in choices:
                raise ValueError(f"{key}={val}: the port has "
                                 f"{sorted(choices)}")
            cfg[key] = copy.deepcopy(choices[val])
        else:
            values.append(ov)
    return resolve(apply_overrides(cfg, values))


def enter_run_dir(cfg: Dict):
    """Create ``hydra.run.dir`` and make it the working directory, as the
    JAX entry points do, so relative output paths land inside it."""
    run_dir = (cfg.get("hydra") or {}).get("run", {}).get("dir")
    if run_dir:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        os.chdir(run_dir)
