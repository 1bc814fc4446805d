"""Batch eval synthesis with the port: for each utterance of the filtered
eval list, synthesize with the reference mel and with a style prompt, and
write the eval tree ``<output_dir>/<spk>/{ref,prompt}/wav/<utt>.wav`` plus a
``finish`` marker.

Counterpart of ``egs/proposed/bin/synthesize.py``, with its command line
for the keys it reads (defaults of ``conf/synthesize.yaml``,
``bin/conf.py``)::

    python3 -m promptttspp_tpu_torch.bin.synthesize path.root=<repo> \\
        model_ckpt=<model.ckpt> vocoder_ckpt=<vocoder.ckpt> \\
        [output_dir=...] [num_eval_utts=50] [use_max=true] \\
        [noise_scale=0.5] [seed=1234] [+speculative=true] \\
        [+spec_duration_table=<npz>] [+spec_margin=3] \\
        [+spec_rate_margin=0.2] [+decode_param_dtype=bfloat16] \\
        [+vocoder_mode=batched|chunked|sharded] \\
        [+frame_sharded_decode=true] [device=cpu]

It runs on ``cuda``; ``device=cpu`` runs it on the CPU. Checkpoints are the
reference's torch files (or ``.npz`` state dicts), read by
``compat/torch_ckpt.py``. It reads ``<path.filtered_df_dir>/
eval_filtered.csv`` (``spk_id``, ``item_name``, ``seq``,
``style_prompt_key``), ``path.prompt_candidate_file``,
``<path.mel_dir>/stats.yaml``, ``path.bert_vocab_file`` and the corpus
wavs under ``path.data_root`` (the mel63 npys where a wav is absent). As in
JAX, the working directory becomes ``hydra.run.dir`` first.
``+vocoder_mode=sharded`` and ``+frame_sharded_decode=true`` spread a
request over a mesh of every visible GPU, as JAX's over every device of
its platform; with ``device=cpu`` the mesh is the one CPU device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.compat.torch_ckpt import (
    load_reference_state_dict, torch_state_dict)
from promptttspp_tpu_torch.data.dataset import (
    read_csv_rows, read_mel_stats, read_prompt_candidate)
from promptttspp_tpu_torch.infer import Synthesizer, write_wav
from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from promptttspp_tpu_torch.parallel.mesh import make_mesh
from promptttspp_tpu_torch.platform import resolve_device


def load_checkpoint(module, path, kind: str):
    """Load a reference checkpoint file into ``module``."""
    return load_reference_state_dict(module, torch_state_dict(path, kind))


def mel_transform(transforms: Dict) -> MelSpectrogramTransform:
    """``MelSpectrogramTransform`` from the ``transforms`` config group; the
    port has the slaney mel scale and norm only."""
    for key in ("mel_scale", "norm"):
        if transforms.get(key, "slaney") != "slaney":
            raise ValueError(f"transforms.{key}={transforms[key]!r} is not "
                             "ported")
    return MelSpectrogramTransform(
        sample_rate=transforms["sample_rate"], n_fft=transforms["n_fft"],
        win_length=transforms["win_length"],
        hop_length=transforms["hop_length"],
        power=float(transforms["power"]), f_min=float(transforms["f_min"]),
        f_max=float(transforms["f_max"]), n_mels=transforms["n_mels"],
        center=transforms["center"])


def build_synthesizer(cfg: Dict, mel_stats_file=None) -> Synthesizer:
    """The model and vocoder of ``cfg`` with the weights of
    ``cfg["model_ckpt"]`` / ``cfg["vocoder_ckpt"]``, the mel statistics of
    ``mel_stats_file`` (default ``<path.mel_dir>/stats.yaml``), the
    WordPiece tokenizer of ``path.bert_vocab_file`` and the serving knobs
    of ``cfg``, on ``cfg["device"]``. A sharded vocoder or decode runs
    over every visible GPU (the ``Synthesizer``'s own mesh), or over the
    one CPU device with ``device=cpu``."""
    for key in ("model_ckpt", "vocoder_ckpt"):
        if not cfg.get(key):
            raise ValueError(f"{key}=<checkpoint file> is required")
    device = cfg.get("device", conf.DEVICE)
    model = load_checkpoint(flagship.build_model(cfg["model"], device),
                            cfg["model_ckpt"], "model")
    vocoder = load_checkpoint(
        flagship.build_vocoder(device, cfg=cfg["vocoder"]),
        cfg["vocoder_ckpt"], "vocoder")
    if mel_stats_file is None:
        mel_stats_file = Path(cfg["path"]["mel_dir"]) / "stats.yaml"
    spec_kw = {}
    if cfg.get("spec_duration_table"):
        with np.load(cfg["spec_duration_table"]) as t:
            spec_kw = dict(spec_duration_table=t["mean"],
                           spec_duration_std=t["std"])
    vocoder_mode = cfg.get("vocoder_mode", "batched")
    frame_sharded = cfg.get("frame_sharded_decode", False)
    mesh = None
    if (vocoder_mode == "sharded" or frame_sharded) \
            and resolve_device(device).type == "cpu":
        mesh = make_mesh(devices=[device])
    return Synthesizer(
        model, vocoder, mel_stats=read_mel_stats(mel_stats_file),
        tokenizer=WordPieceTokenizer.from_vocab_file(
            cfg["path"]["bert_vocab_file"]),
        to_mel=mel_transform(cfg["transforms"]),
        vocoder_mode=vocoder_mode, frame_sharded_decode=frame_sharded,
        mesh=mesh, decode_param_dtype=cfg.get("decode_param_dtype", None),
        speculative=cfg.get("speculative", False),
        spec_margin=cfg.get("spec_margin", 3.0),
        spec_rate_margin=cfg.get("spec_rate_margin", 0.2),
        device=device, **spec_kw)


def read_wav(path):
    """A wav file -> (sample rate, float32 samples); integer PCM is scaled
    by its maximum."""
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    if wav.dtype.kind == "i":
        wav = wav.astype(np.float32) / np.iinfo(wav.dtype).max
    return sr, wav.astype(np.float32)


def load_reference_mel(synth: Synthesizer, cfg: Dict, spk, utt):
    """The corpus wav's log-mel [T, n_mels]; the mel63 npy (stored
    [n_mels, T]) where the wav is absent. Raw: the Synthesizer
    normalizes."""
    wav_path = Path(cfg["path"]["data_root"]) / str(spk) / "wav24k" \
        / f"{utt}.wav"
    if wav_path.exists():
        return synth.wav_to_mel(read_wav(wav_path)[1])
    return np.load(Path(cfg["path"]["mel_dir"]) / str(spk)
                   / f"{utt}.npy").T


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``); returns the
    output directory."""
    cfg = conf.compose("synthesize", sys.argv[1:] if argv is None else argv)
    conf.enter_run_dir(cfg)
    synth = build_synthesizer(cfg)
    rows = read_csv_rows(Path(cfg["path"]["filtered_df_dir"])
                         / "eval_filtered.csv")
    rows = rows[: cfg.get("num_eval_utts", 50)]
    prompt_candidate = read_prompt_candidate(
        cfg["path"]["prompt_candidate_file"])
    out_dir = Path(cfg["output_dir"])
    kw = dict(use_max=cfg.get("use_max", True),
              noise_scale=cfg.get("noise_scale", 0.5))

    rng = np.random.RandomState(cfg.get("seed", 1234))
    for row in rows:
        spk, utt = row["spk_id"], row["item_name"]
        seq = [int(s) for s in row["seq"].split()]
        prompt = rng.choice(prompt_candidate[row["style_prompt_key"]])
        for mode in ("ref", "prompt"):
            wav_dir = out_dir / spk / mode / "wav"
            wav_dir.mkdir(parents=True, exist_ok=True)
            if mode == "ref":
                wavs, _ = synth.synthesize(
                    [seq], reference_mels=[load_reference_mel(synth, cfg, spk,
                                                              utt)],
                    return_mels=False, **kw)
            else:
                wavs, _ = synth.synthesize([seq], prompts=[f"{prompt}."],
                                           return_mels=False, **kw)
            write_wav(wav_dir / f"{utt}.wav", wavs[0])
        print(f"wrote {spk}/{utt} (ref + prompt)", flush=True)
    (out_dir / "finish").write_text("finish")
    return out_dir


if __name__ == "__main__":
    main()
