"""Gender-conditioned pseudo-labels of pitch, speaking speed and energy
from the per-utterance statistics of ``compute_utt_stats``, their style
keys, and the training metadata CSV with the content prompts.

Counterpart of the root ``data_prep/add_style_prompt_tags.py``, with
``csv`` in place of pandas and ``data/yaml_lite.py`` in place of PyYAML;
the CSV is what pandas' ``to_csv`` writes. Run it as ``python -m
promptttspp_tpu_torch.data_prep.add_style_prompt_tags libritts_dir
utt_stats.yaml style_prompt_candidates.csv``; it logs to
``log/add_style_prompt.log`` under the working directory.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.data.dataset import read_prompt_candidate
from promptttspp_tpu_torch.data_prep.common import (
    get_logger, load_libritts_spk_metadata)
from promptttspp_tpu_torch.data_prep.stats import (
    GenderScaler, pseudo_label, style_key)

FIELDS = ("raw_loudness_mean", "raw_lf0_mean", "raw_speaking_rate")
COLUMNS = ("item_name", "spk_id", "gender", "pitch", "speaking_speed",
           "energy", "content_prompt", "style_prompt_key", "raw_f0_mean",
           "raw_f0_scale", "raw_lf0_mean", "raw_lf0_scale",
           "raw_speaking_rate", "raw_loudness_lufs", "raw_loudness_mean",
           "raw_loudness_scale", "invalid")


def get_parser():
    p = argparse.ArgumentParser(
        description="Add style prompt tags to metadata")
    p.add_argument("in_dir", type=str, help="LibriTTS original data root")
    p.add_argument("utt_stats", type=str, help="per-utt stats yaml")
    p.add_argument("style_prompt_candidates", type=str)
    p.add_argument("--out_filename", type=str,
                   default="metadata_w_style_prompt_tags.csv")
    p.add_argument("--failed_list_dir", type=str, default=None,
                   help="dir of *_list.txt with failed restoration utt ids")
    p.add_argument("--speakers_tsv", type=str,
                   default="external/speakers.tsv")
    p.add_argument("--debug", action="store_true")
    return p


def failed_ids(failed_list_dir) -> set:
    """The utterance ids (file stems) listed in ``*_list.txt``."""
    failed = set()
    for path in Path(failed_list_dir).glob("*_list.txt"):
        for line in path.read_text().splitlines():
            if line.strip():
                failed.add(Path(line.strip()).stem)
    return failed


def write_rows(path, rows):
    """The rows under ``COLUMNS``, as pandas writes a frame of them."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows([row[c] for c in COLUMNS] for row in rows)


def main(argv=None):
    args = get_parser().parse_args(argv)
    in_dir = Path(args.in_dir)
    spk2meta = load_libritts_spk_metadata(args.speakers_tsv, debug=args.debug)
    logger = get_logger(100, "log/add_style_prompt.log", "add_style_prompt")
    per_utt = yaml_lite.load(args.utt_stats)
    style_prompt_dict = read_prompt_candidate(args.style_prompt_candidates)
    failed = failed_ids(args.failed_list_dir) if args.failed_list_dir \
        else set()

    # gender-conditioned scalers over the valid utterances
    scalers = {}
    for field in FIELDS:
        by_gender = {"F": [], "M": []}
        for utt_id, meta in per_utt.items():
            if meta["invalid"] != 1:
                gender = spk2meta[utt_id.split("_")[0]]["gender"]
                by_gender[gender].append(meta[field])
        scalers[field] = GenderScaler().fit(by_gender)

    rows = []
    for idx, (utt_id, v) in enumerate(per_utt.items()):
        if args.debug and idx > 100:
            break
        spk_id = utt_id.split("_")[0]
        gender = spk2meta[spk_id]["gender"]
        text_path = (in_dir / spk2meta[spk_id]["subset"] / spk_id
                     / utt_id.split("_", 2)[1]
                     / f"{utt_id}.normalized.txt")
        content_prompt = (text_path.read_text().strip()
                          if text_path.exists() else "")
        pitch = pseudo_label(v["raw_lf0_mean"], gender,
                             scalers["raw_lf0_mean"],
                             ["low", "normal", "high"], level=5)
        speed = pseudo_label(v["raw_speaking_rate"], gender,
                             scalers["raw_speaking_rate"],
                             ["slow", "normal", "fast"], level=5)
        energy = pseudo_label(v["raw_loudness_mean"], gender,
                              scalers["raw_loudness_mean"],
                              ["low", "normal", "high"], level=5)
        key = style_key(gender, pitch, speed, energy)
        if key not in style_prompt_dict:
            logger.warning(f"{utt_id}: no prompt candidates for {key}")
        invalid = v["invalid"]
        if content_prompt.startswith("-") or utt_id in failed:
            invalid = 1
        rows.append({
            **{c: v[c] for c in COLUMNS if c.startswith("raw_")},
            "item_name": utt_id, "spk_id": spk_id, "gender": gender,
            "pitch": pitch, "speaking_speed": speed, "energy": energy,
            "content_prompt": content_prompt, "style_prompt_key": key,
            "invalid": invalid})
    write_rows(args.out_filename, rows)
    logger.info(f"Saved to {args.out_filename}")


if __name__ == "__main__":
    main()
