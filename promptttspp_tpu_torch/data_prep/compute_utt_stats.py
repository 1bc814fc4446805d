"""Per-utterance statistics of the aligned corpus for the style
pseudo-labels: LUFS, the A-weighted frame loudness, F0 mean and spread
(YIN on ``--device``) and the syllable rate, for every
``<in_dir>/<spk>/textgrid/<utt>.TextGrid`` beside its
``wav24k/<utt>.wav``, written as one YAML mapping per utterance.

Counterpart of the root ``data_prep/compute_utt_stats.py``, with
``data/yaml_lite.py`` in place of PyYAML; the YAML is what ``yaml.dump``
writes. Run it as ``python -m
promptttspp_tpu_torch.data_prep.compute_utt_stats in_dir f0_stats.yaml``
(``--device cpu`` without a GPU); it logs to ``log/compute_utt_stats.log``
under the working directory.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.data_prep.common import (
    get_logger, load_libritts_spk_metadata, read_wav_any)
from promptttspp_tpu_torch.data_prep.stats import compute_utt_stats
from promptttspp_tpu_torch.platform import resolve_device


def get_parser():
    p = argparse.ArgumentParser(description="Compute per-utterance statistics")
    p.add_argument("in_dir", type=str,
                   help="per-speaker finalized data root (wav24k/textgrid)")
    p.add_argument("f0_stats", type=str, help="per-speaker f0 stats yaml")
    p.add_argument("--out_filename", type=str,
                   default="libritts_r_metadata.yaml")
    p.add_argument("--num_jobs", type=int, default=8)
    p.add_argument("--speakers_tsv", type=str,
                   default="external/speakers.tsv")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where YIN runs: cuda (default) or cpu")
    return p


def jobs_of(in_dir: Path, speakers):
    """(speaker, TextGrid, wav) of every aligned utterance, in order."""
    jobs = []
    for spk in speakers:
        spk_dir = in_dir / spk
        if not spk_dir.exists():
            continue
        for tg in sorted((spk_dir / "textgrid").glob("*.TextGrid")):
            jobs.append((spk, tg, spk_dir / "wav24k" / f"{tg.stem}.wav"))
    return jobs


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    spk2meta = load_libritts_spk_metadata(args.speakers_tsv, debug=args.debug)
    logger = get_logger(100, "log/compute_utt_stats.log", "compute_utt_stats")
    f0_stats = yaml_lite.load(args.f0_stats)

    def work(job):
        spk, tg, wav_path = job
        wav, sr = read_wav_any(wav_path)
        st = f0_stats.get(spk, {})
        return tg.stem, compute_utt_stats(
            wav, sr, tg, f0_floor=st.get("f0_floor", 70.0),
            f0_ceil=st.get("f0_ceil", 800.0), device=device)

    with ThreadPoolExecutor(max_workers=args.num_jobs) as ex:
        metadata = dict(ex.map(work, jobs_of(Path(args.in_dir), spk2meta)))
    yaml_lite.dump(args.out_filename, metadata)
    logger.info(f"wrote {len(metadata)} entries to {args.out_filename}")


if __name__ == "__main__":
    main()
