"""Restructure LibriTTS-R per speaker for the Montreal Forced Aligner:
``<out_dir>/<spk>/<utt>.wav`` beside ``<utt>.lab``, the copy of its
``.normalized.txt``.

Counterpart of the root ``data_prep/prepare_mfa.py``. Run it as
``python -m promptttspp_tpu_torch.data_prep.prepare_mfa in_dir out_dir``;
it logs to ``log/prepare_mfa.log`` under the working directory.
"""

from __future__ import annotations

import argparse
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from promptttspp_tpu_torch.data_prep.common import (
    get_logger, load_libritts_spk_metadata)


def get_parser():
    p = argparse.ArgumentParser(
        description="Restructure the LibriTTS-R dataset for convenience")
    p.add_argument("in_dir", type=str, help="LibriTTS original data root")
    p.add_argument("out_dir", type=str, help="Output directory")
    p.add_argument("--n_jobs", type=int, default=8)
    p.add_argument("--speakers_tsv", type=str,
                   default="external/speakers.tsv")
    p.add_argument("--debug", action="store_true")
    return p


def process_spk(spk: str, meta, in_dir: Path, out_dir: Path, logger):
    """Copy each of the speaker's wavs that has a transcript, and the
    transcript as ``.lab``."""
    wav_files = sorted((in_dir / meta["subset"]).glob(f"*/*/{spk}_*.wav"))
    if not wav_files:
        logger.warning(f"No wav files found for {spk} {meta}")
        return
    spk_out = out_dir / spk
    spk_out.mkdir(exist_ok=True, parents=True)
    for wav_file in wav_files:
        text_file = wav_file.parent / f"{wav_file.stem}.normalized.txt"
        if not text_file.exists():
            logger.warning(f"Text file not found for {wav_file}")
            continue
        shutil.copy2(wav_file, spk_out / wav_file.name)
        shutil.copy2(text_file, spk_out / f"{wav_file.stem}.lab")


def main(argv=None):
    args = get_parser().parse_args(argv)
    in_dir, out_dir = Path(args.in_dir), Path(args.out_dir)
    out_dir.mkdir(exist_ok=True, parents=True)
    logger = get_logger(100, "log/prepare_mfa.log", "prepare_mfa")
    spk2meta = load_libritts_spk_metadata(args.speakers_tsv, debug=args.debug)
    with ThreadPoolExecutor(max_workers=args.n_jobs) as ex:
        list(ex.map(lambda item: process_spk(item[0], item[1], in_dir,
                                             out_dir, logger),
                    spk2meta.items()))


if __name__ == "__main__":
    main()
