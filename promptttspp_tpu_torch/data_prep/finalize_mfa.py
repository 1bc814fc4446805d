"""Merge the aligned corpus: each utterance that MFA aligned gets its
wav rewritten as int16 under ``<out_dir>/<spk>/wav24k/`` and its TextGrid
copied under ``<out_dir>/<spk>/textgrid/``; the utterances MFA missed are
listed in ``<out_dir>/missing_utt_ids.txt``.

Counterpart of the root ``data_prep/finalize_mfa.py``. Run it as
``python -m promptttspp_tpu_torch.data_prep.finalize_mfa in_dir mfa_dir
out_dir``; it logs to ``log/finalize_mfa.log`` under the working
directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from shutil import copy2

import numpy as np

from promptttspp_tpu_torch.data_prep.common import (
    get_logger, load_libritts_spk_metadata, read_wav_any)

SAMPLE_RATE = 24000


def get_parser():
    p = argparse.ArgumentParser(description="Finalize MFA and LibriTTS-R data")
    p.add_argument("in_dir", type=str)
    p.add_argument("mfa_dir", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("--speakers_tsv", type=str,
                   default="external/speakers.tsv")
    p.add_argument("--debug", action="store_true")
    return p


def read_and_save(in_file, out_file):
    """The wav at 24 kHz in [-1, 1], written as int16 (x * 32767,
    truncated)."""
    from scipy.io import wavfile

    x, sr = read_wav_any(in_file)
    if sr != SAMPLE_RATE:
        raise ValueError(f"{in_file}: {sr} Hz, not {SAMPLE_RATE}")
    if np.abs(x).max() > 1.0:
        raise ValueError(f"{in_file}: samples beyond [-1, 1]")
    wavfile.write(out_file, sr, (x * 32767).astype(np.int16))


def main(argv=None):
    args = get_parser().parse_args(argv)
    spk2meta = load_libritts_spk_metadata(args.speakers_tsv, debug=args.debug)
    in_dir, mfa_dir, out_dir = map(Path, (args.in_dir, args.mfa_dir,
                                          args.out_dir))
    out_dir.mkdir(exist_ok=True, parents=True)
    logger = get_logger(100, "log/finalize_mfa.log", "finalize_mfa")
    missing = []
    for spk in spk2meta:
        spk_in, spk_mfa = in_dir / spk, mfa_dir / spk
        if not spk_in.exists():
            logger.warning(f"No input dir for {spk}")
            continue
        out_tgr = out_dir / spk / "textgrid"
        out_wav = out_dir / spk / "wav24k"
        out_tgr.mkdir(exist_ok=True, parents=True)
        out_wav.mkdir(exist_ok=True, parents=True)
        org_ids = {f.stem for f in spk_in.glob("*.wav")}
        utt_ids = sorted(f.stem for f in spk_mfa.glob("*.TextGrid"))
        if len(org_ids) != len(utt_ids):
            miss = sorted(org_ids - set(utt_ids))
            logger.warning(f"Missing {len(miss)} utt_ids for {spk}")
            missing.extend(miss)
        for utt_id in utt_ids:
            read_and_save(spk_in / f"{utt_id}.wav", out_wav / f"{utt_id}.wav")
            copy2(spk_mfa / f"{utt_id}.TextGrid",
                  out_tgr / f"{utt_id}.TextGrid")
    logger.info(f"Number of missing utterance IDs: {len(missing)}")
    with open(out_dir / "missing_utt_ids.txt", "w") as f:
        f.writelines(f"{u}\n" for u in missing)


if __name__ == "__main__":
    main()
