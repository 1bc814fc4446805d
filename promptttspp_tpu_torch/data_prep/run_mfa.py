"""Run the Montreal Forced Aligner on each speaker's directory of
``prepare_mfa``: ``mfa align <in_dir>/<spk> english_us_arpa
english_us_arpa <mfa_out_dir>/<spk>``.

Counterpart of the root ``data_prep/run_mfa.py``. MFA is an external
program; where no ``mfa`` is on the PATH this raises before the first
speaker, naming it (the root script logs an error per speaker instead).
A speaker whose alignment fails is logged and skipped, as there. Run it
as ``python -m promptttspp_tpu_torch.data_prep.run_mfa in_dir
mfa_out_dir``; it logs to ``log/run_mfa.log`` under the working
directory.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

from promptttspp_tpu_torch.data_prep.common import (
    get_logger, load_libritts_spk_metadata)

MFA = "mfa"


def get_parser():
    p = argparse.ArgumentParser(description="Run MFA on LibriTTS-R")
    p.add_argument("in_dir", type=str,
                   help="per-speaker restructured data root")
    p.add_argument("mfa_out_dir", type=str, help="Output directory")
    p.add_argument("--n_jobs", type=int, default=1)
    p.add_argument("--speakers_tsv", type=str,
                   default="external/speakers.tsv")
    p.add_argument("--debug", action="store_true")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    binary = shutil.which(MFA)
    if binary is None:
        raise RuntimeError(
            f"the Montreal Forced Aligner's '{MFA}' is not on the PATH; "
            "install it, or put its TextGrids under mfa_out_dir/<spk>/ and "
            "go on with finalize_mfa")
    spk2meta = load_libritts_spk_metadata(args.speakers_tsv, debug=args.debug)
    in_dir, mfa_out = Path(args.in_dir), Path(args.mfa_out_dir)
    mfa_out.mkdir(exist_ok=True, parents=True)
    logger = get_logger(100, "log/run_mfa.log", "run_mfa")
    for spk in spk2meta:
        spk_in = in_dir / spk
        if not spk_in.exists():
            logger.warning(f"No input dir for {spk}; skipping")
            continue
        cmd = [binary, "align", str(spk_in), "english_us_arpa",
               "english_us_arpa", str(mfa_out / spk), "--num_jobs",
               str(args.n_jobs), "--clean", "--quiet", "--use_mp"]
        logger.info(" ".join(cmd))
        if subprocess.run(cmd, stdout=subprocess.PIPE).returncode != 0:
            logger.error(f"Error in MFA for {spk}")


if __name__ == "__main__":
    main()
