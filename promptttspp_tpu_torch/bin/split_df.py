"""Speaker-stratified train/valid split with the port.

Counterpart of ``egs/proposed/bin/split_df.py``, with the command line of
``bin/preprocess.py``: ``<path.df_dir>/train.csv`` -> ``trn.csv`` and
``val.csv`` under ``path.filtered_df_dir``
(``preprocess/pipeline.py::split_train_valid``). Host code; like every
entry point of the port it refuses ``device=cuda`` without a GPU.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.pipeline import split_train_valid


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``)."""
    cfg = conf.compose("preprocess", sys.argv[1:] if argv is None else argv)
    resolve_device(cfg["device"])
    conf.enter_run_dir(cfg)
    split_train_valid(cfg["path"]["df_dir"], cfg["path"]["filtered_df_dir"])


if __name__ == "__main__":
    main()
