"""Keep the eval utterances of 3-10 s, with the port.

Counterpart of ``egs/proposed/bin/filter_eval.py``, with the command line
of ``bin/preprocess.py`` (``min_sec``, ``max_sec``):
``<path.df_dir>/eval.csv`` -> ``<path.filtered_df_dir>/eval_filtered.csv``,
which ``bin/synthesize.py`` and ``bin/eval.py`` read. Host code; like
every entry point of the port it refuses ``device=cuda`` without a GPU.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.pipeline import filter_eval


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``)."""
    cfg = conf.compose("preprocess", sys.argv[1:] if argv is None else argv)
    resolve_device(cfg["device"])
    conf.enter_run_dir(cfg)
    filter_eval(cfg["path"]["df_dir"], cfg["path"]["filtered_df_dir"],
                hop_length=cfg["hop_length"], sample_rate=cfg["sample_rate"],
                min_sec=cfg.get("min_sec", 3.0),
                max_sec=cfg.get("max_sec", 10.0))


if __name__ == "__main__":
    main()
