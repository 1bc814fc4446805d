"""Feature preprocessing with the port: durations from the TextGrids,
batched F0 and mel on the card, the mel statistics and the CSVs.

Counterpart of ``egs/proposed/bin/preprocess.py``, with its command line
(the ``preprocess`` config of ``bin/conf.py``: ``conf/preprocess.yaml``
and its groups)::

    python3 -m promptttspp_tpu_torch.bin.preprocess path.root=<root> \\
        [eval_ids=[...]] [batch_size=16] [f0_method=yin|world] \\
        [debug=false] [device=cpu]

It reads ``path.data_csv_file``, the wavs and TextGrids under
``path.data_root`` and the per-speaker F0 bounds of
``path.f0_stats_file`` where it exists, and writes ``path.feats_dir``,
``path.mel_dir`` (with ``stats.yaml``) and ``path.df_dir`` (``data.csv``,
``train.csv``, ``eval.csv``). The recipe then runs ``bin/split_df.py``,
``bin/compute_mel.py`` (a no-op after this), ``bin/split_df.py`` again and
``bin/filter_eval.py`` with the same arguments. It runs on ``cuda``;
``device=cpu`` runs it on the CPU. As in JAX, the working directory
becomes ``hydra.run.dir`` first (``./out/hydra/preprocess``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.platform import resolve_device
from promptttspp_tpu_torch.preprocess.pipeline import preprocess_corpus


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``)."""
    cfg = conf.compose("preprocess", sys.argv[1:] if argv is None else argv)
    resolve_device(cfg["device"])
    conf.enter_run_dir(cfg)
    path = cfg["path"]
    f0_stats = None
    if path.get("f0_stats_file") and Path(path["f0_stats_file"]).exists():
        f0_stats = yaml_lite.load(path["f0_stats_file"])
    preprocess_corpus(
        data_csv=path["data_csv_file"], data_root=path["data_root"],
        feats_dir=path["feats_dir"], mel_dir=path["mel_dir"],
        df_dir=path["df_dir"], f0_stats=f0_stats,
        eval_ids=cfg.get("eval_ids", []), sample_rate=cfg["sample_rate"],
        n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
        batch_size=cfg.get("batch_size", 16), debug=cfg.get("debug", False),
        f0_method=cfg.get("f0_method", "yin"), device=cfg["device"])


if __name__ == "__main__":
    main()
