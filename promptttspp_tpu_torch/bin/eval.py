"""Objective evaluation of a ``bin/synthesize.py`` output tree with the
port.

Counterpart of ``egs/proposed/bin/eval.py``, on the ``synthesize`` config
of ``bin/conf.py``::

    python3 -m promptttspp_tpu_torch.bin.eval path.root=<root> \\
        output_dir=<synthesize's output_dir> [num_eval_utts=50] \\
        [+modes=[ref,prompt]] [device=cpu]

For each utterance of ``<path.filtered_df_dir>/eval_filtered.csv`` and
each mode, the synthesized ``<output_dir>/<spk>/<mode>/wav/<utt>.wav``
against the corpus wav (``eval/metrics.py::evaluate_pair``: MCD, mel L1,
F0 RMSE in cents, VUV error, duration ratio; the mels and YIN on the
card). Writes ``<output_dir>/eval_metrics.json`` (each mode's means and
per-utterance rows) and prints each mode's means as one JSON line. It runs
on ``cuda``; ``device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.bin.synthesize import read_wav
from promptttspp_tpu_torch.data.dataset import read_csv_rows
from promptttspp_tpu_torch.eval.metrics import evaluate_pair, summarize
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from promptttspp_tpu_torch.platform import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the CLI with ``argv`` (default ``sys.argv[1:]``); returns the
    report written to ``eval_metrics.json``."""
    cfg = conf.compose("synthesize", sys.argv[1:] if argv is None else argv)
    resolve_device(cfg["device"])
    conf.enter_run_dir(cfg)
    rows = read_csv_rows(Path(cfg["path"]["filtered_df_dir"])
                         / "eval_filtered.csv")
    rows = rows[: cfg.get("num_eval_utts", 50)]
    out_dir = Path(cfg["output_dir"])
    sr = cfg["transforms"].get("sample_rate", 24000)
    to_mel = MelSpectrogramTransform(sample_rate=sr)

    report = {}
    for mode in cfg.get("modes", ["ref", "prompt"]):
        per_utt = []
        for row in rows:
            spk, utt = row["spk_id"], row["item_name"]
            syn_path = out_dir / spk / mode / "wav" / f"{utt}.wav"
            gt_path = (Path(cfg["path"]["data_root"]) / spk / "wav24k"
                       / f"{utt}.wav")
            if not syn_path.exists() or not gt_path.exists():
                print(f"skip {spk}/{utt} ({mode}): missing wav",
                      file=sys.stderr)
                continue
            m = evaluate_pair(read_wav(gt_path)[1], read_wav(syn_path)[1],
                              sample_rate=sr, to_mel=to_mel,
                              device=cfg["device"])
            m["spk_id"], m["item_name"] = int(spk), str(utt)
            per_utt.append(m)
        if not per_utt:
            continue
        mean = summarize([{k: v for k, v in r.items()
                           if isinstance(v, float)} for r in per_utt])
        report[mode] = {"mean": mean, "n_utts": len(per_utt),
                        "utts": per_utt}
        print(json.dumps({"mode": mode, "n_utts": len(per_utt), **mean}))

    (out_dir / "eval_metrics.json").write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
