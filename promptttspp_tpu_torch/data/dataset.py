"""Readers of the corpus files that serving needs, without pandas or
PyYAML (the machine with the GPU has neither).

Counterparts of ``promptttspp_tpu/data/dataset.py::read_prompt_candidate``
and ``read_spk_prompt_candidate`` (pipe-separated files) and of the
``stats.yaml`` that ``promptttspp_tpu/preprocess/pipeline.py`` writes with
``yaml.safe_dump``: a flat mapping of ``key: float`` lines.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List


def _pipe_rows(filepath):
    with open(filepath, newline="") as f:
        return [row for row in csv.reader(f, delimiter="|") if row]


def read_prompt_candidate(filepath) -> Dict[str, List[str]]:
    """style_key -> list of lowercase paraphrases."""
    return {row[0]: [s.lower().strip() for s in row[1].split(";")]
            for row in _pipe_rows(filepath)}


def read_spk_prompt_candidate(filepath) -> Dict[int, List[str]]:
    """spk_id -> descriptor word list."""
    return {int(row[0]): row[1].split(",") for row in _pipe_rows(filepath)}


# YAML's spellings of the special floats
_YAML_FLOATS = {".inf": float("inf"), "+.inf": float("inf"),
                "-.inf": float("-inf"), ".nan": float("nan")}


def read_mel_stats(filepath) -> Dict[str, float]:
    """``stats.yaml`` (``key: float`` per line) -> {key: float}."""
    stats = {}
    for line in Path(filepath).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"{filepath}: not a 'key: value' line: {line!r}")
        value = value.strip().lower()
        stats[key.strip()] = (_YAML_FLOATS[value] if value in _YAML_FLOATS
                              else float(value))
    return stats


def read_csv_rows(filepath) -> List[Dict[str, str]]:
    """A comma-separated file with a header -> one dict per row."""
    with open(filepath, newline="") as f:
        return list(csv.DictReader(f))
