"""Minimal Praat TextGrid parser (long text format, IntervalTiers).

Counterpart of ``promptttspp_tpu/preprocess/textgrid.py`` (the reference's
vendored parser, ``promptttspp/utils/textgrid.py``): the entries of the
named tier (default "phones") as (start, stop, name, tier) tuples, sorted
by start time.
"""

from __future__ import annotations

import re
from collections import namedtuple
from typing import List

Entry = namedtuple("Entry", ["start", "stop", "name", "tier"])

_NUM_RE = re.compile(r"(xmin|xmax)\s*=\s*([0-9.eE+-]+)")
_TEXT_RE = re.compile(r'text\s*=\s*"(.*)"')
_NAME_RE = re.compile(r'name\s*=\s*"(.*)"')
_ITEM_RE = re.compile(r"item\s*\[\s*\d+\s*\]\s*:")


def read_textgrid(path: str, tier: str = "phones") -> List[Entry]:
    with open(path, encoding="utf-8") as f:
        content = f.read()

    entries: List[Entry] = []
    # split into tier items
    chunks = _ITEM_RE.split(content)
    for chunk in chunks[1:]:
        m = _NAME_RE.search(chunk)
        if not m:
            continue
        tier_name = m.group(1)
        if tier_name != tier:
            continue
        # walk intervals: sequences of xmin/xmax/text
        xmin = None
        xmax = None
        for line in chunk.splitlines():
            line = line.strip()
            nm = _NUM_RE.search(line)
            if nm:
                if nm.group(1) == "xmin":
                    xmin = float(nm.group(2))
                else:
                    xmax = float(nm.group(2))
                continue
            tm = _TEXT_RE.search(line)
            if tm and xmin is not None and xmax is not None:
                entries.append(Entry(xmin, xmax, tm.group(1), tier_name))
                xmin = xmax = None
    entries.sort(key=lambda e: e.start)
    return entries
