"""The two YAML shapes that the recipe reads and writes, without PyYAML
(the machine with the GPU has none).

- A flat mapping of numbers, as ``yaml.safe_dump`` writes the mel
  statistics (``mel63/stats.yaml``: ``max``, ``mean``, ``min``, ``std``,
  ``var``).
- A mapping of such flat mappings under bare or quoted keys, as
  ``metadata/libritts_r_f0_stats.yaml`` holds the per-speaker F0 bounds
  and ``data_prep/compute_utt_stats.py`` writes the per-utterance
  statistics (``dumps``: keys sorted, a key that YAML would read as
  something other than that string single-quoted, as ``yaml.dump``
  writes them).

Numbers are read as ``yaml.safe_load`` reads them (YAML 1.1: a float has a
dot, an exponent has a sign, ``.inf`` and ``.nan``), and written as
``yaml.safe_dump`` writes them. Anything else raises.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Dict, Mapping, Union

Number = Union[int, float]

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9][0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
            ".nan": math.nan}
_KEY = re.compile(r"^(?:'([^']*)'|\"([^\"]*)\"|([A-Za-z0-9_]+)):(?:\s+(.*))?$")


def parse_number(text: str, where: str = "") -> Number:
    """A YAML 1.1 int or float scalar; anything else raises."""
    s = text.strip()
    if s.lower() in _SPECIAL:
        return _SPECIAL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    raise ValueError(f"{where}not a number: {text!r}")


def loads(text: str, where: str = "") -> Dict[str, object]:
    """A flat mapping of numbers, or a mapping of flat mappings of
    numbers -> dict. Comments and blank lines are skipped."""
    out: Dict[str, object] = {}
    section = None  # the nested mapping being filled, with its indent
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.split(" #", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        at = f"{where}line {n}: "
        indent = len(line) - len(line.lstrip(" "))
        m = _KEY.match(line.strip())
        if m is None:
            raise ValueError(f"{at}not a 'key: number' line: {raw!r}")
        key = next(g for g in m.groups()[:3] if g is not None)
        value = m.group(4)
        if indent == 0:
            if key in out:
                raise ValueError(f"{at}duplicate key {key!r}")
            if value:
                out[key], section = parse_number(value, at), None
            else:
                out[key], section = {}, [key, None]
        elif section is None:
            raise ValueError(f"{at}indented line outside a mapping: {raw!r}")
        else:
            if section[1] is None:
                section[1] = indent
            if indent != section[1] or not value:
                raise ValueError(f"{at}only one level of nesting: {raw!r}")
            out[section[0]][key] = parse_number(value, at)
    return out


def load(path) -> Dict[str, object]:
    return loads(Path(path).read_text(), f"{path}: ")


def format_number(value: Number) -> str:
    """A number as ``yaml.safe_dump`` writes it."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"not a number: {value!r}")
    if isinstance(value, int):
        return str(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def dumps_flat(mapping: Mapping[str, Number]) -> str:
    """A flat mapping of numbers as ``yaml.safe_dump`` writes it (keys
    sorted)."""
    for key in mapping:
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", key):
            raise ValueError(f"key {key!r} would need quoting")
    return "".join(f"{k}: {format_number(mapping[k])}\n"
                   for k in sorted(mapping))


def dump_flat(path, mapping: Mapping[str, Number]):
    Path(path).write_text(dumps_flat(mapping))


# a bare key that YAML 1.1 reads as a number, a bool or null
_NOT_A_STRING = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*|0x[0-9a-fA-F_]+|0b[01_]+|"
    r"y|Y|yes|Yes|YES|n|N|no|No|NO|true|True|TRUE|false|False|FALSE|"
    r"on|On|ON|off|Off|OFF|null|Null|NULL)$")


def format_key(key: str) -> str:
    """``key`` bare where YAML reads it back as that string, else
    single-quoted."""
    if not isinstance(key, str) or not key or "'" in key or "\n" in key:
        raise ValueError(f"key {key!r} is not written")
    if re.fullmatch(r"[A-Za-z0-9_]+", key) and not _NOT_A_STRING.match(key):
        return key
    return f"'{key}'"


def dumps(mapping: Mapping[str, object]) -> str:
    """A mapping of numbers and of flat mappings of numbers (one level
    of nesting) as ``yaml.dump`` writes it: keys sorted, two spaces of
    indent."""
    lines = []
    for key in sorted(mapping):
        value = mapping[key]
        if isinstance(value, Mapping):
            if not value:
                raise ValueError(f"{key!r}: an empty mapping is not written")
            lines.append(f"{format_key(key)}:")
            lines.extend(f"  {format_key(k)}: {format_number(value[k])}"
                         for k in sorted(value))
        else:
            lines.append(f"{format_key(key)}: {format_number(value)}")
    return "".join(line + "\n" for line in lines)


def dump(path, mapping: Mapping[str, object]):
    Path(path).write_text(dumps(mapping))
