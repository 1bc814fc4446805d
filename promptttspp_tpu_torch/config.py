"""Config trees without PyYAML (the machine with the GPU has none):
command-line overrides and ``${..}`` interpolations.

Counterpart of the override and interpolation rules of
``promptttspp_tpu/config/compose.py``: ``a.b=v`` sets an existing key,
``+a.b=v`` adds one, ``~a.b`` deletes one; a value is read as YAML reads a
flow scalar or a flow list (null, booleans, integers, floats, ``[..]``
lists, quoted or bare strings). ``${a.b}`` is absolute, ``${.b}`` names a
key of the containing node and each further leading dot goes one node up;
interpolations resolve after the overrides.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence

_INT_RE = re.compile(r"^[-+]?[0-9]+$")
_FLOAT_RE = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")
_SPECIAL = {"null": None, "~": None, "true": True, "false": False,
            "yes": True, "no": False, "on": True, "off": False,
            ".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
            ".nan": math.nan}


def _split_top(text: str) -> List[str]:
    """'a, [b, c], "d,e"' -> ['a', '[b, c]', '"d,e"']."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    if quote or depth:
        raise ValueError(f"unbalanced override value {text!r}")
    parts.append(cur)
    return parts


def parse_value(text: str):
    """A command-line override value, read as YAML reads a flow scalar or
    a flow list."""
    s = text.strip()
    if s == "":
        return "" if text == "" else None
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [] if not inner else [parse_value(p) for p in
                                     _split_top(inner)]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.lower() in _SPECIAL:
        return _SPECIAL[s.lower()]
    if _INT_RE.match(s):
        return int(s)
    if _FLOAT_RE.match(s):
        return float(s)
    return s


def set_key(cfg: Dict, dotted: str, value, allow_new: bool):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new and p not in node:
                raise KeyError(f"override path '{dotted}' not in config (use "
                               f"+{dotted}=... to add)")
            node[p] = {}
        node = node[p]
    if not allow_new and parts[-1] not in node:
        raise KeyError(f"override key '{dotted}' not in config (use "
                       f"+{dotted}=... to add)")
    node[parts[-1]] = value


def delete_key(cfg: Dict, dotted: str):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node[p]
    node.pop(parts[-1], None)


_INTERP_RE = re.compile(r"\$\{([A-Za-z0-9_.]*?)\}")


def _lookup(root: Dict, path: Sequence[str], expr: str):
    """-> (value, path of the value) of ``${expr}`` written at ``path``: no
    leading dot is absolute, one dot the containing node, each further dot
    one node up."""
    n_dots = len(expr) - len(expr.lstrip("."))
    if n_dots == 0:
        base: List[str] = []
    else:
        if n_dots > len(path):
            raise KeyError(f"interpolation '${{{expr}}}' escapes config root")
        base = list(path[: len(path) - n_dots])
    node: Any = root
    for p in base:
        node = node[p]
    ref_path = list(base)
    for part in expr[n_dots:].split("."):
        if part == "":
            continue
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"interpolation '${{{expr}}}' -> missing key "
                           f"'{part}'")
        node = node[part]
        ref_path.append(part)
    return node, ref_path


def _resolve(root: Dict, node: Any, path: List[str], depth: int = 0):
    if depth > 32:
        raise RecursionError("interpolation cycle detected")
    if isinstance(node, dict):
        return {k: _resolve(root, v, path + [k], depth)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(root, v, path, depth) for v in node]
    if not isinstance(node, str):
        return node
    m = _INTERP_RE.fullmatch(node)
    if m:  # the whole string: keep the referent's type
        val, ref_path = _lookup(root, path, m.group(1))
        return _resolve(root, val, ref_path, depth + 1)

    def sub(match):
        val, ref_path = _lookup(root, path, match.group(1))
        return str(_resolve(root, val, ref_path, depth + 1))

    return _INTERP_RE.sub(sub, node)


def resolve(cfg: Dict) -> Dict:
    """A copy of ``cfg`` with every interpolation resolved."""
    return _resolve(cfg, cfg, [])


def apply_overrides(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Apply value overrides to ``cfg`` in place and return it."""
    for ov in overrides:
        if ov.startswith("~"):
            delete_key(cfg, ov[1:])
        elif "=" not in ov:
            raise ValueError(f"override {ov!r}: key=value, +key=value or "
                             "~key")
        elif ov.startswith("+"):
            key, _, val = ov[1:].partition("=")
            set_key(cfg, key, parse_value(val), allow_new=True)
        else:
            key, _, val = ov.partition("=")
            set_key(cfg, key, parse_value(val), allow_new=False)
    return cfg
