"""A reader for the subset of YAML that ``configs/*.yaml`` use.

The JAX package reads its config files with PyYAML (``config.py:222-230``),
which the GPU machine does not have.  This reader takes what those files
hold and resolves scalars as PyYAML's ``safe_load`` does (YAML 1.1):

  * ``key: value`` mappings, nested by indentation (``hpo_foam.yaml``'s
    ``base:`` and ``space:`` blocks);
  * inline ``[a, b]`` lists of scalars;
  * ``#`` comments, blank lines;
  * null (``~``, ``null``, empty), booleans (``true``/``false``/``yes``/
    ``no``/``on``/``off`` in three cases), decimal, octal, hex and binary
    integers, and floats by YAML 1.1's pattern, under which ``1.0e4`` (no
    sign after the ``e``) stays a string, as in PyYAML; ``Config.from_dict``
    coerces it afterwards, as the JAX package's does.

Anything else (block lists, multi-line or quoted scalars with ``#`` or
``:``, anchors, flow mappings) raises ``ValueError`` rather than being read
differently from PyYAML.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
# PyYAML's float resolver without its sexagesimal form
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)"
)
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


def scalar(text: str) -> Any:
    """One plain scalar, resolved as PyYAML's SafeLoader resolves it."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.fullmatch(s):
        sign = -1 if s[0] == "-" else 1
        digits = s.lstrip("+-").replace("_", "")
        if digits.startswith(("0b", "0x")):
            return sign * int(digits, 0)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.fullmatch(s):
        low = s.replace("_", "").lower()
        if low.endswith(".nan"):
            return float("nan")
        if low.endswith(".inf"):
            return float("-inf") if low[0] == "-" else float("inf")
        return float(low)
    if s[:1] in "[]{}&*!|>'\"%@`-?,":
        raise ValueError(f"YAML scalar {text!r} is outside the supported subset")
    return s


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]") or "[" in s[1:-1] or "]" in s[1:-1]:
            raise ValueError(f"YAML list {text!r} is outside the supported subset")
        body = s[1:-1].strip()
        return [scalar(item) for item in body.split(",")] if body else []
    return scalar(s)


def _strip_comment(line: str) -> str:
    if line.lstrip().startswith("#"):
        return ""
    cut = re.search(r"\s#", line)
    return (line[: cut.start()] if cut else line).rstrip()


def loads(text: str) -> Dict[str, Any]:
    """The mapping a config file holds."""
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]  # (indent, mapping)
    opened = None  # (indent, mapping, key) of a bare "key:" that may open a block
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("YAML forbids tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent, body = len(line) - len(line.lstrip(" ")), line.strip()
        m = _KEY.fullmatch(body)
        if m is None:
            raise ValueError(f"YAML line {body!r} is outside the supported subset")
        if opened is not None and indent > opened[0]:
            opened[1][opened[2]] = {}
            stack.append((indent, opened[1][opened[2]]))
        opened = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"YAML line {body!r}: inconsistent indentation")
        mapping = stack[-1][1]
        key, rest = m.group(1), m.group(2)
        if key in mapping:
            raise ValueError(f"YAML key {key!r} given twice")
        mapping[key] = None if rest is None else _value(rest)
        if rest is None:
            opened = (indent, mapping, key)
    return root


def load(path: str) -> Dict[str, Any]:
    """``loads`` of the file at ``path``."""
    with open(path) as f:
        return loads(f.read())
