"""A block-style YAML writer in plain Python (the port does not depend on
PyYAML), for the files the port writes whole, such as `mp branch`'s.

`safe_dump(data)` writes dicts, lists, strings, ints, floats, bools and
None so that PyYAML's `yaml.safe_load` and the port's
`yaml_reader.safe_load` both read back the same value:

  * mappings and sequences in block style, two spaces per level (empty
    ones as ``{}`` and ``[]``);
  * None as ``Null``, bools as ``true``/``false``;
  * floats with a dot and, where there is an exponent, a signed one
    (``5.0e-05``: YAML 1.1 reads Python's ``5e-05`` as a string), and
    ``.inf``, ``-.inf``, ``.nan``;
  * a string plain only when it is made of letters, digits and ``_ . / +
    -`` (single spaces between words), starts with a letter, ``_`` or
    ``/``, and resolves to itself (not ``Null``, ``yes``, ``on``, ...);
    any other string in double quotes, with escapes for ``\\``, ``"``,
    and every character outside printable ASCII.
"""

from __future__ import annotations

import math
import re

from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import (
    YAMLSubsetError,
    resolve_plain,
)

_PLAIN_RE = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./+-]*(?: [A-Za-z0-9_./+-]+)*$")
_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t",
            "\r": "\\r", "\0": "\\0"}


def _string(text):
    try:
        plain = bool(_PLAIN_RE.match(text)) and resolve_plain(text) == text
    except YAMLSubsetError:
        plain = False
    if plain:
        return text
    out = []
    for c in text:
        if c in _ESCAPES:
            out.append(_ESCAPES[c])
        elif " " <= c <= "~":
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02x}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04x}")
        else:
            out.append(f"\\U{ord(c):08x}")
    return '"' + "".join(out) + '"'


def _float(value):
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value)
    mantissa, e, exponent = text.partition("e")
    if "." not in mantissa:
        mantissa += ".0"
    if e and exponent[0] not in "+-":
        exponent = "+" + exponent
    return mantissa + (f"e{exponent}" if e else "")


def _scalar(value):
    if value is None:
        return "Null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float(value)
    if isinstance(value, str):
        return _string(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML")


def _lines(value, indent):
    """The block lines of a non-empty dict or list at `indent`."""
    pad = " " * indent
    out = []
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, (dict, list)) and item:
                out.append(head)
                out += _lines(item, indent + 2)
            else:
                out.append(f"{head} {_inline(item)}")
        return out
    for item in value:
        if isinstance(item, (dict, list)) and item:
            # The item's first line moves up onto the dash
            nested = _lines(item, indent + 2)
            out.append(f"{pad}- {nested[0][indent + 2:]}")
            out += nested[1:]
        else:
            out.append(f"{pad}- {_inline(item)}")
    return out


def _inline(value):
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def safe_dump(data):
    """The YAML text of `data` (see the module docstring)."""
    if isinstance(data, (dict, list)) and data:
        return "\n".join(_lines(data, 0)) + "\n"
    return _inline(data) + "\n"
