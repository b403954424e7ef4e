"""A reader for the YAML that project hyperparameter files use, in plain
Python (the port does not depend on PyYAML).

`safe_load(text)` returns what PyYAML's `yaml.safe_load` returns for the
subset written by `mp init_project` and the Auditor and by hand in the
same style:

  * block mappings and block sequences (``- item``, nested by indent);
  * flow lists ``[...]`` and flow mappings ``{...}``, which may span
    lines; anchors ``&X`` and aliases ``*X`` (an alias is the same
    object);
  * comments, single- and double-quoted scalars, plain scalars;
  * the YAML 1.1 scalar types of PyYAML's resolver: null (``~``,
    ``null``/``Null``/``NULL``, empty), bool (``true``/``True``/``yes``/
    ``on``/... and their negatives), int (decimal, ``0x``, ``0b``,
    leading-``0`` octal, ``_`` separators, sexagesimal) and float
    (``5.0e-05``, ``.5``, ``.inf``, ``.nan``); anything else, such as
    ``1pct`` or ``1e-5``, stays a string.

Block scalars (``|``, ``>``), merge keys (``<<``), tags, timestamps and
multi-line plain scalars raise `YAMLSubsetError`.
"""

from __future__ import annotations

import re

_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP_RE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}


class YAMLSubsetError(ValueError):
    """The text uses YAML this reader does not implement, or is not
    valid YAML."""


def _sexagesimal(value, cast):
    sign = -1 if value.startswith("-") else 1
    digits = [cast(part) for part in value.lstrip("+-").split(":")]
    out, base = 0, 1
    for d in reversed(digits):
        out += d * base
        base *= 60
    return sign * out


def resolve_plain(text):
    """The value of a plain (unquoted) scalar under PyYAML's YAML 1.1
    resolver."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text == "<<" or text.startswith("!") or _TIMESTAMP_RE.match(text):
        raise YAMLSubsetError(f"unsupported YAML scalar {text!r}")
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


def _unquoted(text):
    """(index, char) of the characters of `text` outside quoted scalars
    (a quote opens a scalar only at a token start, so "it's" is plain)."""
    quote = None
    j = 0
    while j < len(text):
        c = text[j]
        if quote == "'":
            if c == "'":
                if text[j + 1:j + 2] == "'":
                    j += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                j += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (j == 0 or text[j - 1] in " \t[{,:-"):
            quote = c
        else:
            yield j, c
        j += 1


def _strip_comment(line):
    """The line without its comment (a '#' after whitespace, outside
    quotes)."""
    for j, c in _unquoted(line):
        if c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j]
    return line


def _flow_depth(text):
    """Open brackets minus closed ones, outside quotes."""
    return sum((c in "[{") - (c in "]}") for _, c in _unquoted(text))


class _Inline:
    """Parser of one inline value: a flow collection, a quoted or plain
    scalar, an alias, optionally behind an anchor."""

    def __init__(self, text, anchors, lineno):
        self.s = text
        self.p = 0
        self.anchors = anchors
        self.lineno = lineno

    def error(self, msg):
        return YAMLSubsetError(f"line {self.lineno}: {msg} in {self.s!r}")

    def ws(self):
        while self.p < len(self.s) and self.s[self.p] in " \t":
            self.p += 1

    def peek(self):
        self.ws()
        return self.s[self.p] if self.p < len(self.s) else ""

    def whole(self, in_flow=False):
        value = self.value(in_flow)
        if self.peek():
            raise self.error("trailing characters")
        return value

    def value(self, in_flow):
        c = self.peek()
        if c == "&":
            name = self.name()
            value = self.value(in_flow)
            self.anchors[name] = value
            return value
        if c == "*":
            name = self.name()
            if name not in self.anchors:
                raise self.error(f"unknown alias *{name}")
            return self.anchors[name]
        if c == "[":
            return self.flow_list()
        if c == "{":
            return self.flow_map()
        if c in "'\"":
            return self.quoted()
        if c in "|>!%@`":
            raise self.error(f"unsupported YAML indicator {c!r}")
        return resolve_plain(self.plain(in_flow))

    def name(self):
        self.p += 1
        start = self.p
        while self.p < len(self.s) and self.s[self.p] not in " \t,[]{}":
            self.p += 1
        return self.s[start:self.p]

    def plain(self, in_flow, key=False):
        start = self.p
        while self.p < len(self.s):
            c = self.s[self.p]
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (key or in_flow) and (
                    self.p + 1 == len(self.s)
                    or self.s[self.p + 1] in " \t,[]{}"):
                break
            self.p += 1
        return self.s[start:self.p].strip()

    def quoted(self):
        q = self.s[self.p]
        self.p += 1
        out = []
        while True:
            if self.p >= len(self.s):
                raise self.error("unterminated quoted scalar")
            c = self.s[self.p]
            if q == "'" and c == "'":
                if self.s[self.p + 1:self.p + 2] == "'":
                    out.append("'")
                    self.p += 2
                    continue
                self.p += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.p += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.p + 1:self.p + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.p += 2
                elif e in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    out.append(chr(int(self.s[self.p + 2:self.p + 2 + n],
                                       16)))
                    self.p += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.p += 1

    def flow_list(self):
        self.p += 1
        out = []
        while True:
            c = self.peek()
            if c == "]":
                self.p += 1
                return out
            out.append(self.value(in_flow=True))
            c = self.peek()
            if c == ",":
                self.p += 1
            elif c != "]":
                raise self.error("expected ',' or ']'")

    def flow_map(self):
        self.p += 1
        out = {}
        while True:
            c = self.peek()
            if c == "}":
                self.p += 1
                return out
            key = (self.quoted() if c in "'\""
                   else resolve_plain(self.plain(True, key=True)))
            if self.peek() == ":":
                self.p += 1
                value = (None if self.peek() in (",", "}")
                         else self.value(in_flow=True))
            else:
                value = None
            out[key] = value
            c = self.peek()
            if c == ",":
                self.p += 1
            elif c != "}":
                raise self.error("expected ',' or '}'")


class _Block:
    """Indentation-driven parser of block collections over the file's
    comment-stripped, non-blank lines."""

    def __init__(self, text):
        self.lines = []  # [indent, content, line number]
        for no, raw in enumerate(text.splitlines(), 1):
            if raw.startswith("%") or (raw.strip() == "---"
                                       and not self.lines):
                continue
            content = _strip_comment(raw).rstrip()
            if not content.strip():
                continue
            stripped = content.lstrip(" ")
            if stripped.startswith("\t"):
                raise YAMLSubsetError(f"line {no}: tab indentation")
            self.lines.append([len(content) - len(stripped), stripped, no])
        self.i = 0
        self.anchors = {}

    @staticmethod
    def is_item(text):
        return text == "-" or text.startswith("- ")

    def split_key(self, text, no):
        """(key, rest) of a 'key: rest' line, or None."""
        if text[:1] in "[{*&!|>" or self.is_item(text):
            return None
        inline = _Inline(text, self.anchors, no)
        if text[:1] in "'\"":
            key = inline.quoted()
        else:
            raw = inline.plain(False, key=True)
            if inline.p >= len(text):
                return None
            key = resolve_plain(raw)
        if inline.peek() != ":":
            return None
        return key, text[inline.p + 1:]

    def parse(self):
        if not self.lines:
            return None
        value = self.block(self.lines[0][0])
        if self.i < len(self.lines):
            raise YAMLSubsetError(f"line {self.lines[self.i][2]}: "
                                  f"unexpected indentation")
        return value

    def block(self, indent):
        _, text, no = self.lines[self.i]
        if self.is_item(text):
            return self.sequence(indent)
        if self.split_key(text, no) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(text, indent, no)

    def mapping(self, indent):
        out = {}
        while self.i < len(self.lines):
            ind, text, no = self.lines[self.i]
            if ind < indent:
                break
            kv = self.split_key(text, no) if ind == indent else None
            if kv is None:
                if ind == indent and self.is_item(text):
                    break
                raise YAMLSubsetError(f"line {no}: expected 'key: value' "
                                      f"at indent {indent}: {text!r}")
            self.i += 1
            out[kv[0]] = self.inline(kv[1].strip(), indent, no)
        return out

    def sequence(self, indent):
        out = []
        while self.i < len(self.lines):
            ind, text, no = self.lines[self.i]
            if ind < indent or not (ind == indent and self.is_item(text)):
                if ind > indent:
                    raise YAMLSubsetError(f"line {no}: unexpected "
                                          f"indentation")
                break
            rest = text[1:]
            content = rest.lstrip(" ")
            if not content:
                self.i += 1
                out.append(self.inline("", indent, no))
                continue
            col = indent + 1 + len(rest) - len(content)
            if self.is_item(content) or self.split_key(content, no):
                self.lines[self.i] = [col, content, no]
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self.inline(content, indent, no))
        return out

    def inline(self, rest, indent, no):
        """The value after 'key:' or '- ': inline, or the nested block on
        the lines below (deeper, or a sequence at the same indent)."""
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest[1:].partition(" ")
            rest = rest.strip()
        if rest:
            if _flow_depth(rest) > 0:
                while _flow_depth(rest) > 0 and self.i < len(self.lines):
                    rest += " " + self.lines[self.i][1]
                    self.i += 1
            value = _Inline(rest, self.anchors, no).whole(
                in_flow=rest[0] in "[{")
        elif self.i < len(self.lines) and (
                self.lines[self.i][0] > indent
                or (self.lines[self.i][0] == indent
                    and self.is_item(self.lines[self.i][1]))):
            value = self.block(self.lines[self.i][0])
        else:
            value = None
        if anchor:
            self.anchors[anchor] = value
        return value


def safe_load(text):
    """The Python value of a YAML document (see the module docstring for
    the subset)."""
    return _Block(text).parse()
