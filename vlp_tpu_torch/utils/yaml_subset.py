"""A reader of the YAML that the sweep files use, without PyYAML.

The subset: block mappings and block sequences by indentation (a
sequence item may be a mapping, ``- key: value`` with its other keys
below the first), flow sequences ``[a, b]`` and flow mappings ``{a: b}``,
plain, single- and double-quoted scalars (a plain one on a key's line
runs to the line's end), comments and blank lines. Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): ``true``/``yes``/``on``
and their negations are booleans, ``~`` and ``null`` are None, integers
may carry ``_``, a ``0x``/``0b`` or leading-zero octal base or base-60
``:`` parts, and a float needs a dot (``1e-5`` stays a string; an
exponent needs its sign).
Anything else (anchors, tags, multi-line scalars, documents) raises.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                  r"|0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


class YamlError(ValueError):
    pass


def _plain(text: str) -> Any:
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        sign = -1 if text[0] == "-" else 1
        digits = text.lstrip("+-").replace("_", "")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _SEXAGESIMAL.match(text):
        sign = -1 if text[0] == "-" else 1
        value = 0
        for part in text.lstrip("+-").replace("_", "").split(":"):
            value = 60 * value + int(part)
        return sign * value
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return float(f"{m[1]}inf")
    if _NAN.match(text):
        return float("nan")
    if text[0] in _UNSUPPORTED:
        raise YamlError(f"unsupported YAML: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, end)."""
    q, out, i = text[i], [], i + 1
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
               "0": "\0", "r": "\r"}
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            nxt = text[i + 1:i + 2]
            if nxt not in escapes:
                raise YamlError(f"unsupported escape \\{nxt} in {text!r}")
            out.append(escapes[nxt])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YamlError(f"unterminated quote in {text!r}")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at its start or after
    whitespace, outside quotes)."""
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            _, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow node starting at text[i] (after spaces); (value, end)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i >= len(text):
        raise YamlError(f"missing value in {text!r}")
    c = text[i]
    if c in "[{":
        close, items, pairs = "]" if c == "[" else "}", [], {}
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == close:
                return (items if c == "[" else pairs), i + 1
            if c == "[":
                value, i = _flow(text, i)
                items.append(value)
            else:
                key, i = _flow(text, i)
                while i < len(text) and text[i] == " ":
                    i += 1
                if i >= len(text) or text[i] != ":":
                    raise YamlError(f"expected ':' in {text!r}")
                value, i = _flow(text, i + 1)
                pairs[key] = value
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i >= len(text) or text[i] != close:
                raise YamlError(f"unterminated flow collection: {text!r}")
    if c in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and (j + 1 == len(text) or text[j + 1] == " ")):
        j += 1
    return _plain(text[i:j].strip()), j


def _scalar_line(text: str) -> Any:
    """A value written on its key's (or dash's) line: a flow collection, a
    quoted scalar, or a plain scalar to the line's end (commas and
    brackets included, as in YAML's block context)."""
    if text[0] not in "[{'\"":
        if re.search(r": |:$", text):
            raise YamlError(f"a mapping where a value was expected: "
                            f"{text!r}")
        return _plain(text.strip())
    value, end = _flow(text, 0)
    if text[end:].strip():
        raise YamlError(f"unexpected text after the value: {text!r}")
    return value


def _key(text: str) -> Tuple[Any, str]:
    """'key: rest' -> (key, rest); raises where the line has no key."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0)
    else:
        m = re.match(r"([^#\[\]{},]+?):(?: |$)", text)
        if m is None:
            raise YamlError(f"expected 'key: value', got {text!r}")
        key, end = _plain(m[1].strip()), m.end(1)
    rest = text[end:]
    if not rest.startswith(":"):
        raise YamlError(f"expected ':' after the key in {text!r}")
    return key, rest[1:].strip()


def _block(lines: List[Tuple[int, str]], i: int, indent: int
           ) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i], indented ``indent``."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out: List = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            text = lines[i][1]
            rest = text[1:].strip()
            if rest and re.match(r"[^\[{'\"].*?: |[^\[{'\"].*:$", rest):
                # "- key: value": a mapping whose keys sit in the column
                # of its first key
                column = indent + len(text) - len(text[1:].lstrip())
                lines[i] = (column, rest)
                value, i = _block(lines, i, column)
                out.append(value)
                continue
            i += 1
            if rest:
                out.append(_scalar_line(rest))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if text.startswith("- "):
            break
        key, rest = _key(text)
        i += 1
        if rest:
            out[key] = _scalar_line(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def safe_load(text: str) -> Any:
    """``yaml.safe_load`` of a document in the subset."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError(f"a tab in the indentation: {raw!r}")
        line = _strip_comment(raw)
        if line.strip() in ("---", "..."):
            raise YamlError("document markers are not in the subset")
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    first = lines[0][1]
    if len(lines) == 1 and not (first.startswith("- ") or first == "-"):
        try:
            _key(first)
        except YamlError:  # one scalar
            return _scalar_line(first)
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise YamlError(f"unexpected indentation at {lines[end][1]!r}")
    return value
