"""A reader for the YAML subset of the shipped configs, with no PyYAML.

The 13 `config/*/*.yaml` use block mappings, flow lists of scalars, plain
and quoted scalars and comments; `${...}` stays a string for
utils/config.py's resolver. This module reads that subset, block lists
besides, and resolves plain scalars by PyYAML's YAML 1.1 rules
(yaml/resolver.py and SafeConstructor), so `load` equals `yaml.safe_load`
on it, traps included:
- a float needs a dot, and its exponent a sign: `2e-4` and `1.0e1` stay
  strings, `1.0e+1`, `0.0000016` and `1.` are floats;
- `yes`, `no`, `on`, `off`, `true`, `True` (and their capitalisations) are
  booleans; `~`, `null` and the empty scalar are None;
- `1_000`, `0x10`, `0b101`, `017` (octal) and `1:30` (base 60) are ints;
  `.inf`, `-.inf` and `.nan` are floats.
Anything outside the subset (anchors, tags, flow mappings, block scalars,
multi-line plain scalars, timestamps, several documents) raises
`ValueError`: the reader never guesses.
"""

from __future__ import annotations

import re
from typing import Any

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _signed(text: str) -> tuple[int, str]:
    sign = -1 if text[0] == "-" else 1
    return sign, text[1:] if text[0] in "+-" else text


def _resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe loader constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign, v = _signed(text.replace("_", ""))
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        sign, v = _signed(text.replace("_", "").lower())
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text) or text == "=":
        raise ValueError(f"YAML scalar {text!r}: timestamps and value keys are outside the config subset")
    if text[0] in "&*!|>%@`{},]" or text.startswith(("- ", "? ")) or text in ("-", "?"):
        raise ValueError(f"YAML {text!r}: anchors, aliases, tags, block scalars, flow mappings and "
                         "directives are outside the config subset")
    return text


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar that starts at text[i]; returns it and the index
    after its closing quote."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if c == "\\" and q == '"':
            e = text[j + 1 : j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = text[j + 2 : j + 2 + n]
                if len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                    raise ValueError(f"YAML: bad escape \\{e}{code} in {text!r}")
                out.append(chr(int(code, 16)))
                j += 2 + n
                continue
            raise ValueError(f"YAML: unknown escape \\{e} in {text!r}")
        out.append(c)
        j += 1
    raise ValueError(f"YAML: unterminated quoted scalar in {text!r}")


def _flow_list(text: str, i: int) -> tuple[list, int]:
    """The flow list `[a, 'b', [1, 2]]` that starts at text[i]; returns it
    and the index after its `]`."""
    out: list = []
    j = i + 1
    expect_item = True
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise ValueError(f"YAML: unterminated flow list in {text!r}")
        c = text[j]
        if c == "]":
            if expect_item and out:
                raise ValueError(f"YAML: empty item in flow list {text!r}")
            return out, j + 1
        if not expect_item:
            if c != ",":
                raise ValueError(f"YAML: expected ',' or ']' at {text[j:]!r}")
            expect_item = True
            j += 1
            continue
        if c == "[":
            item, j = _flow_list(text, j)
        elif c in "'\"":
            item, j = _quoted(text, j)
        elif c in ",{":
            raise ValueError(f"YAML: empty item or flow mapping in flow list {text!r}")
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                k += 1
            plain = text[j:k].strip()
            if ": " in plain or plain.endswith(":"):
                raise ValueError(f"YAML: a mapping inside a flow list is outside the config subset: {text!r}")
            item, j = _resolve_plain(plain), k
        out.append(item)
        expect_item = False


def parse_scalar(text: str) -> Any:
    """One inline value: a flow list, a quoted or a plain scalar (comments
    and surrounding spaces dropped), as `yaml.safe_load(text)` reads it."""
    text = _strip_comment(text).strip()
    if not text:
        return None
    if text[0] in "'\"[":
        value, end = (_flow_list if text[0] == "[" else _quoted)(text, 0)
        if text[end:].strip():
            raise ValueError(f"YAML: unexpected {text[end:]!r} after {text[:end]!r}")
        return value
    if ": " in text or text.endswith(":"):
        raise ValueError(f"YAML: {text!r} is not a single scalar")
    return _resolve_plain(text)


def _strip_comment(line: str) -> str:
    """The line without its comment: `#` at the start or after a space,
    outside quotes."""
    quote = None
    escaped = False
    for j, c in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif c == "\\" and quote == '"':
                escaped = True
            elif c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or line[j - 1] in " [,:"):
            quote = c
        elif c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j].rstrip()
    return line.rstrip()


def _split_key(content: str) -> tuple[Any, str] | None:
    """(key, rest) of a `key: value` line, or None if it is no mapping entry."""
    if content[0] in "'\"":
        key, j = _quoted(content, 0)
        rest = content[j:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    return _resolve_plain(content[: m.start()].rstrip()), content[m.end():].strip()


def load(text: str) -> Any:
    """The document in `text`, as `yaml.safe_load` reads the config subset."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent] == "\t":
            raise ValueError(f"YAML line {n}: tab indentation")
        if indent == 0 and body.startswith(("---", "...", "%")):
            raise ValueError(f"YAML line {n}: document markers and directives are outside the config subset")
        lines.append((n, indent, body[indent:]))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        n, _, content = lines[i]
        raise ValueError(f"YAML line {n}: unexpected {content!r}")
    return value


def _block(lines, i: int, indent: int) -> tuple[Any, int]:
    if lines[i][2] == "-" or lines[i][2].startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _inline_or_nested(lines, i: int, indent: int, rest: str, n: int, allow_same_indent_seq: bool):
    """The value after `key:` or `- `: inline, or the block on the next
    lines (deeper, or for a mapping key a sequence at the same indent)."""
    nxt = lines[i] if i < len(lines) else None
    if rest:
        if nxt is not None and nxt[1] > indent:
            raise ValueError(f"YAML line {nxt[0]}: a multi-line value is outside the config subset")
        return parse_scalar(rest), i
    if nxt is not None and nxt[1] > indent:
        return _block(lines, i, nxt[1])
    if allow_same_indent_seq and nxt is not None and nxt[1] == indent and (
            nxt[2] == "-" or nxt[2].startswith("- ")):
        return _sequence(lines, i, indent)
    return None, i


def _mapping(lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, content = lines[i]
        kv = _split_key(content)
        if kv is None:
            raise ValueError(f"YAML line {n}: expected 'key: value', got {content!r}")
        key, rest = kv
        if key in out:
            raise ValueError(f"YAML line {n}: duplicate key {key!r}")
        out[key], i = _inline_or_nested(lines, i + 1, indent, rest, n, True)
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"YAML line {lines[i][0]}: bad indentation")
    return out, i


def _sequence(lines, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i][1] == indent and (lines[i][2] == "-" or lines[i][2].startswith("- ")):
        n, _, content = lines[i]
        rest = content[1:].strip()
        if rest and _split_key(rest) is not None and rest[0] not in "'\"[":
            raise ValueError(f"YAML line {n}: a mapping inside a block list is outside the config subset")
        item, i = _inline_or_nested(lines, i + 1, indent, rest, n, False)
        out.append(item)
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"YAML line {lines[i][0]}: bad indentation")
    return out, i
