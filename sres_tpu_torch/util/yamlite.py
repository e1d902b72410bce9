"""A reader for the subset of YAML that the repo's ``config/`` tree uses,
giving the values ``yaml.safe_load`` gives (the card's machine has no
PyYAML, and the port imports none).

Covered: block maps and block lists (a list may sit at its key's indent,
and ``- key: value`` opens a map inside a list), flow maps and lists
(``{ x: 48, y: 48 }``, ``[ SST ]``, nested, spanning lines), comments,
single- and double-quoted scalars, and plain scalars resolved by PyYAML's
YAML 1.1 rules: ``~``/``null``/empty → None, ``yes``/``no``/``on``/``off``/
``true``/``false`` in their three spellings → bool, ints in decimal, octal
(leading 0), hex, binary and base 60, floats only with a dot (``3.0e-3``),
so ``1e-4`` stays the *string* ``'1e-4'``, as PyYAML reads it. Anchors,
tags, block scalars (``|``, ``>``), multi-line plain scalars and multiple
documents are not covered and raise.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


class YamlError(ValueError):
    pass


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * int(_sexagesimal(value))
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar → its value, by PyYAML's resolvers."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _TIMESTAMP.match(text):
        raise YamlError(f"timestamps are not covered: {text!r}")
    if text[0] in "&*!|>%@`":
        raise YamlError(f"not covered by this reader: {text!r}")
    return text


# ------------------------------------------------------------------ lines
def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after a blank,
    outside quotes), right-stripped."""
    quote: Optional[str] = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets left at the end of ``text`` (quotes skipped)."""
    depth, quote, i = 0, None, 0
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        i += 1
    return depth


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of each non-blank line, comments stripped, a flow
    collection's continuation lines joined onto its first."""
    out: List[Tuple[int, str]] = []
    pending: Optional[List[Any]] = None
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            if out or pending:
                raise YamlError("one document only")
            continue
        if pending is not None:
            pending[1] += " " + line.strip()
            if _depth(pending[1]) <= 0:
                out.append((pending[0], pending[1]))
                pending = None
            continue
        indent = len(line) - len(line.lstrip(" "))
        content = line.strip()
        if _depth(content) > 0:
            pending = [indent, content]
        else:
            out.append((indent, content))
    if pending is not None:
        raise YamlError("unclosed flow collection")
    return out


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """'key: value' → (key, value) at the first ': ' (or a final ':')
    outside quotes and brackets; None when the line is no map entry."""
    quote, depth, i = None, 0, 0
    if content[:1] in "'\"":
        quote = content[0]
        i = 1
    while i < len(content):
        ch = content[i]
        if quote == "'":
            if ch == "'":
                if content[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] == " "):
            return content[:i].rstrip(), content[i + 1:].strip()
        i += 1
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


# ---------------------------------------------------------------- scalars
def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] → (value, index after it)."""
    q = text[i]
    out: List[str] = []
    i += 1
    while i < len(text):
        ch = text[i]
        if q == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
        else:
            if ch == '"':
                return "".join(out), i + 1
            if ch == "\\":
                nxt = text[i + 1:i + 2]
                if nxt in _ESCAPES:
                    out.append(_ESCAPES[nxt])
                    i += 2
                    continue
                n = {"x": 2, "u": 4, "U": 8}.get(nxt)
                if n is None:
                    raise YamlError(f"unknown escape \\{nxt} in {text!r}")
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            out.append(ch)
        i += 1
    raise YamlError(f"unclosed quote in {text!r}")


def _scalar(text: str) -> Any:
    """A block-context scalar (the whole of ``text``)."""
    if text[:1] in "'\"":
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise YamlError(f"text after a quoted scalar: {text!r}")
        return value
    return resolve_plain(text)


# ------------------------------------------------------------------- flow
class _Flow:
    def __init__(self, text: str):
        self.text, self.i = text, 0

    def ws(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.text[self.i:self.i + 1]

    def expect(self, ch: str) -> None:
        if self.peek() != ch:
            raise YamlError(f"expected {ch!r} at {self.i} in {self.text!r}")
        self.i += 1

    def node(self) -> Any:
        ch = self.peek()
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        if ch in ("'", '"'):
            value, self.i = _quoted(self.text, self.i)
            return value
        return self.plain()

    def plain(self) -> Any:
        start = self.i
        t = self.text
        while self.i < len(t):
            ch = t[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and (self.i + 1 == len(t) or t[self.i + 1] in " ,[]{}"):
                break
            self.i += 1
        return resolve_plain(t[start:self.i].strip())

    def mapping(self) -> dict:
        self.expect("{")
        out: dict = {}
        while self.peek() != "}":
            key = self.node()
            if self.peek() == ":":
                self.i += 1
                value = self.node() if self.peek() not in (",", "}") else None
            else:
                value = None
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise YamlError(f"expected ',' or '}}' in {self.text!r}")
        self.i += 1
        return out

    def sequence(self) -> list:
        self.expect("[")
        out: list = []
        while self.peek() != "]":
            out.append(self.node())
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise YamlError(f"expected ',' or ']' in {self.text!r}")
        self.i += 1
        return out


def _inline(text: str) -> Any:
    """A value written on its key's (or item's) line."""
    if text[:1] in "[{":
        f = _Flow(text)
        value = f.node()
        if f.peek():
            raise YamlError(f"text after a flow collection: {text!r}")
        return value
    return _scalar(text)


# ------------------------------------------------------------------ block
class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def node(self, indent: int) -> Any:
        if _is_item(self.lines[self.i][1]):
            return self.sequence(indent)
        return self.mapping(indent)

    def _nested(self, indent: int, allow_same_indent_list: bool) -> Any:
        """The block under a key or item whose own value is empty."""
        if self.i < len(self.lines):
            nind, ncontent = self.lines[self.i]
            if nind > indent or (allow_same_indent_list and nind == indent
                                 and _is_item(ncontent)):
                return self.node(nind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and _is_item(content)):
                break
            if ind > indent:
                raise YamlError(f"bad indentation: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise YamlError(f"not a map entry: {content!r}")
            key = _scalar(kv[0]) if kv[0] else None
            self.i += 1
            out[key] = _inline(kv[1]) if kv[1] else self._nested(indent, True)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise YamlError(f"bad indentation: {content!r}")
                break
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self._nested(indent, False))
            elif _is_item(rest):
                raise YamlError(f"nested inline sequences are not covered: {content!r}")
            elif rest[:1] not in "[{" and _split_key(rest) is not None:
                # '- key: value' opens a map whose keys sit at rest's column
                col = ind + len(content) - len(rest)
                self.lines[self.i] = (col, rest)
                out.append(self.mapping(col))
            else:
                self.i += 1
                out.append(_inline(rest))
        return out


def load(text: str) -> Any:
    """The value of one YAML document, as ``yaml.safe_load(text)`` gives it."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and not _is_item(lines[0][1]):
        return _inline(lines[0][1])
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YamlError(f"unparsed text from: {lines[block.i][1]!r}")
    return value


def load_file(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read())
