"""A reader for the YAML subset the repository's config files use.

The disk repository reads ``config.yaml`` entries and the ``data/*.yaml``
files they point at, and the port needs no PyYAML on its serving host.
This reader takes:

- block mappings and block sequences (a sequence may sit at its key's
  indentation; an item may open a mapping on its own line, ``- key: v``);
- flow sequences ``[...]`` and flow mappings ``{...}``, nested, and
  spanning lines;
- ``#`` comments, plain scalars and single- or double-quoted scalars.

Plain scalars resolve as YAML 1.1's ``safe_load`` resolves them: ``null``
and ``~``, the booleans (``true``/``yes``/``on`` and their opposites),
ints (decimal, ``0x``, ``0b``, leading-zero octal, underscores), floats
(a dot is required; ``.inf``, ``.nan``); anything else is a string.
Everything else raises :class:`YAMLSubsetError` with the file and the
line: anchors and aliases, tags, block scalars (``|``, ``>``), tabs in
indentation, document markers and directives, complex keys, merge keys,
timestamps, and plain scalars that continue on a following line.
``tests/test_torch_yaml_subset.py`` holds it equal to ``yaml.safe_load``
on every YAML file under ``data/`` and ``examples/``.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YAMLSubsetError", "load", "loads"]


class YAMLSubsetError(ValueError):
    """The text uses YAML outside the subset, or is not valid YAML."""


# PyYAML's implicit resolvers (yaml/resolver.py), for plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_STOP = ",[]{}"
_UNSUPPORTED_START = {
    "&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
    ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
    "`": "a reserved indicator", "?": "a complex key",
}


def _int(text: str) -> int:
    value = text.replace("_", "")
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
        total = 0
        for part in value.split(":"):
            total = total * 60 + int(part)
        return sign * total
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        total = 0.0
        for part in value.split(":"):
            total = total * 60 + float(part)
        return sign * total
    return sign * float(value)


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no = no
        self.indent = indent
        self.text = text


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Reader:
    def __init__(self, text: str, source: str) -> None:
        self.source = source
        self.lines: list[_Line] = []
        for no, raw in enumerate(text.splitlines(), start=1):
            body = raw.lstrip(" ")
            if body.startswith("\t") and body.strip():
                self.fail(no, "a tab in the indentation")
            content = self._strip_comment(body).rstrip()
            if not content:
                continue
            if content in ("---", "...") or content.startswith(("--- ", "... ")):
                self.fail(no, "a document marker")
            if content.startswith("%"):
                self.fail(no, "a directive")
            self.lines.append(_Line(no, len(raw) - len(body), content))

    def fail(self, no: int, what: str):
        raise YAMLSubsetError(f"{self.source}:{no}: {what} is outside the YAML subset this "
                              "reader takes")

    def error(self, no: int, msg: str):
        raise YAMLSubsetError(f"{self.source}:{no}: {msg}")

    @staticmethod
    def _strip_comment(text: str) -> str:
        """``text`` without its comment; quotes open only at a token start."""
        quote = None
        i = 0
        while i < len(text):
            ch = text[i]
            if quote is not None:
                if ch == "\\" and quote == '"':
                    i += 2
                    continue
                if ch == quote:
                    if quote == "'" and text[i + 1:i + 2] == "'":
                        i += 2
                        continue
                    quote = None
            elif ch in "\"'" and (i == 0 or text[i - 1] in " [{,:-"):
                quote = ch
            elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
                return text[:i]
            i += 1
        return text

    # -- scalars --------------------------------------------------------------

    def plain(self, text: str, no: int):
        text = text.strip()
        if text[:1] in _UNSUPPORTED_START:
            self.fail(no, _UNSUPPORTED_START[text[0]])
        if text == "<<":
            self.fail(no, "a merge key")
        if text == "=":
            self.fail(no, "a value key")
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text in _TRUE
        if _INT.match(text):
            return _int(text)
        if _FLOAT.match(text):
            return _float(text)
        if _TIMESTAMP.match(text):
            self.fail(no, "a timestamp")
        return text

    def quoted(self, text: str, pos: int, no: int) -> tuple[str, int]:
        """The quoted scalar opening at ``text[pos]``; returns (value, end)."""
        q = text[pos]
        out = []
        i = pos + 1
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
                i += 1
                continue
            if ch == '"':
                return "".join(out), i + 1
            if ch == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                    continue
                width = _HEX_ESCAPES.get(esc)
                digits = text[i + 2:i + 2 + width] if width else ""
                if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    self.error(no, f"unknown escape \\{esc} in a double-quoted scalar")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            out.append(ch)
            i += 1
        self.fail(no, "a quoted scalar spanning lines")

    # -- flow collections -------------------------------------------------------

    def flow(self, text: str, pos: int, no: int):
        """The flow node at ``text[pos]``; returns (value, end)."""
        pos = self._ws(text, pos)
        if pos >= len(text):
            self.error(no, "a flow collection ends early")
        ch = text[pos]
        if ch == "[":
            items = []
            pos += 1
            while True:
                pos = self._ws(text, pos)
                if text[pos:pos + 1] == "]":
                    return items, pos + 1
                value, pos = self.flow(text, pos, no)
                pos = self._ws(text, pos)
                if text[pos:pos + 1] == ":":
                    self.fail(no, "a mapping inside a flow sequence")
                items.append(value)
                pos = self._sep(text, pos, "]", no)
                if text[pos - 1] == "]":
                    return items, pos
        if ch == "{":
            out = {}
            pos += 1
            while True:
                pos = self._ws(text, pos)
                if text[pos:pos + 1] == "}":
                    return out, pos + 1
                if text[pos:pos + 1] in ("[", "{"):
                    self.fail(no, "a collection as a mapping key")
                key, pos = self.flow(text, pos, no)
                pos = self._ws(text, pos)
                value = None
                if text[pos:pos + 1] == ":":
                    pos = self._ws(text, pos + 1)
                    if text[pos:pos + 1] not in (",", "}"):
                        value, pos = self.flow(text, pos, no)
                out[key] = value
                pos = self._sep(text, pos, "}", no)
                if text[pos - 1] == "}":
                    return out, pos
        if ch in "\"'":
            return self.quoted(text, pos, no)
        start = pos
        while pos < len(text):
            c = text[pos]
            if c in _FLOW_STOP:
                break
            if c == ":" and (pos + 1 == len(text) or text[pos + 1] in " \t" + _FLOW_STOP):
                break
            pos += 1
        return self.plain(text[start:pos], no), pos

    @staticmethod
    def _ws(text: str, pos: int) -> int:
        while pos < len(text) and text[pos] in " \t":
            pos += 1
        return pos

    def _sep(self, text: str, pos: int, close: str, no: int) -> int:
        pos = self._ws(text, pos)
        ch = text[pos:pos + 1]
        if ch == ",":
            return pos + 1
        if ch == close:
            return pos + 1
        self.error(no, f"expected ',' or {close!r} in a flow collection, got {ch or 'the end'!r}")

    # -- block structure --------------------------------------------------------

    def split_key(self, text: str, no: int) -> tuple[Any, str] | None:
        """(key, rest) when ``text`` is ``key: rest`` (or ``key:``)."""
        if text[:1] in "[{":
            return None
        if text[:1] in "\"'":
            key, end = self.quoted(text, 0, no)
            rest = text[end:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            return key, rest[1:].strip()
        if text[:1] == "?" and text[1:2] in ("", " "):
            self.fail(no, "a complex key")
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        return self.plain(text[:m.start()], no), text[m.end():].strip()

    def inline(self, text: str, i: int) -> tuple[Any, int]:
        """A value written on line ``i`` (text after ``key:`` or ``- ``);
        a flow collection may continue on the following lines."""
        no = self.lines[i].no
        if text[:1] in "[{":
            joined = text
            j = i
            while True:
                try:
                    value, end = self.flow(joined, 0, no)
                    break
                except YAMLSubsetError:
                    j += 1
                    if j >= len(self.lines) or not self._opens(joined):
                        raise
                    joined = joined + " " + self.lines[j].text
            if joined[end:].strip():
                self.error(no, f"text after a flow collection: {joined[end:].strip()!r}")
            return value, j + 1
        if text[:1] in "\"'":
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                self.error(no, f"text after a quoted scalar: {text[end:].strip()!r}")
            return value, i + 1
        if re.search(r":(?: |$)", text):
            self.error(no, "a mapping value on the line of another")
        return self.plain(text, no), i + 1

    @staticmethod
    def _opens(text: str) -> bool:
        """More brackets open than closed (quotes ignored: a rough test that
        decides only whether to read another line)."""
        return text.count("[") + text.count("{") > text.count("]") + text.count("}")

    def node(self, i: int, parent: int) -> tuple[Any, int]:
        line = self.lines[i]
        if _is_item(line.text):
            return self.sequence(i, line.indent)
        if self.split_key(line.text, line.no) is not None:
            return self.mapping(i, line.indent)
        value, j = self.inline(line.text, i)
        if j < len(self.lines) and self.lines[j].indent > parent:
            self.fail(self.lines[j].no, "a plain scalar spanning lines")
        return value, j

    def mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if _is_item(line.text):
                self.error(line.no, "a sequence item where a mapping key was expected")
            kv = self.split_key(line.text, line.no)
            if kv is None:
                self.error(line.no, f"expected 'key: value', got {line.text!r}")
            key, rest = kv
            if isinstance(key, (list, dict)):
                self.fail(line.no, "a collection as a mapping key")
            i += 1
            if rest:
                value, i = self.inline(rest, i - 1)
            elif i < len(self.lines) and (
                self.lines[i].indent > indent
                or (self.lines[i].indent == indent and _is_item(self.lines[i].text))
            ):
                value, i = self.node(i, indent)
            else:
                value = None
            if i < len(self.lines) and self.lines[i].indent > indent:
                self.fail(self.lines[i].no, "a plain scalar spanning lines")
            out[key] = value
        return out, i

    def sequence(self, i: int, indent: int) -> tuple[list, int]:
        items = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and _is_item(self.lines[i].text)):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            col = indent + len(line.text) - len(rest)
            if not rest:
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.node(i, indent)
                else:
                    value = None
            elif _is_item(rest) or self.split_key(rest, line.no) is not None:
                # "- key: v" / "- - v": the item's node starts at ``col``
                self.lines[i] = _Line(line.no, col, rest)
                value, i = self.node(i, indent)
            else:
                value, i = self.inline(rest, i)
                if i < len(self.lines) and self.lines[i].indent > indent:
                    self.fail(self.lines[i].no, "a plain scalar spanning lines")
            items.append(value)
        return items, i

    def document(self):
        if not self.lines:
            return None
        first = self.lines[0]
        value, i = self.node(0, -1)
        if i < len(self.lines):
            self.error(self.lines[i].no,
                       f"unexpected indentation (the document opened at column {first.indent})")
        return value


def loads(text: str, source: str = "<string>"):
    """Parse ``text`` (see the module docstring for the subset)."""
    return _Reader(text, source).document()


def load(path) -> Any:
    """Parse the YAML file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), str(path))
