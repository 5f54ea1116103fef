"""
A reader for the subset of YAML that project configs use, in the
standard library only: the card's machine has no PyYAML.

:func:`safe_load` gives ``yaml.safe_load``'s answer on:

- block mappings and block sequences, sequences of mappings
  (``- name: a``), and a sequence at its parent key's indentation;
- flow sequences (``[256, 128, 64]``) and flow mappings, so a JSON
  document reads too;
- ``|`` / ``>`` block scalars with their chomping (``-``, ``+``) and
  indentation indicators, which hold YAML in ``examples/config.yaml``;
- plain, single- and double-quoted scalars, over several lines too, and
  comments;
- a ``? key`` line and its ``: value`` line, as PyYAML writes an empty or
  a long key;
- YAML 1.1 scalar resolution, PyYAML's resolver: ``1e-3`` stays a
  string (``1.0e-3`` is a float), ``yes``/``no``/``on``/``off`` are
  booleans, ``017`` is the int 15 (``0o17`` a string), a date is a
  ``datetime.date``, a time stamp a ``datetime.datetime`` (aware when it
  carries an offset).

Anchors, aliases, tags, directives and a second document raise :class:`YAMLError` (a ``ValueError``) naming the line.
:func:`safe_load_all` reads a stream of documents split on ``---`` (and
ended by ``...``), as ``yaml.safe_load_all`` does: an explicit document
with nothing in it is ``None``.

>>> safe_load("a: [1, 2.0, yes]\\nb:\\n- x: 1e-3\\n")
{'a': [1, 2.0, True], 'b': [{'x': '1e-3'}]}
"""

import datetime
import re
from typing import Any, Callable, List, Optional, Tuple

_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_TRUE = frozenset(("yes", "true", "on"))
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)"
)
_INT = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(
    r"(?P<year>[0-9]{4})-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])"
    r"(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)(?::(?P<tz_minute>[0-9][0-9]))?))?)?"
)
_DATE_ONLY = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}")
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": " ", "P": " ",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",]}"
_EXPLICIT = object()  # the key of a ``? key`` line, read apart


class YAMLError(ValueError):
    """A document outside the subset, or not YAML; names the line."""


def _sexagesimal(text: str, cast: Callable) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _timestamp(text: str) -> Any:
    if _DATE_ONLY.fullmatch(text):
        return datetime.date(int(text[:4]), int(text[5:7]), int(text[8:10]))
    match = _TIMESTAMP.fullmatch(text)
    values = match.groupdict()
    fraction = 0
    if values["fraction"]:
        fraction = int(values["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if values["tz_sign"]:
        delta = datetime.timedelta(hours=int(values["tz_hour"]), minutes=int(values["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if values["tz_sign"] == "-" else delta)
    elif values["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(
        int(values["year"]), int(values["month"]), int(values["day"]),
        int(values["hour"]), int(values["minute"]), int(values["second"]), fraction, tzinfo=tzinfo,
    )


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolution.

    >>> [resolve_plain(s) for s in ("017", "0o17", "1e-3", "1.0e-3", "off", "~")]
    [15, '0o17', '1e-3', 0.001, False, None]
    """
    if _BOOL.fullmatch(text):
        return text.lower() in _TRUE
    if _FLOAT.fullmatch(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value.startswith("-") else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _INT.fullmatch(text):
        value = text.replace("_", "")
        sign = -1 if value.startswith("-") else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value.startswith("0"):
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if text == "<<":
        raise YAMLError("merge keys (<<) are not supported")
    if _NULL.fullmatch(text):
        return None
    if text[:1].isdigit():
        match = _TIMESTAMP.fullmatch(text)
        if match and (match.group("hour") is not None or _DATE_ONLY.fullmatch(text)):
            return _timestamp(text)
    if text == "=":
        raise YAMLError("the value key (=) is not supported")
    return text


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _blank(text: str) -> bool:
    """Nothing but spaces and maybe a comment."""
    stripped = text.lstrip(" \t")
    return not stripped or stripped.startswith("#")


def _seq_entry(content: str) -> bool:
    return content == "-" or content.startswith("- ") or content.startswith("-\t")


class _Reader:
    def __init__(self, text: str):
        if text.startswith("﻿"):
            text = text[1:]
        lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.final_newline = lines[-1] == ""
        if self.final_newline:
            lines.pop()
        self.lines = lines
        self.i = 0
        self._documents()

    # ----------------------------------------------------------------- errors

    def error(self, message: str, line: Optional[int] = None) -> YAMLError:
        number = (self.i if line is None else line) + 1
        return YAMLError(f"line {number}: {message}")

    def _documents(self) -> None:
        """Drop one leading ``---``; refuse directives and a second document."""
        seen_content = False
        for number, line in enumerate(self.lines):
            if _blank(line):
                continue
            if line.startswith("%"):
                raise self.error("directives are not supported", number)
            marker = line in ("---", "...") or line.startswith(("--- ", "... "))
            if marker and not seen_content and line.startswith("---"):
                self.lines[number] = " " * 3 + line[3:]
                seen_content = not _blank(line[3:])
                continue
            if marker:
                raise self.error("only one document is supported", number)
            seen_content = True

    # ------------------------------------------------------------------ block

    def skip_blank(self) -> None:
        while self.i < len(self.lines) and _blank(self.lines[self.i]):
            self.i += 1

    def document(self) -> Any:
        self.skip_blank()
        if self.i >= len(self.lines):
            return None
        node = self.block(0)
        self.skip_blank()
        if self.i < len(self.lines):
            raise self.error("unexpected content after the document's root node")
        return node

    def block(self, min_indent: int, col: Optional[int] = None) -> Any:
        """The node whose first line is ``self.i``, starting at ``col``
        (its indentation unless given)."""
        line = self.lines[self.i]
        col = _indent(line) if col is None else col
        if col < min_indent:
            return None
        content = line[col:]
        if _seq_entry(content):
            return self.sequence(col)
        if self.key(content) is not None:
            return self.mapping(col)
        return self.value(content, min_indent - 1)

    def sequence(self, indent: int) -> List[Any]:
        items = []
        first = True
        while True:
            self.skip_blank()
            if self.i >= len(self.lines):
                break
            line = self.lines[self.i]
            col = indent if first else _indent(line)
            if col != indent or not _seq_entry(line[col:]):
                if col > indent:
                    raise self.error("bad indentation of a sequence entry")
                break
            first = False
            rest = line[col + 1:]
            if _blank(rest):
                self.i += 1
                self.skip_blank()
                nested = self.i < len(self.lines) and _indent(self.lines[self.i]) > indent
                items.append(self.block(indent + 1) if nested else None)
            else:
                start = col + 1 + _indent(rest)
                items.append(self.block(indent + 1, start))
        return items

    def key(self, content: str) -> Optional[Tuple[Any, str]]:
        """``(key, rest of the line)`` when ``content`` opens a mapping entry."""
        if content[:1] in ("'", '"'):
            try:
                key, end = _Flow([content], 0).quoted_in_line()
            except YAMLError:
                return None
            rest = content[end:].lstrip(" ")
            if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
                return key, rest[1:]
            return None
        if content.startswith("? ") or content == "?":
            return _EXPLICIT, content[1:]
        if not content or content[0] in "[]{},#&*!|>%@`":
            return None
        for match in re.finditer(r":(?=[ \t]|$)| #", content):
            if match.group() == " #":
                return None
            return resolve_plain(content[: match.start()].rstrip(" \t")), content[match.end():]
        return None

    def mapping(self, indent: int) -> dict:
        result = {}
        first = True
        while True:
            self.skip_blank()
            if self.i >= len(self.lines):
                break
            line = self.lines[self.i]
            col = indent if first else _indent(line)
            if col < indent:
                break
            if col > indent:
                raise self.error("bad indentation of a mapping entry")
            content = line[col:]
            if _seq_entry(content):
                if first:
                    raise self.error("a sequence entry where a mapping key was expected")
                break
            entry = self.key(content)
            if entry is None:
                raise self.error("expected a 'key: value' entry")
            first = False
            key, rest = entry
            if key is _EXPLICIT:
                key, value = self.explicit_entry(rest, indent)
            elif _blank(rest):
                self.i += 1
                self.skip_blank()
                value = None
                if self.i < len(self.lines):
                    nxt = self.lines[self.i]
                    if _indent(nxt) > indent:
                        value = self.block(indent + 1)
                    elif _indent(nxt) == indent and _seq_entry(nxt[indent:]):
                        value = self.sequence(indent)
            else:
                value = self.value(rest, indent)
            if isinstance(key, (list, dict)):
                raise self.error("a collection cannot be a mapping key")
            result[key] = value
        return result

    def explicit_entry(self, rest: str, indent: int) -> Tuple[Any, Any]:
        """A ``? key`` line (a scalar or flow key) and its ``: value``
        line, as PyYAML writes an empty or a long key."""
        if _blank(rest):
            raise self.error("an explicit key (?) must hold its key on its own line")
        key = self.value(rest, indent)
        self.skip_blank()
        if self.i >= len(self.lines):
            return key, None
        line = self.lines[self.i]
        if _indent(line) != indent or not (line[indent:] == ":" or line[indent:].startswith(": ")):
            return key, None
        after = line[indent + 1:]
        if not _blank(after):
            return key, self.block(indent + 1, indent + 1 + _indent(after))
        self.i += 1
        self.skip_blank()
        if self.i < len(self.lines) and _indent(self.lines[self.i]) > indent:
            return key, self.block(indent + 1)
        return key, None

    def value(self, text: str, parent_indent: int) -> Any:
        """The scalar or flow node that opens with ``text``, the rest of
        line ``self.i``; continuation lines must be indented deeper than
        ``parent_indent``."""
        head = text.lstrip(" \t")
        start = len(self.lines[self.i]) - len(head)
        first = head[:1]
        if first in ("&", "*", "!"):
            kind = {"&": "anchors", "*": "aliases", "!": "tags"}[first]
            raise self.error(f"{kind} are not supported")
        if first in ("|", ">"):
            return self.block_scalar(head, parent_indent)
        if first in ("%", "@", "`"):
            raise self.error(f"a plain scalar cannot start with {first!r}")
        if first in ("[", "{", "'", '"'):
            flow = _Flow(self.lines, self.i, start, error=self.error)
            node = flow.node()
            self.i = flow.line
            rest = self.lines[self.i][flow.pos:]
            if not _blank(rest):
                raise self.error(f"unexpected {rest.strip()!r} after a flow node")
            self.i += 1
            return node
        return self.plain(head, parent_indent)

    def plain(self, head: str, parent_indent: int) -> Any:
        """A block-context plain scalar, folded over its continuation lines."""
        first = self._plain_line(head)
        parts, breaks = [first], 0
        self.i += 1
        while self.i < len(self.lines):
            line = self.lines[self.i]
            stripped = line.strip(" \t")
            if not stripped:
                breaks += 1
                self.i += 1
                continue
            if _indent(line) <= parent_indent or stripped.startswith("#"):
                break
            if parent_indent < 0 and (_seq_entry(stripped) or self.key(stripped) is not None):
                break
            parts.append("\n" * breaks if breaks else " ")
            parts.append(self._plain_line(stripped))
            breaks = 0
            self.i += 1
        text = "".join(parts)
        return resolve_plain(text) if len(parts) == 1 else text

    def _plain_line(self, text: str) -> str:
        comment = re.search(r"[ \t]#", text)
        if comment:
            text = text[: comment.start()]
        text = text.rstrip(" \t")
        if re.search(r":[ \t]", text) or text.endswith(":"):
            raise self.error("mapping values are not allowed in a plain scalar here")
        return text

    def block_scalar(self, head: str, parent_indent: int) -> str:
        folded = head[0] == ">"
        chomp, explicit = None, None
        rest = head[1:]
        for _ in range(2):
            if rest[:1] in ("+", "-") and chomp is None:
                chomp, rest = rest[0] == "+", rest[1:]
            elif rest[:1].isdigit() and rest[:1] != "0" and explicit is None:
                explicit, rest = int(rest[0]), rest[1:]
        if rest and (rest[0] not in " \t" or not _blank(rest)):
            raise self.error(f"bad block scalar header {head!r}")
        self.i += 1
        lines = self.lines
        if explicit is not None:
            indent = max(parent_indent, 0) + explicit
        else:
            indent = parent_indent + 1
            j = self.i
            while j < len(lines) and not lines[j].strip(" "):
                j += 1
            if j < len(lines):
                indent = max(indent, _indent(lines[j]))
        indent = max(indent, 1)

        def is_break(j):
            return not lines[j].strip(" ") and len(lines[j]) <= indent

        def is_content(j):
            return j < len(lines) and not is_break(j) and _indent(lines[j]) >= indent

        chunks, breaks, line_break = [], [], ""
        while self.i < len(lines) and is_break(self.i):
            breaks.append("\n")
            self.i += 1
        while is_content(self.i):
            chunks.extend(breaks)
            text = lines[self.i][indent:]
            leading_non_space = text[:1] not in (" ", "\t")
            chunks.append(text)
            line_break = "\n" if self.i < len(lines) - 1 or self.final_newline else ""
            self.i += 1
            breaks = []
            while self.i < len(lines) and is_break(self.i):
                breaks.append("\n")
                self.i += 1
            if not is_content(self.i):
                break
            following = lines[self.i][indent:]
            if folded and line_break == "\n" and leading_non_space and following[:1] not in (" ", "\t"):
                if not breaks:
                    chunks.append(" ")
            else:
                chunks.append(line_break)
        if chomp is not False:
            chunks.append(line_break)
        if chomp is True:
            chunks.extend(breaks)
        return "".join(chunks)


class _Flow:
    """A scanner over ``lines`` from ``(line, pos)`` for flow collections
    and quoted scalars, which may run over several lines."""

    def __init__(self, lines: List[str], line: int, pos: int = 0, error=None):
        self.lines, self.line, self.pos = lines, line, pos
        self._error = error

    def error(self, message: str) -> YAMLError:
        if self._error is not None:
            return self._error(message, self.line)
        return YAMLError(f"line {self.line + 1}: {message}")

    @property
    def text(self) -> str:
        return self.lines[self.line]

    def peek(self) -> str:
        return self.text[self.pos: self.pos + 1]

    def next_line(self) -> bool:
        if self.line + 1 >= len(self.lines):
            return False
        self.line, self.pos = self.line + 1, 0
        return True

    def skip_space(self) -> None:
        """Spaces, comments and line breaks between flow tokens."""
        while True:
            text = self.text
            while self.pos < len(text) and text[self.pos] in " \t":
                self.pos += 1
            if self.pos < len(text) and text[self.pos] == "#":
                self.pos = len(text)
            if self.pos < len(text):
                return
            if not self.next_line():
                return

    # -------------------------------------------------------------- scalars

    def quoted_in_line(self) -> Tuple[str, int]:
        """A quoted scalar closed on the first line, and the end offset."""
        one = _Flow([self.lines[0]], 0, 0)
        value = one.quoted()
        return value, one.pos

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        chunks = []
        while True:
            text = self.text
            while self.pos < len(text):
                ch = text[self.pos]
                if quote == "'" and ch == "'":
                    if text[self.pos + 1: self.pos + 2] == "'":
                        chunks.append("'")
                        self.pos += 2
                        continue
                    self.pos += 1
                    return "".join(chunks)
                if quote == '"' and ch == '"':
                    self.pos += 1
                    return "".join(chunks)
                if quote == '"' and ch == "\\":
                    escape = text[self.pos + 1: self.pos + 2]
                    if escape == "":  # an escaped line break joins the lines
                        if not self.next_line():
                            raise self.error("unterminated double-quoted scalar")
                        self.pos = _indent(self.text)
                        text = self.text
                        while self.pos < len(text) and text[self.pos] == "\t":
                            self.pos += 1
                        continue
                    if escape in _ESCAPES:
                        chunks.append(_ESCAPES[escape])
                        self.pos += 2
                        continue
                    if escape in _HEX_ESCAPES:
                        width = _HEX_ESCAPES[escape]
                        digits = text[self.pos + 2: self.pos + 2 + width]
                        if len(digits) != width or not all(c in "0123456789abcdefABCDEF" for c in digits):
                            raise self.error(f"bad escape \\{escape}{digits}")
                        chunks.append(chr(int(digits, 16)))
                        self.pos += 2 + width
                        continue
                    raise self.error(f"unknown escape \\{escape}")
                chunks.append(ch)
                self.pos += 1
            # a line break inside the quotes: trailing spaces go, the break folds
            while chunks and chunks[-1] in (" ", "\t"):
                chunks.pop()
            breaks = 0
            while True:
                if not self.next_line():
                    raise self.error(f"unterminated {quote}-quoted scalar")
                if self.text.strip(" \t"):
                    break
                breaks += 1
            chunks.append("\n" * breaks if breaks else " ")
            stripped = self.text.lstrip(" \t")
            self.pos = len(self.text) - len(stripped)

    def plain(self) -> Any:
        """A flow-context plain scalar (ends at ``,[]{}``, ``: `` or a comment)."""
        parts = []
        breaks = 0
        while True:
            text = self.text
            start = self.pos
            while self.pos < len(text):
                ch = text[self.pos]
                if ch in ",[]{}":
                    break
                if ch == ":" and (self.pos + 1 == len(text) or text[self.pos + 1] in " \t,[]{}"):
                    break
                if ch == "#" and self.pos > start and text[self.pos - 1] in " \t":
                    break
                self.pos += 1
            piece = text[start: self.pos].rstrip(" \t")
            if piece:
                if parts:
                    parts.append("\n" * breaks if breaks else " ")
                parts.append(piece)
                breaks = 0
            if self.pos < len(text) and not (text[self.pos] == "#"):
                break
            # the line ended (or a comment did): the scalar may continue
            mark = (self.line, self.pos)
            if not self.next_line():
                self.line, self.pos = mark[0], len(self.lines[mark[0]])
                break
            stripped = self.text.lstrip(" \t")
            if not stripped:
                breaks += 1
                continue
            self.pos = len(self.text) - len(stripped)
            if stripped[0] in ",]}:#" or text[mark[1]:mark[1] + 1] == "#":
                break
        value = "".join(parts)
        return resolve_plain(value) if len(parts) <= 1 else value

    # ------------------------------------------------------------ collections

    def node(self) -> Any:
        self.skip_space()
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in ("'", '"'):
            return self.quoted()
        if ch in ("&", "*", "!"):
            kind = {"&": "anchors", "*": "aliases", "!": "tags"}[ch]
            raise self.error(f"{kind} are not supported")
        if ch == "" or ch in _FLOW_END:
            raise self.error("expected a flow node")
        return self.plain()

    def _entry(self) -> Tuple[Any, bool, Any]:
        """A key, whether a ``:`` followed it, and its value."""
        self.skip_space()
        if self.peek() in ("'", '"'):
            key = self.quoted()
            adjacent = True
        elif self.peek() == "?" and self.text[self.pos + 1: self.pos + 2] in (" ", "\t", ""):
            self.pos += 1
            return self._entry()
        else:
            key = self.node()
            adjacent = False
        self.skip_space()
        text = self.text
        if self.peek() == ":" and (adjacent or self.pos + 1 == len(text) or text[self.pos + 1] in " \t,[]{}"):
            self.pos += 1
            self.skip_space()
            if self.peek() in (",", "}", "]"):
                return key, True, None
            return key, True, self.node()
        return key, False, None

    def sequence(self) -> List[Any]:
        self.pos += 1
        items = []
        while True:
            self.skip_space()
            ch = self.peek()
            if ch == "]":
                self.pos += 1
                return items
            if ch == "":
                raise self.error("unterminated flow sequence")
            if ch == ",":
                raise self.error("an empty entry in a flow sequence")
            key, paired, value = self._entry()
            if paired:
                _hashable(key, self)
                items.append({key: value})
            else:
                items.append(key)
            self.skip_space()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, found {ch!r}")

    def mapping(self) -> dict:
        self.pos += 1
        result = {}
        while True:
            self.skip_space()
            ch = self.peek()
            if ch == "}":
                self.pos += 1
                return result
            if ch == "":
                raise self.error("unterminated flow mapping")
            if ch == ",":
                raise self.error("an empty entry in a flow mapping")
            key, _, value = self._entry()
            _hashable(key, self)
            result[key] = value
            self.skip_space()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, found {ch!r}")


def _hashable(key: Any, where: _Flow) -> None:
    if isinstance(key, (list, dict)):
        raise where.error("a collection cannot be a mapping key")


def safe_load(text: str) -> Any:
    """The document ``text`` (a ``str``, or a file object) read as
    ``yaml.safe_load`` reads it, within this module's subset."""
    if hasattr(text, "read"):
        text = text.read()
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return _Reader(text).document()


def _document_marker(line: str, marker: str) -> bool:
    return line == marker or line.startswith((marker + " ", marker + "\t"))


def safe_load_all(text: str) -> List[Any]:
    """Every document of the stream ``text`` (a ``str``, or a file
    object), each read as :func:`safe_load` reads one."""
    if hasattr(text, "read"):
        text = text.read()
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    if text.startswith("\ufeff"):
        text = text[1:]
    documents: List[List[str]] = []
    current: Optional[List[str]] = None  # the open document's lines
    for line in text.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        if _document_marker(line, "---"):
            if current is not None:
                documents.append(current)
            current = [" " * 3 + line[3:]]
        elif _document_marker(line, "..."):
            if current is not None:
                documents.append(current)
            current = None
        elif current is not None:
            current.append(line)
        elif not _blank(line):
            current = [line]
    if current is not None:
        documents.append(current)
    return [_Reader("\n".join(lines) + "\n").document() for lines in documents]
