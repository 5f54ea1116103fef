"""
Thrift's compact protocol, the encoding of parquet's footer and page
headers, read and written without a schema.

:func:`read_struct` reads any struct into ``{field id: value}``: booleans,
integers (zigzag varints), doubles, binaries (``bytes``), lists and sets
(``list``), maps (``dict``) and nested structs (``dict``). Field ids the
caller does not look up are read and skipped, so a newer writer's fields
never fail the read. The parquet structs (``FileMetaData``,
``SchemaElement`` with its ``LogicalType``, ``RowGroup``, ``ColumnChunk``,
``ColumnMetaData``, ``PageHeader`` and its v1, v2 and dictionary headers,
``KeyValue``) are read by their field ids in ``utils/parquet.py``.

:func:`write_struct` writes ``[(field id, type, value), ...]`` in the
order given, where ``type`` is what the parquet footer and page headers
hold: ``bool``, ``i16``, ``i32``, ``i64``, ``binary`` (``bytes`` or
``str``), ``struct`` (a list of such triples) or ``("list", element
type)``.

>>> fields = [(1, "i32", -7), (2, "binary", "x"), (4, ("list", "struct"), [[(1, "bool", True)]])]
>>> read_struct(write_struct(fields))
({1: -7, 2: b'x', 4: [{1: True}]}, 10)
"""

import struct
from typing import Any, Dict, List, Tuple

#: compact type codes
STOP, TRUE, FALSE, BYTE, I16, I32, I64, DOUBLE, BINARY, LIST, SET, MAP, STRUCT = range(13)
_CODES = {"bool": TRUE, "i16": I16, "i32": I32, "i64": I64, "binary": BINARY, "struct": STRUCT}
_MAX_DEPTH = 64


class ThriftError(ValueError):
    """Bytes that are not a compact-protocol struct."""


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError("truncated struct")
        value = self.buf[self.pos]
        self.pos += 1
        return value

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.byte()
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 70:
                raise ThriftError("varint too long")

    def zigzag(self) -> int:
        value = self.varint()
        return (value >> 1) ^ -(value & 1)

    def take(self, n: int):
        if n < 0 or self.pos + n > len(self.buf):
            raise ThriftError("truncated binary")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return bytes(out)

    def value(self, code: int, depth: int) -> Any:
        if code in (TRUE, FALSE):  # a list element; in a field the type says it
            return self.byte() == TRUE
        if code == BYTE:
            value = self.byte()
            return value - 256 if value > 127 else value
        if code in (I16, I32, I64):
            return self.zigzag()
        if code == DOUBLE:
            return struct.unpack("<d", self.take(8))[0]
        if code == BINARY:
            return self.take(self.varint())
        if code in (LIST, SET):
            header = self.byte()
            size, element = header >> 4, header & 0x0F
            if size == 15:
                size = self.varint()
            return [self.value(element, depth + 1) for _ in range(size)]
        if code == MAP:
            size = self.varint()
            if not size:
                return {}
            kinds = self.byte()
            return {self.value(kinds >> 4, depth + 1): self.value(kinds & 0x0F, depth + 1) for _ in range(size)}
        if code == STRUCT:
            return self.struct(depth + 1)
        raise ThriftError(f"unknown compact type {code}")

    def struct(self, depth: int = 0) -> Dict[int, Any]:
        if depth > _MAX_DEPTH:
            raise ThriftError("structs nested too deep")
        fields: Dict[int, Any] = {}
        last = 0
        while True:
            header = self.byte()
            if header == STOP:
                return fields
            delta, code = header >> 4, header & 0x0F
            field_id = last + delta if delta else self.zigzag()
            if code in (TRUE, FALSE):
                fields[field_id] = code == TRUE
            else:
                fields[field_id] = self.value(code, depth)
            last = field_id


def read_struct(buf, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """The struct at ``pos`` as ``{field id: value}``, and the position
    after it."""
    reader = _Reader(memoryview(buf), pos)
    return reader.struct(), reader.pos


def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _zigzag(value: int) -> bytes:
    return _varint((value << 1) ^ (value >> 63))


def _code(kind) -> int:
    return LIST if isinstance(kind, tuple) else _CODES[kind]


def _write_value(out: bytearray, kind, value: Any) -> None:
    if isinstance(kind, tuple):
        element = kind[1]
        code = _CODES[element]
        out.append((len(value) << 4 | code) if len(value) < 15 else 0xF0 | code)
        if len(value) >= 15:
            out += _varint(len(value))
        for item in value:
            if element == "bool":
                out.append(TRUE if item else FALSE)
            else:
                _write_value(out, element, item)
    elif kind in ("i16", "i32", "i64"):
        out += _zigzag(int(value))
    elif kind == "binary":
        data = value.encode() if isinstance(value, str) else bytes(value)
        out += _varint(len(data)) + data
    elif kind == "struct":
        _write_fields(out, value)
    else:
        raise ThriftError(f"cannot write a {kind!r} field")


def _write_fields(out: bytearray, fields: List[Tuple[int, Any, Any]]) -> None:
    last = 0
    for field_id, kind, value in fields:
        code = (TRUE if value else FALSE) if kind == "bool" else _code(kind)
        delta = field_id - last
        if 0 < delta <= 15:
            out.append(delta << 4 | code)
        else:
            out.append(code)
            out += _zigzag(field_id)
        if kind != "bool":
            _write_value(out, kind, value)
        last = field_id
    out.append(STOP)


def write_struct(fields: List[Tuple[int, Any, Any]]) -> bytes:
    """``fields`` as one compact-protocol struct (see the module's
    docstring)."""
    out = bytearray()
    _write_fields(out, fields)
    return bytes(out)
