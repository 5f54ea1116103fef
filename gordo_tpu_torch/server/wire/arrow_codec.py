"""
The Arrow IPC wire format in numpy and ``struct``, the port of
``gordo_tpu/server/wire/arrow_codec.py`` without pyarrow.

An Arrow IPC *stream* is a sequence of messages, each the continuation
marker ``0xFFFFFFFF``, the length of its metadata, the metadata (a
flatbuffer ``Message``, padded to 8 bytes) and its body; a zero length
ends the stream. The first message is the ``Schema``, each later one a
``RecordBatch`` whose body holds every column's buffers at 8-byte
offsets. This module writes and reads that with a minimal flatbuffer
builder and reader (vtables, tables, vectors, strings and the ``Type``
union), ``MetadataVersion`` V5, little-endian.

Types written and read: ``FloatingPoint`` (single and double), ``Int``,
``Timestamp`` (its unit and ``tz`` string), ``Utf8`` (validity bitmap,
int32 offsets), ``Null`` (an all-``None`` column such as ``end`` without a
frequency) and ``Bool``. Anything else, a dictionary batch or field, and
a compressed body (``BodyCompression``) raise :class:`ArrowDecodeError`
naming what is not read, and the routes answer 400: pyarrow would read
them.

Conventions (``docs/serving.md``): every field's ``gordo:role`` is
``index`` for the row index (``__index__``), ``y`` for target columns
and ``x`` (or nothing) for inputs; response fields carry ``gordo:group``
and ``gordo:sub`` and are named ``group`` or ``group/sub``; the scalar
envelope (``revision``, ``time-seconds``) is the schema's ``gordo:meta``,
``json.dumps(extra, default=str)``. A fleet body is a ``GDTAF1``
container of one stream a machine (:func:`pack_streams`).

Decoding: a null-free numeric column of a one-batch stream is a
``np.frombuffer`` view of the body; a column with nulls is a NaN-filled
copy; the batches of a multi-batch stream are concatenated. The index
comes back as the port's ``Frame`` index (``json_codec.Frame``): naive or
aware datetimes, with their unit (:class:`ArrowIndex`), or ints. A
nanosecond timestamp with digits below the microsecond is refused (the
port's datetimes hold microseconds).
"""

import hashlib
import json
import re
import struct
from datetime import datetime, timedelta, timezone, tzinfo
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ...utils.env import env_bool
from .assemble import WireColumn, WireTable
from .json_codec import Frame, FrameError

ARROW_CONTENT_TYPE = "application/vnd.apache.arrow.stream"

ROLE_KEY = b"gordo:role"
GROUP_KEY = b"gordo:group"
SUB_KEY = b"gordo:sub"
META_KEY = b"gordo:meta"
INDEX_FIELD = "__index__"

#: the fleet container's magic: per-machine IPC streams, length-prefixed
_FLEET_MAGIC = b"GDTAF1"

_CONTINUATION = 0xFFFFFFFF
_METADATA_V5 = 4
#: ``MessageHeader`` union members
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
#: ``Type`` union members, by number (the ones read are named in ``_READ``)
_TYPE_NAMES = (
    "NONE", "Null", "Int", "FloatingPoint", "Binary", "Utf8", "Bool", "Decimal", "Date", "Time", "Timestamp",
    "Interval", "List", "Struct", "Union", "FixedSizeBinary", "FixedSizeList", "Map", "Duration", "LargeBinary",
    "LargeUtf8", "LargeList", "RunEndEncoded", "BinaryView", "Utf8View", "ListView", "LargeListView",
)
_NULL, _INT, _FLOAT, _UTF8, _BOOL, _TIMESTAMP, _LARGE_UTF8 = 1, 2, 3, 5, 6, 10, 20
_READ = "Null, Int, FloatingPoint, Utf8, Bool and Timestamp"
_FLOAT_DTYPES = {0: np.float16, 1: np.float32, 2: np.float64}
_PRECISIONS = {np.dtype(np.float32): 1, np.dtype(np.float64): 2}
_UNITS = ("s", "ms", "us", "ns")
#: microseconds a unit's tick: the port's datetimes hold microseconds
_US_PER_TICK = {"s": 1_000_000, "ms": 1_000, "us": 1}
_OFFSET_TZ = re.compile(r"^([+-])(\d{2}):(\d{2})$")
_EPOCH = datetime(1970, 1, 1)
_MICROSECOND = timedelta(microseconds=1)


def arrow_enabled() -> bool:
    """Whether the Arrow wire format is served (``GORDO_TPU_WIRE_ARROW``,
    default on; ``0`` answers as a server without it: 406 and 415)."""
    return env_bool("GORDO_TPU_WIRE_ARROW", True)


class ArrowDecodeError(ValueError):
    """An Arrow body that is malformed or holds what is not read (400)."""


class ArrowIndex(NamedTuple):
    """A decoded index: ``values`` (datetimes or ints, in the body's row
    order) and the timestamp ``unit`` (None for ints)."""

    values: List[Any]
    unit: Optional[str]


# -- flatbuffers ------------------------------------------------------------------------

_SCALAR_FORMATS = {"bool": "<?", "u8": "<B", "i16": "<h", "i32": "<i", "i64": "<q"}


class _Table(NamedTuple):
    """A table to write: ``(slot, kind, value)`` fields. Kinds: the
    scalars of ``_SCALAR_FORMATS``, and ``table``, ``string``, ``tables``
    (a vector of tables) and ``structs`` (a vector of 16-byte structs,
    given as bytes) written after the table, where its offsets point."""

    fields: List[Tuple[int, str, Any]]


class _Builder:
    """A flatbuffer written front to back: the root offset, then each table
    as its vtable and its inline fields, then what its offsets point at,
    every scalar aligned to its size from the buffer's start."""

    def __init__(self, root: _Table):
        self.buf = bytearray(4)
        struct.pack_into("<I", self.buf, 0, self._table(root))

    def _pad(self, align: int, ahead: int = 0) -> None:
        self.buf.extend(bytes(-(len(self.buf) + ahead) % align))

    def _table(self, table: _Table) -> int:
        sized = [(4 if kind not in _SCALAR_FORMATS else struct.calcsize(_SCALAR_FORMATS[kind]), slot, kind, value)
                 for slot, kind, value in table.fields]
        sized.sort(key=lambda f: -f[0])  # largest first: each field lands aligned
        offsets, cursor = {}, 4  # after the soffset to the vtable
        for size, slot, _, _ in sized:
            cursor += -cursor % size
            offsets[slot] = cursor
            cursor += size
        align = 8 if any(size == 8 for size, *_ in sized) else 4
        slots = max(offsets) + 1 if offsets else 0
        self._pad(2)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<HH{slots}H", 4 + 2 * slots, cursor, *(offsets.get(i, 0) for i in range(slots)))
        self._pad(align)
        start = len(self.buf)
        self.buf += bytes(cursor)
        struct.pack_into("<i", self.buf, start, start - vtable)
        for size, slot, kind, value in sized:
            if kind in _SCALAR_FORMATS:
                struct.pack_into(_SCALAR_FORMATS[kind], self.buf, start + offsets[slot], value)
        for _, slot, kind, value in sorted(sized, key=lambda f: f[1]):
            if kind not in _SCALAR_FORMATS:
                at = start + offsets[slot]
                struct.pack_into("<I", self.buf, at, self._child(kind, value) - at)
        return start

    def _child(self, kind: str, value: Any) -> int:
        if kind == "table":
            return self._table(value)
        if kind == "string":
            self._pad(4)
            start = len(self.buf)
            encoded = value.encode()
            self.buf += struct.pack("<I", len(encoded)) + encoded + b"\0"
            return start
        if kind == "structs":  # 8-aligned elements after the 4-byte count
            self._pad(8, 4)
            start = len(self.buf)
            self.buf += struct.pack("<I", len(value) // 16) + value
            return start
        self._pad(4)  # tables
        start = len(self.buf)
        self.buf += struct.pack("<I", len(value)) + bytes(4 * len(value))
        for i, child in enumerate(value):
            at = start + 4 + 4 * i
            struct.pack_into("<I", self.buf, at, self._table(child) - at)
        return start


def _malformed(what: str) -> ArrowDecodeError:
    return ArrowDecodeError(f"Malformed Arrow IPC body: {what}")


def _unpack(fmt: str, buf, pos: int):
    size = struct.calcsize(fmt)
    if pos < 0 or pos + size > len(buf):
        raise _malformed(f"offset {pos} out of bounds")
    return struct.unpack_from(fmt, buf, pos)[0]


class _View:
    """A flatbuffer table read in place: ``buf`` and the table's position."""

    __slots__ = ("buf", "pos", "_vtable", "_vsize")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self._vtable = pos - _unpack("<i", buf, pos)
        self._vsize = _unpack("<H", buf, self._vtable)

    def _field(self, slot: int) -> int:
        entry = 4 + 2 * slot
        return _unpack("<H", self.buf, self._vtable + entry) if entry < self._vsize else 0

    def scalar(self, slot: int, kind: str, default: Any = 0) -> Any:
        offset = self._field(slot)
        return _unpack(_SCALAR_FORMATS[kind], self.buf, self.pos + offset) if offset else default

    def _target(self, slot: int) -> Optional[int]:
        offset = self._field(slot)
        if not offset:
            return None
        at = self.pos + offset
        return at + _unpack("<I", self.buf, at)

    def table(self, slot: int) -> Optional["_View"]:
        target = self._target(slot)
        return None if target is None else _View(self.buf, target)

    def string(self, slot: int) -> Optional[bytes]:
        target = self._target(slot)
        if target is None:
            return None
        length = _unpack("<I", self.buf, target)
        if target + 4 + length > len(self.buf):
            raise _malformed("string out of bounds")
        return bytes(self.buf[target + 4: target + 4 + length])

    def tables(self, slot: int) -> List["_View"]:
        target = self._target(slot)
        if target is None:
            return []
        count = _unpack("<I", self.buf, target)
        items = []
        for i in range(count):
            at = target + 4 + 4 * i
            items.append(_View(self.buf, at + _unpack("<I", self.buf, at)))
        return items

    def structs(self, slot: int) -> np.ndarray:
        """A vector of 16-byte ``(int64, int64)`` structs as ``[n, 2]``."""
        target = self._target(slot)
        if target is None:
            return np.zeros((0, 2), np.int64)
        count = _unpack("<I", self.buf, target)
        if target + 4 + 16 * count > len(self.buf):
            raise _malformed("struct vector out of bounds")
        return np.frombuffer(self.buf, "<i8", 2 * count, target + 4).reshape(count, 2)


# -- types ------------------------------------------------------------------------------


def _type_table(kind: tuple) -> Tuple[int, _Table]:
    """The ``Type`` union member and table of a column type: ``("null",)``,
    ``("utf8",)``, ``("large_utf8",)`` (written for parquet's schema
    only), ``("bool",)``, ``("int", bits, signed)``, ``("float",
    precision)`` or ``("timestamp", unit, tz)``."""
    name = kind[0]
    if name == "int":
        return _INT, _Table([(0, "i32", kind[1]), (1, "bool", kind[2])])
    if name == "float":
        return _FLOAT, _Table([(0, "i16", kind[1])])
    if name == "timestamp":
        fields = [(0, "i16", _UNITS.index(kind[1]))]
        if kind[2] is not None:
            fields.append((1, "string", kind[2]))
        return _TIMESTAMP, _Table(fields)
    return {"null": _NULL, "utf8": _UTF8, "bool": _BOOL, "large_utf8": _LARGE_UTF8}[name], _Table([])


def _read_type(field: _View, name: str) -> tuple:
    member = field.scalar(2, "u8")
    table = field.table(3)
    if member == _NULL:
        return ("null",)
    if member == _UTF8:
        return ("utf8",)
    if member == _BOOL:
        return ("bool",)
    if member == _INT and table is not None and table.scalar(0, "i32") in (8, 16, 32, 64):
        return ("int", table.scalar(0, "i32"), table.scalar(1, "bool", False))
    if member == _FLOAT and table is not None and table.scalar(0, "i16") in _FLOAT_DTYPES:
        return ("float", table.scalar(0, "i16"))
    if member == _TIMESTAMP and table is not None:
        unit = table.scalar(0, "i16")
        tz = table.string(1)
        if not 0 <= unit < len(_UNITS):
            raise _malformed(f"timestamp unit {unit}")
        return ("timestamp", _UNITS[unit], None if tz is None else tz.decode())
    type_name = _TYPE_NAMES[member] if 0 <= member < len(_TYPE_NAMES) else str(member)
    raise ArrowDecodeError(f"Arrow type {type_name} of column {name!r} is not read; the port reads {_READ}")


def _tz_name(zone: Optional[tzinfo]) -> Optional[str]:
    """A datetime's zone as Arrow's ``tz``: ``UTC``, ``+HH:MM`` or an IANA
    key."""
    if zone is None:
        return None
    if zone is timezone.utc:
        return "UTC"
    key = getattr(zone, "key", None)
    if key is not None:
        return key
    offset = zone.utcoffset(None)
    minutes = int(offset.total_seconds()) // 60
    sign = "-" if minutes < 0 else "+"
    return f"{sign}{abs(minutes) // 60:02d}:{abs(minutes) % 60:02d}"


def _zone(tz: Optional[str]) -> Optional[tzinfo]:
    if tz is None:
        return None
    if tz.upper() in ("UTC", "Z", "+00:00"):
        return timezone.utc
    match = _OFFSET_TZ.match(tz)
    if match:
        minutes = int(match.group(2)) * 60 + int(match.group(3))
        return timezone(timedelta(minutes=-minutes if match.group(1) == "-" else minutes))
    from zoneinfo import ZoneInfo, ZoneInfoNotFoundError

    try:
        return ZoneInfo(tz)
    except (ZoneInfoNotFoundError, ValueError):
        raise ArrowDecodeError(f"Unknown timestamp time zone {tz!r}") from None


# -- encoding ---------------------------------------------------------------------------


def _bitmap(valid: np.ndarray) -> bytes:
    return np.packbits(valid, bitorder="little").tobytes()


def _column(values: Any) -> Tuple[tuple, int, int, List[bytes]]:
    """``(type, length, null count, buffers)`` of one column's values: a
    numpy array (float32, float64, int64 or bool) or a list of strings
    and ``None`` (``null`` when all are ``None``)."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "fiub":
        data = np.ascontiguousarray(values)
        n = len(data)
        if data.dtype.kind == "b":
            return ("bool",), n, 0, [b"", _bitmap(data)]
        if data.dtype.kind == "f":
            kind = ("float", _PRECISIONS[data.dtype])
        else:
            kind = ("int", data.dtype.itemsize * 8, data.dtype.kind == "i")
        return kind, n, 0, [b"", data.astype(data.dtype.newbyteorder("<"), copy=False).tobytes()]
    values = list(values)
    n = len(values)
    valid = np.array([v is not None for v in values], bool)
    if not valid.any():
        return ("null",), n, n, []
    if not all(isinstance(v, str) for v in values if v is not None):
        raise TypeError(f"Column values are neither numeric arrays nor strings: {values[:3]}")
    encoded = [v.encode() if v is not None else b"" for v in values]
    offsets = np.zeros(n + 1, "<i4")
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    nulls = int(n - valid.sum())
    return ("utf8",), n, nulls, [_bitmap(valid) if nulls else b"", offsets.tobytes(), b"".join(encoded)]


def timestamp_ticks(index: Sequence[Any], unit: Optional[str]) -> Tuple[np.ndarray, str, Optional[str]]:
    """A datetime index as ``(int64 ticks, unit, zone)``: ticks of ``unit``
    (default ``us``, what the JSON decode's ISO parse gives) since the UTC
    epoch for aware datetimes (zone ``UTC``, ``+HH:MM`` or an IANA key),
    since the wall-clock epoch for naive ones (zone None)."""
    values = list(index)
    zone = values[0].tzinfo if values else None
    epoch = _EPOCH.replace(tzinfo=timezone.utc) if zone else _EPOCH
    ticks = np.array([(v - epoch) // _MICROSECOND for v in values], np.int64)
    unit = unit or "us"
    ticks = ticks * 1000 if unit == "ns" else ticks // _US_PER_TICK[unit]
    return ticks, unit, _tz_name(zone)


def _index_column(index: Sequence[Any], unit: Optional[str]) -> Tuple[tuple, int, int, List[bytes]]:
    """The index as a timestamp column (:func:`timestamp_ticks`) with its
    zone, or an int64 column."""
    values = list(index)
    if values and isinstance(values[0], datetime):
        ticks, unit, zone = timestamp_ticks(values, unit)
        return ("timestamp", unit, zone), len(values), 0, [b"", ticks.astype("<i8").tobytes()]
    return _column(np.asarray(values, np.int64))


def _message(header_type: int, header: _Table, body_length: int) -> bytes:
    """One framed message's metadata: continuation, length, the flatbuffer
    padded so that the body starts 8-aligned."""
    flat = _Builder(_Table([
        (0, "i16", _METADATA_V5), (1, "u8", header_type), (2, "table", header), (3, "i64", body_length),
    ])).buf
    flat += bytes(-len(flat) % 8)
    return struct.pack("<Ii", _CONTINUATION, len(flat)) + bytes(flat)


def _field_table(name: str, kind: tuple, metadata: Dict[bytes, bytes]) -> _Table:
    member, type_table = _type_table(kind)
    fields = [(0, "string", name), (1, "bool", True), (2, "u8", member), (3, "table", type_table)]
    if metadata:
        fields.append((6, "tables", _key_values(metadata)))
    return _Table(fields)


def _key_values(metadata: Dict[bytes, bytes]) -> List[_Table]:
    return [_Table([(0, "string", k.decode()), (1, "string", v.decode())]) for k, v in metadata.items()]


#: schema messages by fields and metadata: a served model's response
#: schema is fixed, and a fleet answer repeats one for every machine
#: (JAX caches its response fields likewise); cleared when full
_SCHEMA_CACHE: Dict[tuple, bytes] = {}
_SCHEMA_CACHE_MAX_ENTRIES = 256


def _schema_message(fields, metadata: Optional[Dict[bytes, bytes]]) -> bytes:
    key = (tuple((name, kind, tuple(meta.items())) for name, meta, kind, *_ in fields),
           tuple(metadata.items()) if metadata else ())
    message = _SCHEMA_CACHE.get(key)
    if message is None:
        schema = [(0, "i16", 0), (1, "tables", [_field_table(name, kind, meta) for name, meta, kind, *_ in fields])]
        if metadata:
            schema.append((2, "tables", _key_values(metadata)))
        message = _message(_SCHEMA, _Table(schema), 0)
        if len(_SCHEMA_CACHE) >= _SCHEMA_CACHE_MAX_ENTRIES:
            _SCHEMA_CACHE.clear()
        _SCHEMA_CACHE[key] = message
    return message


def arrow_schema_message(fields: List[Tuple[str, tuple]], metadata: Dict[bytes, bytes]) -> bytes:
    """The schema message of ``(name, type)`` fields with the schema's
    ``metadata``, framed as a stream's first message: what a parquet
    file's ``ARROW:schema`` holds (base64)."""
    return _schema_message([(name, {}, kind) for name, kind in fields], metadata)


def _stream(fields: List[Tuple[str, Dict[bytes, bytes], tuple, int, int, List[bytes]]],
            metadata: Optional[Dict[bytes, bytes]] = None) -> bytes:
    """A one-batch IPC stream of ``(name, field metadata, type, length,
    null count, buffers)`` columns."""
    parts = [_schema_message(fields, metadata)]
    nodes, buffers, body = [], [], bytearray()
    length = fields[0][3] if fields else 0
    for _, _, _, n, nulls, column_buffers in fields:
        nodes.append((n, nulls))
        for buffer in column_buffers:
            buffers.append((len(body), len(buffer)))
            body += buffer
            body += bytes(-len(body) % 8)
    batch = _Table([
        (0, "i64", length),
        (1, "structs", np.array(nodes, "<i8").reshape(-1, 2).tobytes()),
        (2, "structs", np.array(buffers, "<i8").reshape(-1, 2).tobytes()),
    ])
    parts += [_message(_RECORD_BATCH, batch, len(body)), bytes(body), struct.pack("<Ii", _CONTINUATION, 0)]
    return b"".join(parts)


def encode_table(table: WireTable, extra: Optional[Dict[str, Any]] = None) -> bytes:
    """One response table as a one-batch Arrow IPC stream: ``__index__``
    (role ``index``), then each column named ``group`` or ``group/sub``
    with its ``gordo:group``/``gordo:sub``; ``extra`` as ``gordo:meta``."""
    fields = [(INDEX_FIELD, {ROLE_KEY: b"index"}, *_index_column(table.index, table.unit))]
    for column in table.columns:
        name = column.group if not column.sub else f"{column.group}/{column.sub}"
        fields.append((name, {GROUP_KEY: column.group.encode(), SUB_KEY: column.sub.encode()},
                       *_column(column.values)))
    metadata = {META_KEY: json.dumps(extra, default=str).encode()} if extra else None
    return _stream(fields, metadata)


def encode_request(X: Any, y: Any = None) -> bytes:
    """An ``X`` (and ``y``) request body as one IPC stream, the client's
    encoder: ``X`` and ``y`` are ``json_codec.Frame``s (index, column
    names, ``values[rows, columns]``) sharing one index; each column keeps
    its dtype."""
    fields = [(INDEX_FIELD, {ROLE_KEY: b"index"}, *_index_column(X.index, getattr(X, "unit", None)))]
    for frame, role in ((X, b"x"), (y, b"y")):
        if frame is None:
            continue
        values = np.asarray(frame.values)
        for j, name in enumerate(frame.columns):
            fields.append((str(name), {ROLE_KEY: role}, *_column(values[:, j])))
    return _stream(fields)


# -- decoding ---------------------------------------------------------------------------


class _Field(NamedTuple):
    name: str
    kind: tuple
    metadata: Dict[bytes, bytes]


def _messages(buf) -> List[Tuple[_View, memoryview]]:
    """Every message of a stream as ``(Message table, body)``, to the
    end-of-stream marker or the end of the buffer."""
    view = memoryview(buf)
    pos, out = 0, []
    while pos + 4 <= len(view):
        length = _unpack("<i", view, pos)
        pos += 4
        if length == -1:  # the continuation marker; a bare length is the pre-1.0 framing
            length = _unpack("<i", view, pos)
            pos += 4
        if length == 0:
            break
        if length < 0 or pos + length > len(view):
            raise _malformed("truncated message metadata")
        meta = view[pos: pos + length]
        pos += length
        message = _View(meta, _unpack("<I", meta, 0))
        body_length = message.scalar(3, "i64")
        if body_length < 0 or pos + body_length > len(view):
            raise _malformed("truncated message body")
        out.append((message, view[pos: pos + body_length]))
        pos += body_length
    return out


def _schema(message: _View) -> Tuple[List[_Field], Dict[bytes, bytes]]:
    if message.scalar(1, "u8") != _SCHEMA:
        raise _malformed("the stream does not start with a schema")
    schema = message.table(2)
    if schema is None:
        raise _malformed("schema message without a schema")
    if schema.scalar(0, "i16") != 0:
        raise ArrowDecodeError("Big-endian Arrow bodies are not read")
    fields = []
    for field in schema.tables(1):
        name = (field.string(0) or b"").decode()
        if field.table(4) is not None:
            raise ArrowDecodeError(f"Dictionary-encoded column {name!r} is not read")
        fields.append(_Field(name, _read_type(field, name), _read_metadata(field, 6)))
    return fields, _read_metadata(schema, 2)


def _read_metadata(table: _View, slot: int) -> Dict[bytes, bytes]:
    return {kv.string(0) or b"": kv.string(1) or b"" for kv in table.tables(slot)}


def _buffer(body: memoryview, spans: np.ndarray, i: int) -> memoryview:
    offset, length = (int(v) for v in spans[i])
    if offset < 0 or length < 0 or offset + length > len(body):
        raise _malformed(f"buffer {i} out of bounds")
    return body[offset: offset + length]


def _valid(bitmap: memoryview, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(bitmap, np.uint8), bitorder="little")
    if len(bits) < n:
        raise _malformed("validity bitmap too short")
    return bits[:n].astype(bool)


def _decode_column(kind: tuple, n: int, nulls: int, body: memoryview, spans: np.ndarray, first: int) -> np.ndarray:
    """One column of a batch from its buffers ``spans[first:]``."""
    if kind[0] == "null":
        return np.full(n, None, object)
    valid = _valid(_buffer(body, spans, first), n) if nulls else None
    if kind[0] == "utf8":
        offsets = np.frombuffer(_buffer(body, spans, first + 1), "<i4")
        data = bytes(_buffer(body, spans, first + 2))
        if len(offsets) < n + 1:
            raise _malformed("string offsets too short")
        out = np.empty(n, object)
        for i in range(n):
            out[i] = None if valid is not None and not valid[i] else data[offsets[i]:offsets[i + 1]].decode()
        return out
    if kind[0] == "bool":
        values = _valid(_buffer(body, spans, first + 1), n)
        if valid is None:
            return values
        out = values.astype(object)
        out[~valid] = None
        return out
    if kind[0] == "int":
        dtype = np.dtype(f"<{'i' if kind[2] else 'u'}{kind[1] // 8}")
    elif kind[0] == "float":
        dtype = np.dtype(_FLOAT_DTYPES.get(kind[1], np.float64)).newbyteorder("<")
    else:  # timestamp: the raw ticks
        dtype = np.dtype("<i8")
    data = _buffer(body, spans, first + 1)
    if len(data) < n * dtype.itemsize:
        raise _malformed("data buffer too short")
    values = np.frombuffer(data, dtype, n)
    if valid is None:
        return values
    if kind[0] == "timestamp":
        raise ArrowDecodeError("Null timestamps are not read")
    out = values.astype(np.float64 if kind[0] == "int" else dtype)
    out[~valid] = np.nan
    return out


_BUFFERS = {"null": 0, "utf8": 3}


def _read_stream(buf) -> Tuple[List[_Field], Dict[bytes, bytes], List[np.ndarray]]:
    """``(fields, schema metadata, columns)`` of an IPC stream, the batches
    concatenated; anything unreadable is an ``ArrowDecodeError``."""
    try:
        return _read_batches(buf)
    except ArrowDecodeError:
        raise
    except (struct.error, ValueError, TypeError, IndexError, OverflowError) as exc:  # garbage sizes or text
        raise _malformed(str(exc)) from None


def _read_batches(buf) -> Tuple[List[_Field], Dict[bytes, bytes], List[np.ndarray]]:
    messages = _messages(buf)
    if not messages:
        raise ArrowDecodeError("Empty Arrow IPC body")
    fields, metadata = _schema(messages[0][0])
    batches: List[List[np.ndarray]] = []
    for message, body in messages[1:]:
        header = message.scalar(1, "u8")
        if header == _DICTIONARY_BATCH:
            raise ArrowDecodeError("Arrow dictionary batches are not read")
        if header != _RECORD_BATCH:
            raise _malformed(f"message type {header} inside the stream")
        batch = message.table(2)
        if batch is None:
            raise _malformed("record batch message without a batch")
        if batch.table(3) is not None:
            raise ArrowDecodeError("Compressed Arrow bodies (BodyCompression) are not read")
        nodes, spans = batch.structs(1), batch.structs(2)
        if len(nodes) != len(fields):
            raise _malformed(f"{len(nodes)} field nodes for {len(fields)} fields")
        rows = batch.scalar(0, "i64")
        # every column of a batch has its rows; a bound from the body's size caps what a null column allocates
        if not 0 <= rows <= 8 * len(buf) or any(n != rows for n in nodes[:, 0].tolist()):
            raise _malformed(f"a batch of {rows} rows with field nodes of {nodes[:, 0].tolist()[:5]}")
        columns, first = [], 0
        for field, (n, nulls) in zip(fields, nodes.tolist()):
            if not 0 <= nulls <= n:
                raise _malformed(f"field node of length {n} with {nulls} nulls")
            count = _BUFFERS.get(field.kind[0], 2)
            if first + count > len(spans):
                raise _malformed("too few buffers")
            columns.append(_decode_column(field.kind, n, nulls, body, spans, first))
            first += count
        batches.append(columns)
    if not batches:
        raise ArrowDecodeError("Empty Arrow IPC body")
    if len(batches) == 1:
        return fields, metadata, batches[0]
    return fields, metadata, [np.concatenate(parts) for parts in zip(*batches)]


#: decoded datetime indexes by digest: clients replay the same windows and
#: a fleet's machines share one index; bounded by entries and rows
_INDEX_CACHE: Dict[tuple, List[datetime]] = {}
_INDEX_CACHE_MAX_ENTRIES = 64
_INDEX_CACHE_MAX_ROWS = 8192


def _index(kind: tuple, values: np.ndarray) -> ArrowIndex:
    """An index column as the port's index: datetimes (aware in the
    column's zone) with their unit, or ints."""
    if kind[0] == "int":
        return ArrowIndex(values.astype(np.int64).tolist(), None)
    if kind[0] != "timestamp":
        raise ArrowDecodeError(f"The index column is {kind[0]}; the port reads a timestamp or an integer index")
    return index_from_ticks(values, kind[1], kind[2])


def index_from_ticks(values: np.ndarray, unit: str, tz: Optional[str]) -> ArrowIndex:
    """Timestamp ticks of ``unit`` as the port's index: datetimes, aware in
    zone ``tz`` (ticks since the UTC epoch) or naive (``tz`` None), with
    their unit; ``ArrowDecodeError`` for nanoseconds below the
    microsecond."""
    ticks = np.asarray(values, np.int64)
    key = None
    if len(ticks) <= _INDEX_CACHE_MAX_ROWS:
        key = (hashlib.sha1(ticks.tobytes()).digest(), unit, tz)
        cached = _INDEX_CACHE.get(key)
        if cached is not None:
            return ArrowIndex(list(cached), unit)
    if unit == "ns":
        if (ticks % 1000).any():
            raise ArrowDecodeError("Nanosecond timestamps below the microsecond are not read; send microseconds")
        micros = ticks // 1000
    else:
        micros = ticks * _US_PER_TICK[unit]
    naive = micros.astype("datetime64[us]").astype(object).tolist()
    zone = _zone(tz)
    if zone is timezone.utc:
        index = [d.replace(tzinfo=zone) for d in naive]
    elif zone is not None:
        index = [d.replace(tzinfo=timezone.utc).astimezone(zone) for d in naive]
    else:
        index = naive
    if key is not None:
        if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX_ENTRIES:
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = index
    return ArrowIndex(list(index), unit)


def decode_frames(buf) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Optional[ArrowIndex]]:
    """An Arrow request body -> ``(x columns, y columns, index)``. Roles come
    from ``gordo:role``; an unmarked field is ``x``, an unmarked
    ``__index__`` the index."""
    fields, _, columns = _read_stream(buf)
    x_cols: Dict[str, np.ndarray] = {}
    y_cols: Dict[str, np.ndarray] = {}
    index = None
    for field, values in zip(fields, columns):
        role = field.metadata.get(ROLE_KEY, b"x")
        if role == b"index" or (field.name == INDEX_FIELD and role == b"x"):
            index = _index(field.kind, values)
            continue
        target = y_cols if role == b"y" else x_cols
        if field.name in target:
            raise ArrowDecodeError(f"Duplicate column {field.name!r} in Arrow body")
        target[field.name] = values
    if not x_cols:
        raise ArrowDecodeError('Cannot predict without "X"')
    return x_cols, y_cols, index


def frame_from_columns(columns: Dict[str, np.ndarray], index: Optional[ArrowIndex], expected: Sequence[str]) -> Frame:
    """A model-input frame from decoded columns, aligned as
    ``json_codec.verify_frame`` aligns (``gordo_tpu/server/utils.py:255-292``):
    the model's tags selected in order (extras dropped), or a full-width
    positional rename; ``FrameError`` otherwise. Rows are sorted by the
    index when it is not monotonic (which stacks them); without an index
    they are numbered. Rows in order stay the decoded columns, unstacked
    (``Frame.arrays``)."""
    expected = list(expected)
    names = list(columns)
    if all(name in columns for name in expected):
        order = expected
    elif len(names) == len(expected):
        order = names
    else:
        raise FrameError(
            f"Unexpected features: was expecting {expected} length of "
            f"{len(expected)}, but got {names} length of {len(names)}"
        )
    arrays = [columns[name] for name in order]
    if np.result_type(*arrays).kind not in "fiu":
        raise FrameError(f"Non-numeric values in columns {order}")
    if index is None:
        return Frame(list(range(len(arrays[0]))), expected, None, None, arrays)
    keys = index.values
    if any(b < a for a, b in zip(keys, keys[1:])):
        rows = sorted(range(len(keys)), key=keys.__getitem__)
        return Frame([keys[i] for i in rows], expected, np.column_stack(arrays)[rows], index.unit)
    return Frame(keys, expected, None, index.unit, arrays)


def decode_response(buf) -> Tuple[WireTable, Dict[str, Any]]:
    """A response stream -> ``(table, envelope)``, the client's decoder: the
    columns under their ``(group, sub)``, the index with its unit, and
    ``gordo:meta``."""
    fields, metadata, columns = _read_stream(buf)
    index, unit = None, None
    out = []
    for field, values in zip(fields, columns):
        if field.metadata.get(ROLE_KEY) == b"index":
            index, unit = _index(field.kind, values)
            continue
        group = field.metadata.get(GROUP_KEY, field.name.encode()).decode()
        out.append(WireColumn(group, field.metadata.get(SUB_KEY, b"").decode(), values))
    raw = metadata.get(META_KEY)
    n = len(columns[0]) if columns else 0
    return WireTable(index if index is not None else list(range(n)), out, unit), json.loads(raw) if raw else {}


# -- the fleet container ----------------------------------------------------------------


def pack_streams(entries: Dict[str, bytes], extra: Optional[Dict[str, Any]] = None) -> bytes:
    """Length-prefixed container of named IPC payloads (one per machine)
    plus a JSON ``extra`` trailer (per-machine errors, revision)."""
    parts = [_FLEET_MAGIC, struct.pack("<I", len(entries))]
    for name, payload in entries.items():
        encoded = name.encode()
        parts.append(struct.pack("<I", len(encoded)))
        parts.append(encoded)
        parts.append(struct.pack("<Q", len(payload)))
        parts.append(payload)
    trailer = json.dumps(extra or {}, default=str).encode()
    parts.append(struct.pack("<Q", len(trailer)))
    parts.append(trailer)
    return b"".join(parts)


def unpack_streams(buf) -> Tuple[Dict[str, bytes], Dict[str, Any]]:
    """Inverse of :func:`pack_streams`; raises :class:`ArrowDecodeError` on
    truncation or garbage."""
    view = memoryview(buf)
    if len(view) < len(_FLEET_MAGIC) + 4 or bytes(view[: len(_FLEET_MAGIC)]) != _FLEET_MAGIC:
        raise ArrowDecodeError("Not a gordo Arrow fleet container")
    offset = len(_FLEET_MAGIC)
    try:
        (count,) = struct.unpack_from("<I", view, offset)
        offset += 4
        entries: Dict[str, bytes] = {}
        for _ in range(count):
            (name_len,) = struct.unpack_from("<I", view, offset)
            offset += 4
            name = bytes(view[offset: offset + name_len]).decode()
            offset += name_len
            (payload_len,) = struct.unpack_from("<Q", view, offset)
            offset += 8
            if offset + payload_len > len(view):
                raise ArrowDecodeError("Truncated fleet container entry")
            entries[name] = bytes(view[offset: offset + payload_len])
            offset += payload_len
        (trailer_len,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        trailer = bytes(view[offset: offset + trailer_len])
        extra = json.loads(trailer) if trailer else {}
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ArrowDecodeError(f"Malformed fleet container: {exc}") from None
    return entries, extra
