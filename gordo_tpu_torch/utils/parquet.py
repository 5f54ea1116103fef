"""
Parquet in numpy and ``struct``, the port's counterpart of pyarrow's
``parquet`` module for what the JAX package reads and writes with it:
data files (``FileDataProvider``), request bodies and responses.

A file is ``PAR1``, the column chunks, the footer (a Thrift
compact-protocol ``FileMetaData``, ``utils/thrift_compact.py``), the
footer's length and ``PAR1``. Each row group holds one chunk a column:
an optional dictionary page, then data pages, each a ``PageHeader`` and
its body.

Read (:func:`read_table`, :func:`read_frame`):

- flat columns, ``required`` or ``optional`` (definition levels; a null
  is NaN in a float column, an int column with nulls becomes float64
  with NaN as pandas makes it, a string's null is ``None``);
- physical types DOUBLE, FLOAT, INT32, INT64, BOOLEAN and BYTE_ARRAY
  (strings), and an INT32 column of the ``UNKNOWN`` (null) logical type;
- ``TIMESTAMP`` in ms, us and ns, adjusted to UTC or not, from the
  logical type or the legacy converted types;
- encodings ``PLAIN``, ``PLAIN_DICTIONARY``/``RLE_DICTIONARY``, ``RLE``
  (booleans and levels), the RLE/bit-packed hybrid, data pages v1 and
  v2, several row groups and pages;
- codecs ``UNCOMPRESSED``, ``SNAPPY`` (``utils/snappy.py``) and ``GZIP``
  (``zlib``).

Anything else (``ZSTD``, ``LZ4``, ``BROTLI``, ``LZO``, nested or repeated
columns, ``DELTA_*``, ``BYTE_STREAM_SPLIT``, INT96, fixed-length binary)
raises :class:`ParquetDecodeError` naming what is not read.

:func:`read_frame` applies the ``pandas`` key-value metadata as pandas
does: the index from ``index_columns`` (a stored column, or a ``{"kind":
"range"}`` descriptor), a column's time zone from its ``timezone``, and
two-level column labels from the stringified tuples when
``column_indexes`` has two levels.

Write (:func:`write_frame`): one row group, every column ``optional``
with one PLAIN data page v1 and RLE/bit-packed definition levels, as
pyarrow writes a frame with ``use_dictionary=False``: float64 DOUBLE,
float32 FLOAT, int64 INT64, bool BOOLEAN, strings BYTE_ARRAY ``STRING``,
an all-``None`` column INT32 ``UNKNOWN``, the index INT64 ``TIMESTAMP``.
A float NaN is written as a null, as ``Table.from_pandas`` does. Pages
are SNAPPY, as the JAX server writes them, but of literal blocks
(``utils/snappy.py``): no smaller than uncompressed pages.
The ``pandas`` metadata and an ``ARROW:schema`` (the schema as an Arrow
IPC message, built with ``server/wire/arrow_codec.py``'s flatbuffer
writer) let pyarrow restore the index, its unit and zone, the column
labels and the dtypes.
"""

import ast
import base64
import json
import struct
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import snappy
from .thrift_compact import ThriftError, read_struct, write_struct

MAGIC = b"PAR1"
CONTENT_TYPE = "application/x-parquet"

#: physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
_TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
#: encodings
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, RLE_DICTIONARY = 0, 2, 3, 4, 8
_ENCODING_NAMES = {
    0: "PLAIN", 1: "GROUP_VAR_INT", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
    6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT",
}
#: compression codecs
UNCOMPRESSED, SNAPPY, GZIP = 0, 1, 2
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
#: page types
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
#: converted types read as timestamps, and the unit each means
_CONVERTED_TIMESTAMPS = {9: "ms", 10: "us"}
_UTF8 = 0
_UNITS = {1: "ms", 2: "us", 3: "ns"}
_UNIT_FIELDS = {unit: field for field, unit in _UNITS.items()}
_NS_PER_TICK = {"ms": 1_000_000, "us": 1_000, "ns": 1}
_PLAIN_DTYPES = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
_KINDS = {INT32: "int32", INT64: "int64", FLOAT: "float32", DOUBLE: "float64", BOOLEAN: "bool", BYTE_ARRAY: "string"}
INDEX_FIELD = "__index_level_0__"
#: a row group's rows a byte of the file at most: far above what the codecs
#: compress to (gzip's ~1000:1 over 8-byte values), so that a corrupt count
#: cannot ask for memory the file could not describe
_MAX_ROWS_PER_BYTE = 1024
CREATED_BY = "gordo_tpu_torch parquet writer"


class ParquetDecodeError(ValueError):
    """A parquet body or file that is malformed or holds what is not read
    (the routes answer 400)."""


class ParquetColumn(NamedTuple):
    """One column: its field ``name`` in the file, its ``values`` and its
    ``kind``: ``float64``, ``float32``, ``int64``, ``int32`` (float64 with
    NaN where it had nulls), ``bool`` (an object array when it had nulls),
    ``string`` (an object array, ``None`` for a null), ``null`` (all
    ``None``), ``range`` (a RangeIndex's positions) or ``timestamp``:
    int64 ticks of ``unit`` (``ms``, ``us``, ``ns``), since the UTC epoch
    when ``tz`` is set (``UTC``, or the zone the ``pandas`` metadata
    names), else wall-clock ticks; a null is ``np.iinfo(np.int64).min``
    (pandas' ``NaT``)."""

    name: Optional[str]
    values: np.ndarray
    kind: str
    unit: Optional[str] = None
    tz: Optional[str] = None


class ParquetTable(NamedTuple):
    """A file's columns in schema order and its key-value metadata."""

    columns: List[ParquetColumn]
    metadata: Dict[str, str]


class ParquetFrame(NamedTuple):
    """A file read as pandas would: the ``index`` (None when the file has
    no ``pandas`` metadata: positions), the column ``labels`` (tuples when
    the columns were two-level) and the ``columns`` in label order."""

    index: Optional[ParquetColumn]
    labels: List[Any]
    columns: List[ParquetColumn]


def _error(what: str) -> ParquetDecodeError:
    return ParquetDecodeError(f"Malformed parquet: {what}")


# -- the RLE/bit-packed hybrid ------------------------------------------------------------


def _uvarint(buf, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise _error("bad varint in an RLE run")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _unpack_bits(chunk: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian ``bit_width``-bit integers packed LSB first."""
    bits = np.unpackbits(chunk, bitorder="little")[: count * bit_width]
    weights = np.left_shift(np.uint64(1), np.arange(bit_width, dtype=np.uint64))
    return bits.reshape(count, bit_width).astype(np.uint64) @ weights


def decode_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid in ``buf[pos:end]``: runs
    of one value (an even varint header, the value in whole bytes) and
    bit-packed groups of eight (an odd header)."""
    if not 0 <= bit_width <= 32:
        raise _error(f"RLE bit width {bit_width}")
    out = np.zeros(count, np.int64)
    byte_width = (bit_width + 7) // 8
    filled = 0
    while filled < count:
        if pos >= end:
            raise _error(f"RLE data ends after {filled} of {count} values")
        header, pos = _uvarint(buf, pos)
        if header & 1:
            take = min((header >> 1) * 8, count - filled)
            if bit_width:
                needed = (take * bit_width + 7) // 8
                if pos + needed > end:
                    raise _error("truncated bit-packed run")
                out[filled: filled + take] = _unpack_bits(np.frombuffer(buf, np.uint8, needed, pos), bit_width, take)
            pos += (header >> 1) * bit_width
        else:
            take = min(header >> 1, count - filled)
            if pos + byte_width > end:
                raise _error("truncated RLE run")
            out[filled: filled + take] = int.from_bytes(bytes(buf[pos: pos + byte_width]), "little")
            pos += byte_width
        if not take and header >> 1 == 0:
            raise _error("empty RLE run")
        filled += take
    return out


def encode_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """``values`` as the hybrid: one RLE run when they are all equal, else
    one bit-packed run."""
    values = np.asarray(values, np.int64)
    n = len(values)
    if n and (values == values[0]).all():
        return _varint_bytes(n << 1) + int(values[0]).to_bytes((bit_width + 7) // 8, "little")
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    return _varint_bytes(groups << 1 | 1) + np.packbits(bits.ravel(), bitorder="little").tobytes()


def _varint_bytes(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


# -- reading ------------------------------------------------------------------------------


class _Leaf(NamedTuple):
    name: str
    physical: int
    optional: bool
    kind: str
    unit: Optional[str]
    utc: bool


def _leaf(element: Dict[int, Any]) -> _Leaf:
    """A flat column's schema element as what is read."""
    name = element.get(4, b"").decode()
    physical = element.get(1)
    repetition = element.get(3, REQUIRED)
    if repetition == REPEATED:
        raise ParquetDecodeError(f"Repeated column {name!r} is not read; the port reads flat columns")
    logical = element.get(10) or {}
    converted = element.get(6)
    if physical in (INT96, FIXED_LEN_BYTE_ARRAY) or physical not in _KINDS:
        type_name = _TYPE_NAMES[physical] if physical in range(8) else str(physical)
        raise ParquetDecodeError(f"Parquet type {type_name} of column {name!r} is not read")
    kind, unit, utc = _KINDS[physical], None, False
    if 8 in logical and physical == INT64:
        timestamp = logical[8]
        unit = next((_UNITS[k] for k in timestamp.get(2, {}) if k in _UNITS), None)
        if unit is None:
            raise ParquetDecodeError(f"Timestamp unit of column {name!r} is not read")
        kind, utc = "timestamp", bool(timestamp.get(1, False))
    elif converted in _CONVERTED_TIMESTAMPS and physical == INT64:
        kind, unit, utc = "timestamp", _CONVERTED_TIMESTAMPS[converted], True
    elif 11 in logical:
        kind = "null"
    elif physical == BYTE_ARRAY and not (1 in logical or 12 in logical or 4 in logical or converted in (_UTF8, 4, 19)):
        kind = "binary"
    return _Leaf(name, physical, repetition == OPTIONAL, kind, unit, utc)


def _decompress(codec: int, data, size: int, column: str) -> bytes:
    if codec == UNCOMPRESSED:
        return bytes(data)
    try:
        if codec == SNAPPY:
            out = snappy.decompress(data)
        elif codec == GZIP:
            out = zlib.decompressobj(47).decompress(bytes(data), size + 1)  # gzip or zlib framing, bounded
        else:
            raise ParquetDecodeError(
                f"Compression codec {_CODEC_NAMES.get(codec, codec)} of column {column!r} is not read; "
                "the port reads UNCOMPRESSED, SNAPPY and GZIP")
    except (snappy.SnappyError, zlib.error) as exc:
        raise _error(f"column {column!r}: {exc}") from None
    if len(out) != size:
        raise _error(f"column {column!r}: a page decompressed to {len(out)} bytes, not {size}")
    return out


def _plain(leaf: _Leaf, data, pos: int, end: int, count: int) -> np.ndarray:
    """``count`` PLAIN values of ``leaf``'s physical type."""
    if leaf.physical == BOOLEAN:
        if pos + (count + 7) // 8 > end:
            raise _error(f"column {leaf.name!r}: boolean page too short")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, (count + 7) // 8, pos), bitorder="little")
        return bits[:count].astype(bool)
    if leaf.physical == BYTE_ARRAY:
        if count * 4 > end - pos:  # a length prefix a value at least
            raise _error(f"column {leaf.name!r}: {count} strings in {end - pos} bytes")
        out = np.empty(count, object)
        view = memoryview(data)
        for i in range(count):
            if pos + 4 > end:
                raise _error(f"column {leaf.name!r}: string page too short")
            (size,) = struct.unpack_from("<i", view, pos)
            pos += 4
            if size < 0 or pos + size > end:
                raise _error(f"column {leaf.name!r}: string runs past its page")
            out[i] = bytes(view[pos: pos + size])
            pos += size
        return out
    dtype = np.dtype(_PLAIN_DTYPES[leaf.physical])
    if pos + count * dtype.itemsize > end:
        raise _error(f"column {leaf.name!r}: page holds fewer than its {count} values")
    return np.frombuffer(data, dtype, count, pos)


def _values(leaf: _Leaf, encoding: int, data, pos: int, end: int, count: int,
            dictionary: Optional[np.ndarray]) -> np.ndarray:
    """A data page's ``count`` non-null values."""
    if encoding == PLAIN:
        return _plain(leaf, data, pos, end, count)
    if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise _error(f"column {leaf.name!r}: dictionary-encoded page without a dictionary page")
        if not count:
            return dictionary[:0]
        if pos >= end:
            raise _error(f"column {leaf.name!r}: dictionary page without indices")
        indices = decode_hybrid(data, pos + 1, end, data[pos], count)
        if len(indices) and (indices.min() < 0 or indices.max() >= len(dictionary)):
            raise _error(f"column {leaf.name!r}: dictionary index out of range")
        return dictionary[indices]
    if encoding == RLE and leaf.physical == BOOLEAN:
        (size,) = struct.unpack_from("<i", data, pos)
        return decode_hybrid(data, pos + 4, min(end, pos + 4 + size), 1, count).astype(bool)
    raise ParquetDecodeError(
        f"Encoding {_ENCODING_NAMES.get(encoding, encoding)} of column {leaf.name!r} is not read; "
        "the port reads PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY and RLE")


def _levels(leaf: _Leaf, data, pos: int, end: int, count: int, encoding: int) -> np.ndarray:
    if encoding != RLE:
        raise ParquetDecodeError(
            f"Definition levels of column {leaf.name!r} in {_ENCODING_NAMES.get(encoding, encoding)} are not read")
    return decode_hybrid(data, pos, end, 1, count)


def _chunk(buf: memoryview, leaf: _Leaf, meta: Dict[int, Any],
           rows: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One column chunk of a row group of ``rows`` rows: its non-null
    values and, for an optional column, each row's definition level."""
    codec = meta.get(4, UNCOMPRESSED)
    total = meta.get(5, 0)
    if total != rows:
        raise _error(f"column {leaf.name!r} holds {total} values in a row group of {rows} rows")
    start = meta.get(9, 0)
    if meta.get(11) is not None and 0 < meta[11] < start:
        start = meta[11]
    pos = start
    dictionary: Optional[np.ndarray] = None
    values: List[np.ndarray] = []
    levels: List[np.ndarray] = []
    seen = 0
    while seen < total:
        try:
            header, pos = read_struct(buf, pos)
        except ThriftError as exc:
            raise _error(f"column {leaf.name!r}: page header: {exc}") from None
        kind, size, compressed = header.get(1), header.get(2, 0), header.get(3, 0)
        count = (header.get(5) or header.get(8) or {}).get(1, 0)
        if kind in (DATA_PAGE, DATA_PAGE_V2) and not 0 <= count <= total - seen:
            raise _error(f"column {leaf.name!r}: a page of {count} values past the chunk's {total}")
        if compressed < 0 or pos + compressed > len(buf):
            raise _error(f"column {leaf.name!r}: page runs past the file")
        body = buf[pos: pos + compressed]
        pos += compressed
        if kind == DICTIONARY_PAGE:
            page = header.get(7, {})
            if page.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ParquetDecodeError(f"Dictionary encoding of column {leaf.name!r} is not read")
            data = _decompress(codec, body, size, leaf.name)
            dictionary = _plain(leaf, data, 0, len(data), page.get(1, 0))
            continue
        if kind == DATA_PAGE:
            page = header.get(5, {})
            data = _decompress(codec, body, size, leaf.name)
            at, end = 0, len(data)
            defined = count
            if leaf.optional:
                if page.get(3, RLE) != RLE:
                    raise ParquetDecodeError(f"Definition levels of column {leaf.name!r} in "
                                             f"{_ENCODING_NAMES.get(page.get(3), page.get(3))} are not read")
                (length,) = struct.unpack_from("<i", data, 0)
                level = _levels(leaf, data, 4, 4 + length, count, RLE)
                at = 4 + length
                levels.append(level)
                defined = int(level.sum())
            values.append(_values(leaf, page.get(2, PLAIN), data, at, end, defined, dictionary))
        elif kind == DATA_PAGE_V2:
            page = header.get(8, {})
            nulls = page.get(2, 0)
            def_length, rep_length = page.get(5, 0), page.get(6, 0)
            if rep_length:
                raise ParquetDecodeError(f"Repetition levels of column {leaf.name!r} are not read")
            if def_length < 0 or def_length > len(body):
                raise _error(f"column {leaf.name!r}: level lengths past the page")
            if leaf.optional:
                level = decode_hybrid(body, 0, def_length, 1, count) if def_length else np.ones(count, np.int64)
                levels.append(level)
            rest = body[def_length:]
            if page.get(7, True):
                data = _decompress(codec, rest, size - def_length, leaf.name)
            else:
                data = bytes(rest)
            values.append(_values(leaf, page.get(4, PLAIN), data, 0, len(data), count - nulls, dictionary))
        elif kind == INDEX_PAGE:
            continue
        else:
            raise _error(f"column {leaf.name!r}: page type {kind}")
        seen += count
    merged = np.concatenate(values) if values else _plain(leaf, b"", 0, 0, 0)
    return merged, (np.concatenate(levels) if leaf.optional and levels else None)


def _with_nulls(leaf: _Leaf, values: np.ndarray, levels: Optional[np.ndarray], rows: int) -> np.ndarray:
    """The column's ``rows`` values with its nulls put back."""
    if leaf.kind in ("string", "binary"):
        values = np.array([v.decode() for v in values] if leaf.kind == "string" else list(values), object)
    if leaf.kind == "null":
        return np.full(rows, None, object)
    if levels is None or levels.all():
        if len(values) != rows:
            raise _error(f"column {leaf.name!r} holds {len(values)} values for {rows} rows")
        return values
    present = levels.astype(bool)
    if int(present.sum()) != len(values) or len(present) != rows:
        raise _error(f"column {leaf.name!r}: levels and values disagree")
    if leaf.kind in ("string", "binary", "bool"):
        out = np.full(rows, None, object)
    elif leaf.kind == "timestamp":
        out = np.full(rows, np.iinfo(np.int64).min, np.int64)
    else:  # ints with nulls become float64 with NaN, as pandas makes them
        out = np.full(rows, np.nan, np.float32 if leaf.kind == "float32" else np.float64)
    out[present] = values
    return out


def read_table(data) -> ParquetTable:
    """Every column of a parquet file (``bytes`` or a buffer) and its
    key-value metadata; :class:`ParquetDecodeError` for what is malformed
    or not read."""
    try:
        return _read_table(memoryview(data))
    except ParquetDecodeError:
        raise
    except (struct.error, ValueError, TypeError, IndexError, KeyError, AttributeError, OverflowError) as exc:
        raise _error(f"{type(exc).__name__}: {exc}") from None  # garbage sizes, offsets or text


def _read_table(buf: memoryview) -> ParquetTable:
    if len(buf) < 12 or bytes(buf[:4]) != MAGIC or bytes(buf[-4:]) != MAGIC:
        raise ParquetDecodeError("Not a parquet file (no PAR1 magic)")
    (footer_length,) = struct.unpack_from("<I", buf, len(buf) - 8)
    if footer_length + 12 > len(buf):
        raise _error("footer length past the file")
    try:
        meta, _ = read_struct(buf, len(buf) - 8 - footer_length)
    except ThriftError as exc:
        raise _error(f"footer: {exc}") from None
    schema = meta.get(2) or []
    if not schema:
        raise _error("no schema")
    leaves: List[_Leaf] = []
    for element in schema[1:]:
        if element.get(5):
            name = element.get(4, b"").decode()
            raise ParquetDecodeError(f"Nested column {name!r} is not read; the port reads flat columns")
        leaves.append(_leaf(element))
    if schema[0].get(5, len(leaves)) != len(leaves):
        raise ParquetDecodeError("Nested columns are not read; the port reads flat columns")
    parts: List[List[np.ndarray]] = [[] for _ in leaves]
    for group in meta.get(4) or []:
        chunks = group.get(1) or []
        rows = group.get(3, 0)
        if not 0 <= rows <= _MAX_ROWS_PER_BYTE * len(buf):
            raise _error(f"a row group of {rows} rows in {len(buf)} bytes")
        if len(chunks) != len(leaves):
            raise _error(f"a row group of {len(chunks)} columns for {len(leaves)}")
        for i, (leaf, chunk) in enumerate(zip(leaves, chunks)):
            if chunk.get(1):
                raise ParquetDecodeError(f"Column {leaf.name!r} lies in another file; the port reads one file")
            values, levels = _chunk(buf, leaf, chunk.get(3) or {}, rows)
            parts[i].append(_with_nulls(leaf, values, levels, rows))
    columns = []
    for leaf, pieces in zip(leaves, parts):
        if pieces:
            values = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
        else:
            values = np.zeros(0, object if leaf.kind in ("string", "binary", "null") else np.float64)
        columns.append(ParquetColumn(leaf.name, values, leaf.kind, leaf.unit, "UTC" if leaf.utc else None))
    metadata = {(kv.get(1) or b"").decode(): (kv.get(2) or b"").decode() for kv in meta.get(5) or []}
    return ParquetTable(columns, metadata)


def _label(name: Optional[str], levels: int) -> Any:
    """A column's label: the stringified tuple of a two-level label read
    back as the tuple."""
    if levels > 1 and isinstance(name, str) and name.startswith("("):
        try:
            value = ast.literal_eval(name)
        except (ValueError, SyntaxError):
            return name
        if isinstance(value, tuple):
            return value
    return name


def read_frame(data) -> ParquetFrame:
    """A parquet file as pandas' ``read_parquet`` frames it (see the
    module's docstring)."""
    table = read_table(data)
    raw = table.metadata.get("pandas")
    if not raw:
        return ParquetFrame(None, [c.name for c in table.columns], list(table.columns))
    try:
        return _pandas_frame(table, json.loads(raw))
    except ParquetDecodeError:
        raise
    except (ValueError, TypeError, AttributeError) as exc:
        raise _error(f"the pandas metadata: {type(exc).__name__}: {exc}") from None


def _pandas_frame(table: ParquetTable, pandas_meta: Dict[str, Any]) -> ParquetFrame:
    by_field = {entry.get("field_name", entry.get("name")): entry for entry in pandas_meta.get("columns") or []}
    levels = len(pandas_meta.get("column_indexes") or [None])
    columns = []
    for column in table.columns:
        entry = by_field.get(column.name) or {}
        zone = (entry.get("metadata") or {}).get("timezone")
        if column.kind == "timestamp" and zone and column.tz:
            column = column._replace(tz=zone)
        columns.append(column)
    descriptors = pandas_meta.get("index_columns") or []
    if len(descriptors) > 1:
        raise ParquetDecodeError("A MultiIndex row index is not read")
    index, kept = None, columns
    for descriptor in descriptors:
        if isinstance(descriptor, dict) and descriptor.get("kind") == "range":
            rows = len(columns[0].values) if columns else 0
            start, step = int(descriptor.get("start", 0)), int(descriptor.get("step", 1))
            index = ParquetColumn(descriptor.get("name"), start + step * np.arange(rows, dtype=np.int64), "range")
        elif isinstance(descriptor, str):
            index = next((c for c in columns if c.name == descriptor), None)
            kept = [c for c in columns if c.name != descriptor]
    labels = [_label((by_field.get(c.name) or {}).get("name", c.name), levels) for c in kept]
    return ParquetFrame(index, labels, kept)


def timestamp_ns(column: ParquetColumn) -> np.ndarray:
    """A timestamp column's ticks as int64 nanoseconds (UTC for an aware
    column)."""
    return np.asarray(column.values, np.int64) * _NS_PER_TICK[column.unit]


# -- writing ------------------------------------------------------------------------------


class _Spec(NamedTuple):
    """A column to write: its schema element, its pandas entry and its Arrow
    type, and the page's values (non-null), levels and count."""

    physical: int
    logical: Optional[list]
    converted: Optional[int]
    plain: bytes
    levels: np.ndarray
    pandas_type: str
    numpy_type: str
    arrow: tuple


def _column_spec(values: Any, unit: Optional[str] = None, tz: Optional[str] = None) -> _Spec:
    """One column: a numpy array (float64, float32, int64, int32, bool),
    int64 ticks of ``unit`` (a timestamp: since the UTC epoch when ``tz``
    is set), or a sequence of strings and ``None``."""
    if unit is not None:
        ticks = np.asarray(values, "<i8")
        logical = [(8, "struct", [(1, "bool", tz is not None), (2, "struct", [(_UNIT_FIELDS[unit], "struct", [])])])]
        return _Spec(INT64, logical, None, ticks.tobytes(), np.ones(len(ticks), np.int64),
                     "datetimetz" if tz is not None else "datetime", f"datetime64[{unit}]", ("timestamp", unit, tz))
    if isinstance(values, np.ndarray) and values.dtype.kind in "fiub":
        data = values
        if data.dtype.kind == "f":
            present = ~np.isnan(data)
            physical = DOUBLE if data.dtype.itemsize == 8 else FLOAT
            data = data.astype(np.float64 if physical == DOUBLE else np.float32, copy=False)
            arrow = ("float", 2 if physical == DOUBLE else 1)
        elif data.dtype.kind == "b":
            present = np.ones(len(data), bool)
            return _Spec(BOOLEAN, None, None, np.packbits(data, bitorder="little").tobytes(),
                         present.astype(np.int64), "bool", "bool", ("bool",))
        else:
            present = np.ones(len(data), bool)
            physical = INT64 if data.dtype.itemsize == 8 else INT32
            data = data.astype(np.int64 if physical == INT64 else np.int32, copy=False)
            arrow = ("int", 64 if physical == INT64 else 32, True)
        name = str(data.dtype)
        plain = data[present].astype(data.dtype.newbyteorder("<"), copy=False).tobytes()
        return _Spec(physical, None, None, plain, present.astype(np.int64), name, name, arrow)
    items = list(values)
    present = np.array([v is not None for v in items], bool)
    if not present.any():
        return _Spec(INT32, [(11, "struct", [])], None, b"", np.zeros(len(items), np.int64), "empty", "object",
                     ("null",))
    if not all(isinstance(v, str) for v in items if v is not None):
        raise TypeError(f"Column values are neither numeric arrays nor strings: {items[:3]}")
    encoded = [v.encode() for v in items if v is not None]
    lengths = np.array([len(e) for e in encoded], "<i4")
    parts = np.empty(2 * len(encoded), object)
    parts[0::2] = [length.tobytes() for length in lengths]
    parts[1::2] = encoded
    return _Spec(BYTE_ARRAY, [(1, "struct", [])], _UTF8, b"".join(parts), present.astype(np.int64), "object", "str",
                 ("large_utf8",))


def _pandas_entry(name: Optional[str], field: str, spec: _Spec, tz: Optional[str]) -> dict:
    return {"name": name, "field_name": field, "pandas_type": spec.pandas_type, "numpy_type": spec.numpy_type,
            "metadata": {"timezone": tz} if tz is not None else None}


def _column_index(levels: int) -> List[dict]:
    return [{"name": None, "field_name": None, "pandas_type": "unicode", "numpy_type": "str",
             "metadata": {"encoding": "UTF-8"}} for _ in range(levels)]


def write_frame(labels: Sequence[Any], columns: Sequence[Any], index: Any = None, index_unit: Optional[str] = "us",
                index_tz: Optional[str] = None) -> bytes:
    """A frame as a parquet file (see the module's docstring).

    ``labels`` are the column labels (strings, or ``(group, sub)`` tuples
    for two-level columns, stored as their ``str``), ``columns`` their
    values (:func:`_column_spec`'s forms). ``index`` is int64 ticks of
    ``index_unit`` (since the UTC epoch when ``index_tz`` names a zone,
    else wall-clock; plain int64 values when ``index_unit`` is None), a
    RangeIndex's ``("range", start, step)``, or None for a RangeIndex
    from 0."""
    levels = 2 if any(isinstance(label, tuple) for label in labels) else 1
    names = [str(label) if isinstance(label, tuple) else label for label in labels]
    specs = [_column_spec(values) for values in columns]
    rows = len(specs[0].levels) if specs else 0
    fields = list(zip(names, specs, [None] * len(specs)))
    index_columns: List[Any]
    if index is None or (isinstance(index, tuple) and index[0] == "range"):
        start, step = (0, 1) if index is None else (int(index[1]), int(index[2]))
        index_columns = [{"kind": "range", "name": None, "start": start, "stop": start + step * rows, "step": step}]
    else:
        spec = _column_spec(np.asarray(index, np.int64)) if index_unit is None else _column_spec(
            index, index_unit, index_tz)
        fields.append((INDEX_FIELD, spec, index_tz))
        index_columns = [INDEX_FIELD]
    pandas_meta = {
        "index_columns": index_columns,
        "column_indexes": _column_index(levels),
        "columns": [_pandas_entry(None if field == INDEX_FIELD else field, field, spec, tz)
                    for field, spec, tz in fields],
        "attributes": {},
        "creator": {"library": "gordo_tpu_torch", "version": "1"},
        "pandas_version": "3.0.0",
    }
    pandas_text = json.dumps(pandas_meta)
    out = bytearray(MAGIC)
    chunks = []
    for field, spec, _ in fields:
        present = spec.levels.astype(bool)
        defined = encode_hybrid(spec.levels, 1)
        page = struct.pack("<i", len(defined)) + defined + spec.plain
        body = snappy.compress(page)
        header = write_struct([
            (1, "i32", DATA_PAGE), (2, "i32", len(page)), (3, "i32", len(body)),
            (5, "struct", [(1, "i32", rows), (2, "i32", PLAIN), (3, "i32", RLE), (4, "i32", RLE)]),
        ])
        offset = len(out)
        out += header + body
        meta = [
            (1, "i32", spec.physical), (2, ("list", "i32"), [PLAIN, RLE]), (3, ("list", "binary"), [field]),
            (4, "i32", SNAPPY), (5, "i64", rows), (6, "i64", len(header) + len(page)),
            (7, "i64", len(header) + len(body)), (9, "i64", offset),
            (12, "struct", [(3, "i64", int(rows - present.sum()))]),
        ]
        chunks.append(([(2, "i64", offset), (3, "struct", meta)], len(header) + len(page)))
    schema = [[(4, "binary", "schema"), (5, "i32", len(fields))]]
    for field, spec, _ in fields:
        element = [(1, "i32", spec.physical), (3, "i32", OPTIONAL), (4, "binary", field)]
        if spec.converted is not None:
            element.append((6, "i32", spec.converted))
        if spec.logical is not None:
            element.append((10, "struct", spec.logical))
        schema.append(element)
    arrow_schema = _arrow_schema([(field, spec.arrow) for field, spec, _ in fields], pandas_text)
    footer = write_struct([
        (1, "i32", 2),
        (2, ("list", "struct"), schema),
        (3, "i64", rows),
        (4, ("list", "struct"), [[
            (1, ("list", "struct"), [chunk for chunk, _ in chunks]),
            (2, "i64", sum(size for _, size in chunks)),
            (3, "i64", rows),
        ]]),
        (5, ("list", "struct"), [[(1, "binary", "pandas"), (2, "binary", pandas_text)],
                                 [(1, "binary", "ARROW:schema"), (2, "binary", arrow_schema)]]),
        (6, "binary", CREATED_BY),
    ])
    out += footer + struct.pack("<I", len(footer)) + MAGIC
    return bytes(out)


def _arrow_schema(fields: List[Tuple[str, tuple]], pandas_text: str) -> bytes:
    """The ``ARROW:schema`` value: the Arrow IPC schema message, base64."""
    from ..server.wire.arrow_codec import arrow_schema_message

    return base64.b64encode(arrow_schema_message(fields, {b"pandas": pandas_text.encode()}))
