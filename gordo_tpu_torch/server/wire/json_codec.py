"""
The JSON wire format: request frames in, columnar responses out.

Requests carry frames as ``{tag: {index-key: value}}``. :func:`decode_frame`
reads one the way the JAX server's ``dataframe_from_dict`` does
(``gordo_tpu/server/utils.py:177-212``): index keys parse as ISO
datetimes, else as integers, and rows are sorted by them; a value that is
missing or null is NaN. :func:`verify_frame` aligns its columns with the
model's tags (``verify_dataframe``).

Responses are written straight from a :class:`~.assemble.WireTable`, as
``{"data": {group: {sub: {index-key: value}}}, ...}`` with ``json.dumps``'
separators, non-finite floats as ``null``, and floats as ``repr`` writes
them, so the bytes match the JAX server's columnar encoder
(``gordo_tpu/server/wire/json_codec.py``).
"""

import json
import math
from datetime import datetime
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .assemble import WireTable

_ITEM_SEP = ", "
_KEY_SEP = ": "


class FrameError(ValueError):
    """A request frame that cannot be read or does not fit the model."""


class Frame:
    """A decoded request frame: ``index`` (sorted datetimes or ints),
    ``columns`` (names) and ``values`` (``[rows, columns]``: float64 from
    JSON, the columns' own dtype from Arrow); ``unit`` is a datetime
    index's Arrow timestamp unit (None: ``us``, the ISO parse's). A frame
    made from decoded columns (``arrays``) keeps them unstacked until its
    ``values`` are first read, so that a request whose columns go to the
    device as they are (``ingest.RawColumns``) and into the answer column
    by column (:meth:`arrays`) is never stacked on the host."""

    __slots__ = ("index", "columns", "unit", "_values", "_arrays")

    def __init__(self, index: List[Any], columns: List[str], values: Optional[np.ndarray] = None,
                 unit: Optional[str] = None, arrays: Optional[List[np.ndarray]] = None):
        self.index = index
        self.columns = columns
        self.unit = unit
        self._values = values
        self._arrays = arrays

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            self._values = np.column_stack(self._arrays)
        return self._values

    def arrays(self) -> List[np.ndarray]:
        """The columns one by one in ``values``' dtype: the decoded columns
        themselves while the frame is unstacked, else views of ``values``."""
        if self._values is None:
            dtype = np.result_type(*self._arrays)
            return [np.asarray(a, dtype) for a in self._arrays]
        return [self._values[:, j] for j in range(self._values.shape[1])]

    def take(self, positions: Sequence[int], columns: List[str]) -> "Frame":
        """The columns at ``positions``, named ``columns``."""
        if self._values is None:
            return Frame(self.index, columns, None, self.unit, [self._arrays[p] for p in positions])
        return Frame(self.index, columns, self._values[:, positions], self.unit)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, rows: slice) -> "Frame":
        """The rows ``rows`` (a slice) as a frame sharing ``values``."""
        if self._values is None:
            return Frame(self.index[rows], self.columns, None, self.unit, [a[rows] for a in self._arrays])
        return Frame(self.index[rows], self.columns, self._values[rows], self.unit)


def _parse_index(keys: Sequence[str]) -> List[Any]:
    """ISO datetimes when every key parses as one, else integers."""
    try:
        parsed = [datetime.fromisoformat(str(k)) for k in keys]
    except ValueError:
        try:
            return [int(k) for k in keys]
        except (TypeError, ValueError):
            raise FrameError(f"Index keys are neither ISO datetimes nor integers: {list(keys)[:3]}")
    aware = {dt.utcoffset() is not None for dt in parsed}
    if len(aware) > 1:
        raise FrameError("Index mixes timezone-aware and naive datetimes")
    if len({dt.utcoffset() for dt in parsed}) > 1:
        raise FrameError("Index mixes UTC offsets")
    return parsed


def _column(values: Sequence[Any]) -> np.ndarray:
    """One column's cells as float64 (null -> NaN)."""
    try:
        return np.asarray(values, dtype=np.float64).reshape(len(values))
    except (TypeError, ValueError):
        raise FrameError(f"Non-numeric values in column: {list(values)[:3]}")


def decode_frame(data: Any) -> Frame:
    """A frame from ``{column: {index-key: value}}`` (or ``{column: [values]}``
    with a positional index), rows sorted by index."""
    if not isinstance(data, dict) or not data:
        raise FrameError("A frame is a non-empty {column: {index: value}} object")
    columns = [str(c) for c in data]
    series = list(data.values())
    if all(isinstance(s, list) for s in series):
        index: List[Any] = list(range(max(len(s) for s in series)))
        values = np.full((len(index), len(columns)), np.nan)
        for j, s in enumerate(series):
            values[: len(s), j] = _column(s)
        return Frame(index, columns, values)
    if not all(isinstance(s, dict) for s in series):
        raise FrameError("Frame columns must all be objects or all be lists")
    if any(isinstance(v, dict) for s in series for v in s.values()):
        raise FrameError("Server does not support multi-level frames")
    seen: Dict[str, None] = {}
    for s in series:
        seen.update(dict.fromkeys(s))
    raw_keys = list(seen)
    keys = _parse_index(raw_keys)
    order = sorted(range(len(keys)), key=keys.__getitem__)
    row_of = {raw_keys[i]: row for row, i in enumerate(order)}
    values = np.full((len(keys), len(columns)), np.nan)
    for j, s in enumerate(series):
        values[[row_of[k] for k in s], j] = _column(list(s.values()))
    return Frame([keys[i] for i in order], columns, values)


def verify_frame(frame: Frame, expected: Sequence[str]) -> Frame:
    """The frame's columns in the model's tag order: named columns are
    selected (extras dropped); a frame of exactly the right width whose
    names differ is renamed positionally; anything else is refused."""
    expected = list(expected)
    if all(name in frame.columns for name in expected):
        return frame.take([frame.columns.index(name) for name in expected], expected)
    if len(frame.columns) != len(expected):
        raise FrameError(
            f"Unexpected features: was expecting {expected} length of "
            f"{len(expected)}, but got {frame.columns} length of {len(frame.columns)}"
        )
    return Frame(frame.index, expected, frame._values, frame.unit, frame._arrays)


def _value_literal(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, float):
        return float.__repr__(value) if math.isfinite(value) else "null"
    return json.dumps(value)


def column_literals(values: Any) -> List[str]:
    """Every cell of one column as a JSON literal (NaN/inf as null)."""
    if isinstance(values, np.ndarray) and values.dtype.kind == "f":
        literals = [float.__repr__(v) for v in values.tolist()]
        finite = np.isfinite(values)
        if not finite.all():
            literals = [lit if ok else "null" for lit, ok in zip(literals, finite.tolist())]
        return literals
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return [_value_literal(v) for v in values]


def _object(keys_prefixes: List[str], literals: List[str]) -> str:
    return "{" + _ITEM_SEP.join(p + lit for p, lit in zip(keys_prefixes, literals)) + "}"


def _prefixes(keys: Sequence[str]) -> List[str]:
    return [json.dumps(str(k)) + _KEY_SEP for k in keys]


def encode_table(table: WireTable) -> Iterator[str]:
    """``{group: {sub: {key: value}}}``, one chunk per column group; a
    group's scalar column nests under the group's own name."""
    prefixes = _prefixes(table.keys)
    yield "{"
    for i, (group, bucket) in enumerate(table.groups()):
        subs = _ITEM_SEP.join(
            json.dumps(c.sub or c.group) + _KEY_SEP + _object(prefixes, column_literals(c.values))
            for c in bucket
        )
        yield ("" if i == 0 else _ITEM_SEP) + json.dumps(group) + _KEY_SEP + "{" + subs + "}"
    yield "}"


def encode_lean_entry(keys: Sequence[str], recon: np.ndarray, mse: np.ndarray) -> str:
    """The fleet route's lean entry: ``{"model-output": {"0": {...}, ...},
    "total-anomaly-unscaled": {key: value}}``."""
    prefixes = _prefixes(keys)
    outputs = _ITEM_SEP.join(
        f'"{col}"' + _KEY_SEP + _object(prefixes, column_literals(recon[:, col]))
        for col in range(recon.shape[1])
    )
    return (
        '{"model-output"' + _KEY_SEP + "{" + outputs + "}" + _ITEM_SEP
        + '"total-anomaly-unscaled"' + _KEY_SEP + _object(prefixes, column_literals(np.asarray(mse)))
        + "}"
    )


def dumps(value: Any) -> str:
    """Plain JSON for small envelopes (errors, messages): non-finite
    floats become null, anything else unknown becomes its ``str``."""

    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    return json.dumps(clean(value), default=str)


def encode_response(table: WireTable, extra: Optional[Dict[str, Any]] = None) -> bytes:
    """``{"data": <table>, **extra}`` as UTF-8 bytes."""
    parts = ['{"data"' + _KEY_SEP, *encode_table(table)]
    for key, value in (extra or {}).items():
        parts.append(_ITEM_SEP + json.dumps(key) + _KEY_SEP + dumps(value))
    parts.append("}")
    return "".join(parts).encode()


def encode_fleet_response(
    entries: Dict[str, str], errors: Dict[str, Any], revision: Optional[str]
) -> bytes:
    """The fleet route's body: ``{"data": {name: entry}, "errors"?: ...,
    "revision": ...}`` from pre-encoded entries."""
    data = _ITEM_SEP.join(json.dumps(name) + _KEY_SEP + entry for name, entry in entries.items())
    body = '{"data"' + _KEY_SEP + "{" + data + "}"
    if errors:
        body += _ITEM_SEP + '"errors"' + _KEY_SEP + dumps(errors)
    if revision is not None:
        body += _ITEM_SEP + '"revision"' + _KEY_SEP + json.dumps(revision)
    return (body + "}").encode()
