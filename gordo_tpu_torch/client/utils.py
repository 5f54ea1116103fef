"""
The client's frames (``gordo_tpu/client/utils.py``), in numpy: one
machine's result (:class:`PredictionResult`), and the wire's frames both
ways. A request frame is the port's ``json_codec.Frame`` (``index``,
``columns``, ``values``); an answer is a ``WireTable`` of ``(group,
sub)`` columns, where the JAX client has a pandas frame of two-level
columns:

- a JSON answer's ``data`` reads as the JAX client's
  ``dataframe_from_dict`` reads it: every ``{group: {sub: {key: value}}}``
  column under its ``(group, sub)``, so a scalar group such as
  ``total-anomaly-scaled`` is ``(group, group)``, rows sorted by time;
- a parquet or Arrow answer keeps the labels its file gives (a scalar
  group's sub is ``""``).
"""

import math
from collections import namedtuple
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..server.wire import ARROW_CONTENT_TYPE, Frame, WireColumn, WireTable, decode_response, encode_request
from ..server.wire.json_codec import _parse_index
from ..server.wire.assemble import index_wire_keys

__all__ = [
    "ARROW_CONTENT_TYPE", "PredictionResult", "arrow_response_with_meta", "concat_tables",
    "dataframe_from_arrow_bytes", "dataframe_into_arrow_bytes", "frame_to_dict", "table_from_dict",
]

PredictionResult = namedtuple("PredictionResult", "name predictions error_messages")


def dataframe_into_arrow_bytes(X: Frame, y: Optional[Frame] = None) -> bytes:
    """``X`` (and ``y``) as one Arrow IPC stream of role-tagged columns."""
    return encode_request(X, y)


def dataframe_from_arrow_bytes(buf: bytes) -> WireTable:
    """An Arrow answer as a table (the envelope dropped)."""
    return arrow_response_with_meta(buf)[0]


def arrow_response_with_meta(buf: bytes) -> Tuple[WireTable, dict]:
    """An Arrow answer as ``(table, envelope)``: the envelope holds the
    scalar fields (``revision``, ``time-seconds``)."""
    return decode_response(buf)


def _cell(value: Any) -> Any:
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def frame_to_dict(frame: Frame) -> Dict[str, Dict[str, Any]]:
    """A request frame as ``{column: {index-key: value}}`` (``NaN`` as
    null), the index keys as the JAX client writes them."""
    keys = index_wire_keys(frame.index)
    values = np.asarray(frame.values, np.float64)
    return {str(name): dict(zip(keys, map(_cell, values[:, j].tolist()))) for j, name in enumerate(frame.columns)}


def table_from_dict(data: Dict[str, Any]) -> WireTable:
    """A JSON answer's ``data`` as a table, rows sorted by time (see the
    module's docstring); a flat ``{column: {key: value}}`` document gives
    columns ``(column, "")``."""
    seen: Dict[str, None] = {}
    leaves: List[Tuple[str, str, Dict[str, Any]]] = []
    for group, value in data.items():
        subs = value.items() if value and all(isinstance(v, dict) for v in value.values()) else [("", value)]
        for sub, series in subs:
            leaves.append((str(group), str(sub), series))
            seen.update(dict.fromkeys(series))
    raw = list(seen)
    index = _parse_index(raw) if raw else []
    order = sorted(range(len(raw)), key=index.__getitem__)
    columns = []
    for group, sub, series in leaves:
        cells = [series.get(raw[i]) for i in order]
        if all(c is None or isinstance(c, (int, float)) for c in cells) and any(c is not None for c in cells):
            values: Any = np.array([np.nan if c is None else c for c in cells], np.float64)
        else:
            values = np.array(cells, dtype=object)
        columns.append(WireColumn(group, sub, values))
    return WireTable([index[i] for i in order], columns)


def concat_tables(tables: Sequence[WireTable], sort: bool = True) -> WireTable:
    """Tables one after another, rows sorted by index (stable; with
    ``sort`` False, in the tables' order), columns by label in the order
    they first appear; a table without a column fills it with NaN (None
    where the column holds strings)."""
    labels: Dict[Tuple[str, str], None] = {}
    for table in tables:
        labels.update(dict.fromkeys((c.group, c.sub) for c in table.columns))
    index = [i for table in tables for i in table.index]
    order = sorted(range(len(index)), key=index.__getitem__) if sort else list(range(len(index)))
    columns = []
    for label in labels:
        parts = []
        for table in tables:
            found = [c.values for c in table.columns if (c.group, c.sub) == label]
            parts.append(np.asarray(found[0]) if found else None)
        filler_object = any(p is not None and p.dtype == object for p in parts)
        parts = [p if p is not None else np.full(len(t.index), None if filler_object else np.nan,
                                                 object if filler_object else np.float64)
                 for p, t in zip(parts, tables)]
        values = np.concatenate(parts) if parts else np.array([])
        columns.append(WireColumn(label[0], label[1], values[order]))
    unit = tables[0].unit if tables else None
    return WireTable([index[i] for i in order], columns, unit)

