"""
The parquet wire format: the port's frames to and from the parquet bytes
of ``utils/parquet.py``, the counterparts of the JAX server's
``dataframe_into_parquet_bytes`` and ``dataframe_from_parquet_bytes``
(``gordo_tpu/server/utils.py``, pyarrow).

- :func:`dataframe_from_parquet_bytes`: a request body (a raw
  ``application/x-parquet`` body, or a multipart upload's ``X``/``y``
  file) as a ``json_codec.Frame``: the pandas index as datetimes with
  their unit (``arrow_codec.index_from_ticks``) or ints, the columns by
  name in the file's order and dtype. Rows keep the file's order, as the
  JAX server keeps the frame's.
- :func:`dataframe_into_parquet_bytes`: a response table as the frame
  the JAX server writes (``WireTable.to_frame()``: two-level
  ``(group, sub)`` columns over the request's index and unit), a flat
  one (``flat``: the client's sinks and ``score``), or a request frame
  with flat columns; SNAPPY pages.
- :func:`table_from_parquet_bytes`: a response read back as a
  ``WireTable`` (the client's decoder, and the checks').

A body that is malformed or holds what the codec does not read raises
``ParquetDecodeError`` (a ``ValueError``; the routes answer 400).
"""

from datetime import datetime
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from ...utils import parquet
from ...utils.parquet import CONTENT_TYPE as PARQUET_CONTENT_TYPE
from ...utils.parquet import ParquetDecodeError
from .arrow_codec import ArrowDecodeError, index_from_ticks, timestamp_ticks
from .assemble import WireColumn, WireTable
from .json_codec import Frame, FrameError

#: the JAX server answers parquet as a file download (``file_response``)
PARQUET_RESPONSE_CONTENT_TYPE = "application/octet-stream"

__all__ = [
    "PARQUET_CONTENT_TYPE", "PARQUET_RESPONSE_CONTENT_TYPE", "ParquetDecodeError", "dataframe_from_parquet_bytes",
    "dataframe_into_parquet_bytes", "parquet_columns", "table_from_parquet_bytes",
]


def _index(frame: parquet.ParquetFrame, rows: int):
    """``(index, unit)`` of a read frame."""
    index = frame.index
    if index is None:
        return list(range(rows)), None
    if index.kind == "timestamp":
        try:
            values, unit = index_from_ticks(index.values, index.unit, index.tz)
        except ArrowDecodeError as exc:
            raise ParquetDecodeError(str(exc)) from None
        return values, unit
    if index.kind in ("range", "int64", "int32"):
        return index.values.astype(np.int64).tolist(), None
    raise ParquetDecodeError(f"The index is {index.kind}; the port reads a timestamp or an integer index")


def parquet_columns(buf) -> Tuple[Frame, Dict[str, np.ndarray]]:
    """A parquet request body as a frame (see the module's docstring) and
    the decoded columns the frame keeps unstacked, by name."""
    frame = parquet.read_frame(buf)
    names = [str(label) for label in frame.labels]
    rows = len(frame.columns[0].values) if frame.columns else 0
    numeric = [c.values for c in frame.columns if c.values.dtype.kind in "fiu"]
    if len(numeric) != len(frame.columns):
        raise FrameError(f"Non-numeric values in columns {names}")
    index, unit = _index(frame, rows)
    if not numeric:
        return Frame(index, names, np.zeros((rows, 0)), unit), {}
    return Frame(index, names, None, unit, numeric), dict(zip(names, numeric))


def dataframe_from_parquet_bytes(buf) -> Frame:
    """A parquet request body as a frame (see the module's docstring)."""
    return parquet_columns(buf)[0]


def dataframe_into_parquet_bytes(frame: Union[WireTable, Frame], flat: bool = False) -> bytes:
    """A response table (two-level columns; with ``flat``, one level of
    the columns' groups) or a request frame (flat columns) as parquet
    bytes."""
    if isinstance(frame, WireTable):
        labels: List[Any] = [c.group if flat else (c.group, c.sub) for c in frame.columns]
        columns = [c.values for c in frame.columns]
    else:
        labels = list(frame.columns)
        values = np.asarray(frame.values)
        columns = [values[:, j] for j in range(values.shape[1])]
    index: Any = list(frame.index)
    unit, zone = "us", None
    if index and isinstance(index[0], datetime):
        index, unit, zone = timestamp_ticks(index, frame.unit)
    elif not index or index == list(range(index[0], index[0] + len(index))):
        index = ("range", index[0] if index else 0, 1)
    else:
        unit = None
    return parquet.write_frame(labels, columns, index, unit, zone)


def table_from_parquet_bytes(buf) -> WireTable:
    """A parquet response as a table: two-level labels as ``(group, sub)``,
    a flat label as its group; string columns as object arrays (``None``
    for a null), as the Arrow decoder gives them."""
    frame = parquet.read_frame(buf)
    rows = len(frame.columns[0].values) if frame.columns else 0
    columns = []
    for label, column in zip(frame.labels, frame.columns):
        group, sub = (label[0], label[1]) if isinstance(label, tuple) else (label, "")
        columns.append(WireColumn(str(group), str(sub), column.values))
    index, unit = _index(frame, rows)
    return WireTable(index, columns, unit)
