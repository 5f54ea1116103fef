"""
Wire columns to the device without a host ``column_stack``, a port of
``gordo_tpu/ingest/transfer.py``.

A request decoded from an Arrow stream (or parquet) holds one numpy array
a feature, views of the body where the codec could make them, and the
decode leaves them unstacked (``json_codec.Frame`` stacks only when its
``values`` are read). :class:`RawColumns` carries them as they are, and
:func:`stage` writes a payload into a host staging buffer in one of two
rungs that give the same bits:

- **dlpack** (JAX's name, kept with its counters): the wire columns are
  gathered straight into their columns of the buffer, one ``np.stack``
  over the buffer's rows, with the f64 (or integer) columns cast on the
  way. The wire buffer is read in place, as ``torch.from_dlpack`` of a
  column would share it; no host matrix is assembled first.
- **host**: :meth:`RawColumns.host_matrix` (the legacy stacked float32
  matrix), copied into the buffer.

:func:`to_device` stages one payload into a ``[padded_rows, width]``
buffer, pinned when the target is a card, and makes one non-blocking copy;
the serving engine stages a batch's payloads into one ``[members, rows,
width]`` buffer the same way. Any refusal of the dlpack rung (a dtype it
cannot cast, or a non-contiguous f32 column, which JAX's dlpack refuses)
takes the whole payload to the host rung, and its reason is counted;
:func:`ingest_stats` reads the counts with the JAX package's keys.
"""

import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

_stats_lock = threading.Lock()
_STATS = {"dlpack_transfers": 0, "host_transfers": 0, "dlpack_columns": 0, "fallback_reasons": {}}


def _note_transfer(dlpack: bool, columns: int = 0, reason: str = "") -> None:
    with _stats_lock:
        if dlpack:
            _STATS["dlpack_transfers"] += 1
            _STATS["dlpack_columns"] += columns
        else:
            _STATS["host_transfers"] += 1
            if reason:
                reasons = _STATS["fallback_reasons"]
                reasons[reason] = reasons.get(reason, 0) + 1


def ingest_stats() -> dict:
    """The process's transfer counts: requests moved by each rung, columns
    moved over dlpack, and why the host rung was taken."""
    with _stats_lock:
        return {
            "dlpack_transfers": _STATS["dlpack_transfers"],
            "host_transfers": _STATS["host_transfers"],
            "dlpack_columns": _STATS["dlpack_columns"],
            "fallback_reasons": dict(_STATS["fallback_reasons"]),
        }


def reset_ingest_stats() -> None:
    with _stats_lock:
        _STATS.update(dlpack_transfers=0, host_transfers=0, dlpack_columns=0, fallback_reasons={})


class RawColumns:
    """A request's payload in wire form: one column a feature, in the
    model's tag order, not yet stacked. ``from_matrix`` wraps a matrix
    that is already staged (a JSON request), so that every caller speaks
    one payload type; :meth:`host_matrix` is the legacy staged float32
    matrix, made at most once and only when asked for.

    >>> raw = RawColumns.from_columns([np.array([1.0, 2.0]), np.array([3.0, 4.0])])
    >>> raw.rows, raw.width, raw.nbytes
    (2, 2, 32)
    >>> raw.host_matrix().tolist()
    [[1.0, 3.0], [2.0, 4.0]]
    """

    __slots__ = ("columns", "matrix", "rows", "width", "_host")

    def __init__(self, columns: Optional[Sequence[np.ndarray]], matrix: Optional[np.ndarray], rows: int,
                 width: int):
        self.columns = tuple(columns) if columns is not None else None
        self.matrix = matrix
        self.rows = int(rows)
        self.width = int(width)
        self._host: Optional[np.ndarray] = None

    @classmethod
    def from_columns(cls, columns: Sequence[np.ndarray]) -> "RawColumns":
        cols = [np.asarray(col) for col in columns]
        return cls(cols, None, len(cols[0]) if cols else 0, len(cols))

    @classmethod
    def from_matrix(cls, matrix: Any) -> "RawColumns":
        mat = np.asarray(matrix)
        return cls(None, mat, mat.shape[0], mat.shape[1] if mat.ndim > 1 else 1)

    def values(self) -> np.ndarray:
        """The rows as the decode gave them: the matrix, or the columns
        stacked in their own dtype (a frame's ``values``), for a member's
        host transform."""
        return self.matrix if self.matrix is not None else np.column_stack(self.columns)

    def host_matrix(self) -> np.ndarray:
        """The staged ``float32`` C-order matrix."""
        if self._host is None:
            if self.matrix is not None:
                self._host = np.ascontiguousarray(self.matrix, np.float32)
            else:
                self._host = np.column_stack([np.asarray(col, np.float32) for col in self.columns])
        return self._host

    @property
    def nbytes(self) -> int:
        if self.columns is not None:
            return int(sum(col.nbytes for col in self.columns))
        return int(self.matrix.nbytes)


def _rung_column(col: np.ndarray) -> np.ndarray:
    """One wire column as the rung reads it; raises on what JAX's dlpack
    rung refuses (the caller falls back)."""
    arr = np.asarray(col)
    if arr.dtype == np.float32 and not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("non-contiguous wire column")
    return arr


def staging_buffer(shape: Tuple[int, ...], device: Any) -> torch.Tensor:
    """An uninitialised float32 host buffer, pinned when it feeds a card
    (so the copy can be asynchronous; the caching host allocator keeps it
    alive until the copy has run)."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=torch.device(device).type == "cuda")


def stage(raw: RawColumns, out: np.ndarray, dlpack: bool = True) -> None:
    """Write ``raw``'s rows into ``out[:rows]`` of a ``[rows or more,
    width]`` float32 buffer and zero the rest, through the dlpack rung
    when ``dlpack`` and the payload has columns, else (or when the rung
    refuses) through the host rung. Both rungs write the same bits."""
    rows = raw.rows
    out[rows:] = 0
    if dlpack and raw.columns is not None and raw.width > 0 and rows > 0:
        try:
            np.stack([_rung_column(col) for col in raw.columns], axis=1, out=out[:rows])
            _note_transfer(True, columns=raw.width)
            return
        except Exception as exc:  # noqa: BLE001 - any refusal takes the host rung
            _note_transfer(False, reason=type(exc).__name__)
    else:
        _note_transfer(False, reason="disabled" if not dlpack else "no_columns")
    out[:rows] = raw.host_matrix()


def to_device(raw: RawColumns, padded_rows: Optional[int] = None, dlpack: bool = True,
              device: Any = "cuda") -> torch.Tensor:
    """``raw`` as a ``[rows, width]`` (or ``[padded_rows, width]``, the
    tail zero) float32 tensor on ``device``: written by :func:`stage` into one host
    buffer, then one copy (non-blocking to a card)."""
    device = torch.device(device)
    buf = staging_buffer((padded_rows if padded_rows is not None else raw.rows, raw.width), device)
    stage(raw, buf.numpy(), dlpack)
    return buf.to(device, non_blocking=True)
