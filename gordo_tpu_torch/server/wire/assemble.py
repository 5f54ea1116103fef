"""
Columnar response assembly: the anomaly and prediction responses as
ordered numpy columns, a copy of ``gordo_tpu/server/wire/assemble.py``
without pandas.

The numbers follow the JAX server's dtype flow, quirks included: the
detector's MinMax scaler scales a float32 reconstruction in place, with
float32 rounding and no clip, before the float64 subtraction (another
error scaler runs its own ``transform``, which keeps sklearn's flow); the row mean of
squares skips NaN, as pandas' ``mean`` does. Columns come out in the
same order under the same ``(group, sub)`` labels.

``X`` and ``y`` are request frames (``json_codec.Frame``: ``index``,
``columns``, float64 ``values``).
"""

from datetime import date, datetime, timedelta
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ...models.anomaly.diff import smooth as _smooth
from ...models.preprocessing import MinMaxScaler


class WireColumn(NamedTuple):
    """One response column: top-level ``group``, tag-level ``sub`` ('' for
    scalar groups) and its ``values`` (1-D array or list)."""

    group: str
    sub: str
    values: Any


def index_wire_keys(index: Sequence[Any]) -> List[str]:
    """Response index keys, as the JAX server writes them (pandas'
    ``DatetimeIndex.astype(str)``): ``2020-01-01 00:10:00+00:00``, or the
    bare date when a naive index is all midnights; other keys as ``str``.

    >>> index_wire_keys([datetime(2020, 1, 1), datetime(2020, 1, 2)])
    ['2020-01-01', '2020-01-02']
    """
    if index and isinstance(index[0], datetime):
        if index[0].tzinfo is None and all(dt.time() == datetime.min.time() for dt in index):
            return [date.isoformat(dt.date()) for dt in index]
        return [str(dt) for dt in index]
    return [str(v) for v in index]


class WireTable:
    """An ordered columnar response over one index; ``unit`` is a datetime
    index's Arrow timestamp unit (None: ``us``, the JSON decode's)."""

    __slots__ = ("index", "columns", "unit", "_keys")

    def __init__(self, index: Sequence[Any], columns: List[WireColumn], unit: Optional[str] = None):
        self.index = list(index)
        self.columns = columns
        self.unit = unit
        self._keys: Optional[List[str]] = None

    @property
    def keys(self) -> List[str]:
        if self._keys is None:
            self._keys = index_wire_keys(self.index)
        return self._keys

    def groups(self) -> Iterator[Tuple[str, List[WireColumn]]]:
        """Columns grouped by consecutive top-level key, in order."""
        group: Optional[str] = None
        bucket: List[WireColumn] = []
        for column in self.columns:
            if column.group != group:
                if bucket:
                    yield group, bucket  # type: ignore[misc]
                group, bucket = column.group, []
            bucket.append(column)
        if bucket:
            yield group, bucket  # type: ignore[misc]


def _scaler_transform(scaler: Any, values: np.ndarray) -> np.ndarray:
    """The error scaler's transform as the JAX server runs it: a
    ``MinMaxScaler`` with sklearn's dtype flow (a copy in the input's
    float dtype, then ``*= scale_`` and ``+= min_`` in place, never
    clipped), any other scaler through its own ``transform``."""
    if type(scaler) is not MinMaxScaler:
        return np.asarray(scaler.transform(values))
    dtype = values.dtype if values.dtype in (np.float64, np.float32, np.float16) else np.float64
    out = np.array(values, dtype=dtype, copy=True)
    out *= scaler.scale_
    out += scaler.min_
    return out


def _row_mean_of_squares(values: np.ndarray) -> np.ndarray:
    """Row mean of squares, skipping NaN (NaN for an all-NaN row)."""
    squares = np.square(values)
    present = ~np.isnan(squares)
    counts = present.sum(axis=1)
    sums = np.where(present, squares, 0.0).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)


def _index_strings(
    index: Sequence[Any], frequency: Optional[timedelta]
) -> Tuple[List[Optional[str]], List[Optional[str]]]:
    """The ``start``/``end`` columns: ISO strings of each row's time and of
    that time plus the resolution; None for non-datetime indexes."""
    if not index or not isinstance(index[0], datetime):
        return [None] * len(index), [None] * len(index)
    starts = [ts.isoformat() for ts in index]
    if frequency is None:
        return starts, [None] * len(index)
    return starts, [(ts + frequency).isoformat() for ts in index]


def _matrix_columns(group: str, values: np.ndarray, names: Sequence[str]) -> List[WireColumn]:
    """One column group of a 2-D array; subs fall back to positions when the
    width disagrees with the tag list."""
    subs = list(names) if values.shape[1] == len(names) else [str(i) for i in range(values.shape[1])]
    return [WireColumn(group, sub, values[:, i]) for i, sub in enumerate(subs)]


def _input_columns(X: Any, n_out: int, names: Sequence[str]) -> List[WireColumn]:
    """The ``model-input`` group: ``X``'s last ``n_out`` rows column by
    column (a frame's unstacked columns are never stacked for it); subs as
    :func:`_matrix_columns` names them."""
    arrays = X.arrays() if hasattr(X, "arrays") else list(np.asarray(X.values).T)
    start = len(X.index) - n_out
    subs = list(names) if len(arrays) == len(names) else [str(i) for i in range(len(arrays))]
    return [WireColumn("model-input", sub, a[start:]) for sub, a in zip(subs, arrays)]


def prediction_table(
    X: Any,
    model_output: np.ndarray,
    tag_names: Sequence[str],
    target_names: Optional[Sequence[str]] = None,
    frequency: Optional[timedelta] = None,
) -> WireTable:
    """``start`` / ``end`` / ``model-input`` / ``model-output``, aligned to
    the (possibly shorter) model output."""
    output = np.asarray(model_output)
    n_out = len(output)
    index = X.index[len(X.index) - n_out:]
    starts, ends = _index_strings(index, frequency)
    columns = [WireColumn("start", "", starts), WireColumn("end", "", ends)]
    columns += _input_columns(X, n_out, tag_names)
    columns += _matrix_columns(
        "model-output", output, target_names if target_names is not None else tag_names
    )
    return WireTable(index, columns, getattr(X, "unit", None))


def anomaly_table(
    model: Any,
    X: Any,
    y: Any,
    model_output: np.ndarray,
    frequency: Optional[timedelta] = None,
    thresholds: Optional[np.ndarray] = None,
    aggregate: Optional[float] = None,
    keep_smooth: bool = False,
) -> WireTable:
    """
    The ``DiffBasedAnomalyDetector`` anomaly response as columns: input,
    output, tag and total anomalies scaled and unscaled, with
    ``keep_smooth`` their ``smooth-*`` groups when the detector has a
    window, and the confidences when thresholds were fitted.
    ``thresholds``/``aggregate`` default to the detector's own.

    Raises ``AttributeError`` when ``require_thresholds`` is set and no
    thresholds were fitted (422) and ``ValueError`` on input problems (400).
    """
    output = np.asarray(model_output)
    n_out = len(output)
    if n_out > len(X.index) or n_out > len(y.index):
        raise ValueError("model output is longer than its input")
    index = X.index[len(X.index) - n_out:]
    starts, ends = _index_strings(index, frequency)
    out_names = list(y.columns)
    out_subs = out_names if output.shape[1] == len(out_names) else [str(i) for i in range(output.shape[1])]

    y_values = np.asarray(y.values)
    y_raw = y_values[len(y_values) - n_out:]
    out_scaled = _scaler_transform(model.scaler, output)
    scaled_y = _scaler_transform(model.scaler, y_values)
    tag_scaled = np.abs(out_scaled - scaled_y[len(scaled_y) - n_out:])
    total_scaled = _row_mean_of_squares(tag_scaled)
    tag_unscaled = np.abs(output - y_raw)
    total_unscaled = _row_mean_of_squares(tag_unscaled)

    columns = [WireColumn("start", "", starts), WireColumn("end", "", ends)]
    columns += _input_columns(X, n_out, list(X.columns))
    columns += _matrix_columns("model-output", output, out_names)
    columns += [WireColumn("tag-anomaly-scaled", sub, tag_scaled[:, i]) for i, sub in enumerate(out_subs)]
    columns.append(WireColumn("total-anomaly-scaled", "", total_scaled))
    columns += [WireColumn("tag-anomaly-unscaled", sub, tag_unscaled[:, i]) for i, sub in enumerate(out_names)]
    columns.append(WireColumn("total-anomaly-unscaled", "", total_unscaled))

    if keep_smooth and model.window is not None and model.smoothing_method:
        smooth_scaled = _smooth(model, tag_scaled)
        columns += [WireColumn("smooth-tag-anomaly-scaled", sub, smooth_scaled[:, i]) for i, sub in enumerate(out_subs)]
        columns.append(WireColumn("smooth-total-anomaly-scaled", "", _smooth(model, total_scaled)))
        smooth_unscaled = _smooth(model, tag_unscaled)
        columns += [
            WireColumn("smooth-tag-anomaly-unscaled", sub, smooth_unscaled[:, i]) for i, sub in enumerate(out_names)
        ]
        columns.append(WireColumn("smooth-total-anomaly-unscaled", "", _smooth(model, total_unscaled)))

    if thresholds is None:
        thresholds = model.feature_thresholds_
    if thresholds is not None:
        confidence = tag_unscaled / np.asarray(thresholds, np.float64)
        columns += [WireColumn("anomaly-confidence", sub, confidence[:, i]) for i, sub in enumerate(out_subs)]
    if aggregate is None:
        aggregate = model.aggregate_threshold_
    if aggregate is not None:
        columns.append(WireColumn("total-anomaly-confidence", "", total_scaled / float(aggregate)))

    if model.require_thresholds and model.feature_thresholds_ is None and model.aggregate_threshold_ is None:
        raise AttributeError(
            f"`require_thresholds={model.require_thresholds}` however "
            "`.cross_validate` was not called to calculate thresholds "
            "before `.anomaly`"
        )
    return WireTable(index, columns, getattr(X, "unit", None))


def lean_table(index: Sequence[Any], recon: np.ndarray, mse: np.ndarray, unit: Optional[str] = None) -> WireTable:
    """The fleet route's lean entry (``model-output`` by column position and
    the per-row ``total-anomaly-unscaled``) as a table, the Arrow twin of
    ``json_codec.encode_lean_entry`` (JAX's ``_lean_table``)."""
    columns = [WireColumn("model-output", str(col), recon[:, col]) for col in range(recon.shape[1])]
    columns.append(WireColumn("total-anomaly-unscaled", "", np.asarray(mse)))
    return WireTable(index, columns, unit)
