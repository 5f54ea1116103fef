"""
Datasets, ``gordo_tpu/dataset/datasets.py`` without pandas:
``from_dict``/``to_dict``, :class:`TimeSeriesDataset` (per-tag series
from a provider, resampled onto one time grid, joined, filled and
filtered) and :class:`RandomDataset`. ``get_data`` returns ``(X, y,
index)``: float64 arrays of the tag and target columns and the rows'
aware datetimes.

Resampling follows pandas' ``resample(resolution).agg(method)`` with
``origin="start_day"``: a reading falls in the bin labelled by the left
edge ``midnight + k * resolution``, midnight of its series' first day in
the series' own time zone; a bin without readings is NaN (for ``sum``
and ``count``, 0). The join keeps the bin labels every tag has (the
inner join of the JAX dataset's per-series path; its one-pass path
gives the same rows). A bin's mean sums its readings in another order
than pandas, so values agree to about 1e-15 relative, not bit for bit.

``to_dict`` writes the JAX package's class paths. ``row_filter``, a
pandas ``query`` string, is evaluated by ``query.py`` on the joined
columns, after the known filter periods and before the thresholds, as
the JAX dataset's filter chain runs.
"""

import abc
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.args import capture_args
from .data_provider import GordoBaseDataProvider, RandomDataProvider
from .exceptions import ConfigException, InsufficientDataError
from .query import row_mask
from .sensor_tag import SensorTag, normalize_sensor_tags, to_list_of_strings, unique_tag_names
from .series import (
    Series,
    datetime_ns,
    duration_ns,
    local_midnight_ns,
    normalize_frequency,
    ns_datetime,
    parse_datetime,
)

DEFAULT_RESOLUTION = "10min"
#: the module the JAX package's datasets live in, for ``to_dict``'s ``type``
JAX_MODULE = "gordo_tpu.dataset.datasets"
AGGREGATIONS = ("mean", "median", "min", "max", "first", "last", "std", "var", "sum", "count")


def interpolate_linear_limited(values: np.ndarray, limit: int) -> np.ndarray:
    """
    ``DataFrame.interpolate(method="linear", limit=limit)`` on a float64
    matrix, as ``gordo_tpu/dataset/datasets.py::_interpolate_linear_limited``:
    leading NaNs stay, a gap fills linearly between its anchors but only
    its first ``limit`` positions, trailing NaNs repeat the last reading
    up to ``limit``.

    >>> interpolate_linear_limited(np.array([[np.nan], [1.0], [np.nan], [np.nan], [4.0], [np.nan]]), 1).ravel()
    array([nan,  1.,  2., nan,  4.,  4.])
    """
    values = np.array(values, np.float64)
    positions = np.arange(len(values))
    for col in range(values.shape[1] if values.ndim == 2 and len(values) else 0):
        column = values[:, col]
        nan_mask = np.isnan(column)
        if not nan_mask.any() or nan_mask.all():
            continue
        valid = ~nan_mask
        valid_idx = np.flatnonzero(valid)
        filled = np.interp(positions, valid_idx, column[valid_idx])
        prev_valid = np.maximum.accumulate(np.where(valid, positions, -1))
        fill = nan_mask & (prev_valid >= 0) & (positions - prev_valid <= limit)
        column[fill] = filled[fill]
    return values


def forward_fill(values: np.ndarray, limit: int) -> np.ndarray:
    """``DataFrame.ffill(limit=limit)``: each NaN takes the last reading
    before it, for at most ``limit`` positions of a gap."""
    values = np.array(values, np.float64)
    positions = np.arange(len(values))[:, None]
    valid = ~np.isnan(values)
    prev_valid = np.maximum.accumulate(np.where(valid, positions, -1), axis=0)
    fill = ~valid & (prev_valid >= 0) & (positions - prev_valid <= limit)
    source = values[np.maximum(prev_valid, 0), np.arange(values.shape[1])[None, :]]
    return np.where(fill, source, values)


def _bin_reduce(bins: np.ndarray, values: np.ndarray, n_bins: int, method: str) -> np.ndarray:
    """One aggregation of ``values`` by bin number (``bins`` ascending),
    NaN readings skipped; an empty bin is NaN (0 for sum and count)."""
    ok = ~np.isnan(values)
    b, v = bins[ok], values[ok]
    count = np.bincount(b, minlength=n_bins).astype(np.float64)
    if method == "count":
        return count
    if method == "sum":
        return np.bincount(b, weights=v, minlength=n_bins)
    out = np.full(n_bins, np.nan)
    have = count > 0
    if method in ("mean", "std", "var"):
        mean = np.bincount(b, weights=v, minlength=n_bins)[have] / count[have]
        if method == "mean":
            out[have] = mean
            return out
        full_mean = np.zeros(n_bins)
        full_mean[have] = mean
        squares = np.bincount(b, weights=np.square(v - full_mean[b]), minlength=n_bins)
        two = count > 1
        out[two] = squares[two] / (count[two] - 1)
        return np.sqrt(out) if method == "std" else out
    if not len(b):
        return out
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    labels = b[starts]
    if method == "min":
        out[labels] = np.minimum.reduceat(v, starts)
    elif method == "max":
        out[labels] = np.maximum.reduceat(v, starts)
    elif method == "first":
        out[labels] = v[starts]
    elif method == "last":
        out[labels] = v[np.r_[starts[1:], len(v)] - 1]
    elif method == "median":
        out[labels] = [np.median(part) for part in np.split(v, starts[1:])]
    else:
        raise ValueError(f"Unsupported aggregation {method!r} (supported: {AGGREGATIONS})")
    return out


def resample(series: Series, resolution_ns: int, methods: Sequence[str]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``series.resample(resolution).agg(methods)``: the bin labels (UTC
    ns) from the first reading's bin to the last's, and one column a
    method."""
    origin = local_midnight_ns(int(series.stamps[0]), series.tz)
    bins = (series.stamps - origin) // resolution_ns
    first = int(bins[0])
    bins = (bins - first).astype(np.int64)
    n_bins = int(bins[-1]) + 1
    labels = origin + (first + np.arange(n_bins, dtype=np.int64)) * resolution_ns
    return labels, [_bin_reduce(bins, series.values, n_bins, m) for m in methods]


class GordoBaseDataset(abc.ABC):
    @abc.abstractmethod
    def get_data(self) -> Tuple[np.ndarray, np.ndarray, List[Any]]:
        """``(X, y, index)``."""

    @abc.abstractmethod
    def get_metadata(self) -> dict:
        """What the build records under ``dataset_meta``."""

    def to_dict(self) -> dict:
        params = dict(getattr(self, "_params", {}))
        if isinstance(params.get("data_provider"), GordoBaseDataProvider):
            params["data_provider"] = params["data_provider"].to_dict()
        params["tag_list"] = [t.to_json() if isinstance(t, SensorTag) else t for t in params.get("tag_list", [])]
        if params.get("target_tag_list"):
            params["target_tag_list"] = [
                t.to_json() if isinstance(t, SensorTag) else t for t in params["target_tag_list"]
            ]
        params["type"] = f"{JAX_MODULE}.{type(self).__name__}"
        return params

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "GordoBaseDataset":
        """The dataset a config describes: ``type`` (default
        ``TimeSeriesDataset``) a short name or a dotted path of this
        module, the JAX package's or ``gordo_dataset``'s; ``tags`` and
        ``target_tags`` stand for ``tag_list`` and ``target_tag_list``."""
        config = dict(config)
        for alias, canonical in (("tags", "tag_list"), ("target_tags", "target_tag_list")):
            if alias in config and canonical not in config:
                config[canonical] = config.pop(alias)
        dataset_type = config.pop("type", None) or "TimeSeriesDataset"
        module, _, name = dataset_type.rpartition(".")
        known = {"TimeSeriesDataset": TimeSeriesDataset, "RandomDataset": RandomDataset}
        if name in known and module in ("", JAX_MODULE, __name__, "gordo_dataset.datasets"):
            return known[name](**config)
        raise ImportError(f"Dataset type {dataset_type!r} is not ported to gordo_tpu_torch")


def _parse_timestamp(value: Any):
    stamp = parse_datetime(value)
    if stamp.tzinfo is None:
        raise ConfigException(f"Timestamp {value!r} must be timezone-aware")
    return stamp


class TimeSeriesDataset(GordoBaseDataset):
    """
    Per-tag series from a data provider on one time grid. ``get_data``:
    load the series, resample each to ``resolution`` with
    ``aggregation_methods`` (a list widens each tag into
    ``{tag}_{method}`` columns), join on the bins every tag has, fill gaps
    (``linear_interpolation`` or ``ffill``, at most ``interpolation_limit``
    / ``resolution`` rows, at least 1), drop rows with a NaN, drop
    ``known_filter_periods`` and rows outside ``low_threshold`` /
    ``high_threshold``, and refuse ``n_samples_threshold`` rows or fewer.
    """

    @capture_args
    def __init__(
        self,
        train_start_date,
        train_end_date,
        tag_list: List[Any],
        target_tag_list: Optional[List[Any]] = None,
        data_provider: Optional[Any] = None,
        resolution: str = DEFAULT_RESOLUTION,
        row_filter: str = "",
        known_filter_periods: Optional[List[Tuple[str, str]]] = None,
        aggregation_methods: Any = "mean",
        n_samples_threshold: int = 0,
        low_threshold: Optional[float] = None,
        high_threshold: Optional[float] = None,
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: str = "8h",
        asset: Optional[str] = None,
        **kwargs,
    ):
        self.train_start_date = _parse_timestamp(train_start_date)
        self.train_end_date = _parse_timestamp(train_end_date)
        if self.train_start_date >= self.train_end_date:
            raise ConfigException(
                f"train_end_date ({self.train_end_date}) must be after train_start_date ({self.train_start_date})"
            )
        self.tag_list = normalize_sensor_tags(tag_list, asset=asset)
        self.target_tag_list = (
            normalize_sensor_tags(target_tag_list, asset=asset) if target_tag_list else list(self.tag_list)
        )
        unique_tag_names(self.tag_list)
        if data_provider is None:
            data_provider = RandomDataProvider()
        self.data_provider = (
            GordoBaseDataProvider.from_dict(data_provider) if isinstance(data_provider, dict) else data_provider
        )
        self.resolution = normalize_frequency(resolution)
        self.row_filter = row_filter
        self.known_filter_periods = known_filter_periods or []
        self.aggregation_methods = aggregation_methods
        self.n_samples_threshold = n_samples_threshold
        self.low_threshold = low_threshold
        self.high_threshold = high_threshold
        self.interpolation_method = interpolation_method
        self.interpolation_limit = interpolation_limit
        self._metadata: Dict[str, Any] = {}

    def _load_and_join(self) -> Tuple[np.ndarray, List[str], np.ndarray, Any]:
        """The joined, filled rows: ``(bin labels, column names, values, tz)``."""
        all_tags = unique_tag_names(list(self.tag_list) + list(self.target_tag_list))
        series_list = list(
            self.data_provider.load_series(self.train_start_date, self.train_end_date, list(all_tags.values()))
        )
        if not series_list:
            raise InsufficientDataError("Data provider returned no series")
        for series in series_list:
            if not len(series):
                raise InsufficientDataError(
                    f"Tag {series.name!r} has no data in [{self.train_start_date}, {self.train_end_date}]"
                )
        resolution_ns = duration_ns(self.resolution)
        single = isinstance(self.aggregation_methods, str)
        methods = [self.aggregation_methods] if single else list(self.aggregation_methods)
        resampled = [resample(series, resolution_ns, methods) for series in series_list]
        labels = resampled[0][0]
        for other, _ in resampled[1:]:
            labels = np.intersect1d(labels, other, assume_unique=True)
        names, columns = [], []
        for series, (own, values) in zip(series_list, resampled):
            rows = np.searchsorted(own, labels)
            for method, column in zip(methods, values):
                names.append(series.name if single else f"{series.name}_{method}")
                columns.append(column[rows])
        data = np.stack(columns, axis=1) if columns else np.zeros((len(labels), 0))
        limit = max(int(duration_ns(self.interpolation_limit) // resolution_ns), 1)
        if self.interpolation_method == "linear_interpolation":
            data = interpolate_linear_limited(data, limit)
        elif self.interpolation_method == "ffill":
            data = forward_fill(data, limit)
        keep = ~np.isnan(data).any(axis=1)
        return labels[keep], names, data[keep], series_list[0].tz

    def _apply_filters(self, labels: np.ndarray, names: List[str], data: np.ndarray):
        n_before = len(data)
        keep = np.ones(n_before, bool)
        for period in self.known_filter_periods:
            if not period:
                continue
            start, end = (datetime_ns(_parse_timestamp(p)) for p in period[:2])
            keep &= (labels < start) | (labels > end)
        if self.row_filter:  # on the rows the periods kept, as pandas queries what is left
            keep[keep] = row_mask(self.row_filter, names, data[keep])
        if self.low_threshold is not None:
            keep &= (data > self.low_threshold).all(axis=1)
        if self.high_threshold is not None:
            keep &= (data < self.high_threshold).all(axis=1)
        self._metadata["filtered_rows"] = n_before - int(keep.sum())
        return labels[keep], data[keep]

    def column_names(self) -> Tuple[List[str], List[str]]:
        """The names of X's and y's columns."""
        x_names = to_list_of_strings(self.tag_list)
        y_names = to_list_of_strings(self.target_tag_list)
        if not isinstance(self.aggregation_methods, str):
            x_names = [f"{n}_{m}" for n in x_names for m in self.aggregation_methods]
            y_names = [f"{n}_{m}" for n in y_names for m in self.aggregation_methods]
        return x_names, y_names

    def get_data(self) -> Tuple[np.ndarray, np.ndarray, List[Any]]:
        labels, names, data, tz = self._load_and_join()
        labels, data = self._apply_filters(labels, names, data)
        if len(data) <= self.n_samples_threshold:
            raise InsufficientDataError(
                f"Dataset resolved to {len(data)} rows, below threshold {self.n_samples_threshold}"
            )
        x_names, y_names = self.column_names()
        position = {name: i for i, name in enumerate(names)}
        X = data[:, [position[n] for n in x_names]]
        y = data[:, [position[n] for n in y_names]]
        self._metadata.update({
            "train_start_date": self.train_start_date.isoformat(),
            "train_end_date": self.train_end_date.isoformat(),
            "resolution": self.resolution,
            "row_count": len(X),
            "tag_list": [t.to_json() for t in self.tag_list],
            "target_tag_list": [t.to_json() for t in self.target_tag_list],
            "x_hist": column_histograms(X, x_names),
        })
        return X, y, [ns_datetime(ns, tz) for ns in labels]

    def get_metadata(self) -> dict:
        return dict(self._metadata)


def column_histograms(X: np.ndarray, names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """Per-column min, max, mean and std (``ddof=1``), NaN-aware."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN or one-row columns
        mins, maxs = np.nanmin(X, axis=0), np.nanmax(X, axis=0)
        means, stds = np.nanmean(X, axis=0), np.nanstd(X, axis=0, ddof=1)
    return {
        str(name): {"min": float(mins[i]), "max": float(maxs[i]), "mean": float(means[i]), "std": float(stds[i])}
        for i, name in enumerate(names)
    }


class RandomDataset(TimeSeriesDataset):
    """A :class:`TimeSeriesDataset` of :class:`RandomDataProvider` readings."""

    @capture_args
    def __init__(self, train_start_date, train_end_date, tag_list: List[Any], **kwargs):
        kwargs.pop("data_provider", None)
        super().__init__(
            train_start_date=train_start_date,
            train_end_date=train_end_date,
            tag_list=tag_list,
            data_provider=RandomDataProvider(),
            **kwargs,
        )


class ArrayDataset(GordoBaseDataset):
    """
    Rows a caller already holds: ``X`` (``[n, tags]``), ``y`` (``X`` when
    the targets are the tags) and an optional ``index`` of datetimes,
    beside the ``config`` block that ``to_dict`` writes as given
    (``tag_list``, ``target_tag_list``, ``resolution``, which serving
    reads). ``get_metadata`` is the row count, the resolution and the tag
    lists.
    """

    def __init__(self, config: dict, X: np.ndarray, y: np.ndarray, index: Optional[Sequence[Any]] = None):
        self.config, self.X, self.y, self.index = config, X, y, index
        self.tag_list = normalize_sensor_tags(config.get("tag_list") or [])
        self.target_tag_list = normalize_sensor_tags(config.get("target_tag_list") or []) or list(self.tag_list)
        self.resolution = config.get("resolution")

    def column_names(self) -> Tuple[List[str], List[str]]:
        return to_list_of_strings(self.tag_list), to_list_of_strings(self.target_tag_list)

    def get_data(self):
        return self.X, self.y, self.index

    def get_metadata(self) -> dict:
        return {
            "row_count": int(len(self.X)),
            "resolution": self.resolution,
            "tag_list": [t.to_json() for t in self.tag_list],
            "target_tag_list": [t.to_json() for t in self.target_tag_list],
        }

    def to_dict(self) -> dict:
        return self.config

