"""
Data providers, ``gordo_tpu/dataset/data_provider.py`` in numpy: each
yields one :class:`~.series.Series` per requested tag.

- :class:`RandomDataProvider`: the seeded synthetic source of the
  examples and tests, bit for bit the JAX provider's (the tag name's
  sha256 seeds a ``RandomState``; stamps are a ``linspace`` of the
  window's UTC nanoseconds, in the start date's time zone).
- :class:`FileDataProvider`: CSV files, one wide file of tag columns or
  a directory of one file per tag; naive stamps are read in ``tz``;
  readings in ``[start, end)``. Parquet raises ``NotImplementedError``:
  it needs pyarrow.
- :class:`ListBackedDataProvider`: series held in memory.
- :class:`InfluxDataProvider`: raises ``NotImplementedError`` when it is
  read; it needs an Influx client and a network.

``to_dict`` writes the JAX package's class paths, so an artifact's
``metadata.json`` reads the same from either package.
"""

import abc
import csv
import hashlib
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..utils.args import capture_args
from .sensor_tag import SensorTag, normalize_sensor_tags
from .series import Series, datetime_ns, parse_datetime, resolve_tz, tz_of

#: the module the JAX package's providers live in, for ``to_dict``'s ``type``
JAX_MODULE = "gordo_tpu.dataset.data_provider"


class GordoBaseDataProvider(abc.ABC):
    @abc.abstractmethod
    def load_series(self, train_start_date, train_end_date, tag_list: List[SensorTag]) -> Iterable[Series]:
        """One series per requested tag; the dates are aware datetimes."""

    def to_dict(self) -> dict:
        return {"type": f"{JAX_MODULE}.{type(self).__name__}", **getattr(self, "_params", {})}

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataProvider":
        """A provider from its config: ``type`` is a short name
        (``RandomDataProvider``) or a dotted path of this module or the
        JAX package's."""
        config = dict(config)
        provider_type = config.pop("type", None)
        if provider_type is None:
            return cls(**config)
        module, _, name = provider_type.rpartition(".")
        candidate = PROVIDERS.get(name)
        if module in ("", JAX_MODULE, __name__) and candidate is not None:
            return candidate(**config)
        if not module:
            raise ValueError(f"Unknown data provider short name: {provider_type!r}")
        raise ImportError(f"Data provider {provider_type!r} is not ported to gordo_tpu_torch")


def _window_check(train_start_date, train_end_date) -> None:
    if train_start_date >= train_end_date:
        raise ValueError(f"train_start_date ({train_start_date}) must be before train_end_date ({train_end_date})")


class RandomDataProvider(GordoBaseDataProvider):
    """Seeded synthetic readings: a sinusoid plus noise a tag, the same
    for the same tag name, window and sizes."""

    @capture_args
    def __init__(self, min_size: int = 100, max_size: int = 300, **kwargs):
        self.min_size = min_size
        self.max_size = max_size


    @staticmethod
    def _rng_for(tag: SensorTag) -> np.random.RandomState:
        digest = hashlib.sha256(tag.name.encode()).digest()
        return np.random.RandomState(int.from_bytes(digest[:4], "little"))

    def load_series(self, train_start_date, train_end_date, tag_list):
        _window_check(train_start_date, train_end_date)
        start_ns, end_ns = datetime_ns(train_start_date), datetime_ns(train_end_date)
        tz = tz_of(train_start_date)
        for tag in normalize_sensor_tags(tag_list):
            rng = self._rng_for(tag)
            n_points = rng.randint(self.min_size, self.max_size + 1)
            stamps = np.linspace(start_ns, end_ns, n_points).astype("int64")
            t = np.linspace(0.0, 2 * np.pi * rng.uniform(1.0, 6.0), n_points)
            base = rng.uniform(-50.0, 50.0)
            amplitude = rng.uniform(0.5, 10.0)
            values = (
                base
                + amplitude * np.sin(t + rng.uniform(0, 2 * np.pi))
                + 0.1 * amplitude * rng.standard_normal(n_points)
            )
            yield Series(tag.name, stamps, values, tz)


class _Frame:
    """A CSV file read as stamps (UTC ns, sorted) and named float columns."""

    def __init__(self, stamps: np.ndarray, columns: Dict[str, np.ndarray], tz):
        self.stamps, self.columns, self.tz = stamps, columns, tz


def _float(text: str) -> float:
    text = text.strip()
    return float(text) if text else np.nan


class FileDataProvider(GordoBaseDataProvider):
    """
    Tag readings from CSV files: ``path`` is one wide file whose columns
    are tags (stamps in ``timestamp_column``, default the first column),
    or a directory of ``<tag>.csv`` files, each a ``timestamp_column`` and
    a ``value_column`` (default the first two). ``tag_column_map`` maps a
    config tag name to its column or file name; naive stamps are read in
    ``tz`` (default UTC).
    """

    _FORMATS = {".parquet": "parquet", ".pq": "parquet", ".csv": "csv"}

    @capture_args
    def __init__(self, path: str, timestamp_column: Optional[str] = None, value_column: Optional[str] = None,
                 tag_column_map: Optional[Dict[str, str]] = None, tz: str = "UTC", **kwargs):
        self.path = path
        self.timestamp_column = timestamp_column
        self.value_column = value_column
        self.tag_column_map = tag_column_map or {}
        self.tz = tz
        self._wide_frame: Optional[_Frame] = None

    def _format_of(self, path: str) -> str:
        ext = os.path.splitext(path)[1].lower()
        file_format = self._FORMATS.get(ext)
        if file_format is None:
            raise ValueError(f"Unsupported file format {ext!r} for {path!r} (supported: {sorted(self._FORMATS)})")
        return file_format

    def _read_frame(self, path: str) -> _Frame:
        if self._format_of(path) == "parquet":
            raise NotImplementedError(
                f"{path!r}: parquet needs pyarrow, which gordo_tpu_torch does not use; export the data as CSV"
            )
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError(f"{path!r} is empty")
        header, body = rows[0], [row for row in rows[1:] if row]
        ts_col = self.timestamp_column if self.timestamp_column is not None else header[0]
        if ts_col not in header:
            raise ValueError(f"Timestamp column {ts_col!r} not present in {path!r} (columns: {header})")
        ts_pos = header.index(ts_col)
        ns, tz = self._stamps([row[ts_pos] for row in body], path)
        order = np.argsort(ns, kind="stable")
        columns = {
            name: np.array([_float(row[j]) for row in body], np.float64)[order]
            for j, name in enumerate(header) if j != ts_pos
        }
        return _Frame(ns[order], columns, tz)

    def _stamps(self, texts: List[str], path: str):
        """ISO stamps as UTC nanoseconds and their time zone: naive ones
        are read in ``tz``; a file holds one UTC offset."""
        stamps = [parse_datetime(text) for text in texts]
        offsets = {s.utcoffset() for s in stamps}
        if None in offsets and len(offsets) > 1:
            raise ValueError(f"{path!r} mixes naive and aware time stamps")
        if None in offsets:
            tz = resolve_tz(self.tz)
            stamps = [s.replace(tzinfo=tz) for s in stamps]
        elif len(offsets) > 1:
            raise ValueError(f"{path!r} mixes UTC offsets {sorted(str(o) for o in offsets)}; give one offset")
        else:
            tz = stamps[0].tzinfo if stamps else resolve_tz(self.tz)
        return np.array([datetime_ns(s) for s in stamps], np.int64), tz

    def _column_for(self, tag: SensorTag) -> str:
        return self.tag_column_map.get(tag.name, tag.name)

    def _is_directory_layout(self) -> bool:
        return os.path.isdir(self.path)

    def _tag_file(self, tag: SensorTag) -> Optional[str]:
        column = self._column_for(tag)
        for ext in self._FORMATS:
            candidate = os.path.join(self.path, column + ext)
            if os.path.isfile(candidate):
                return candidate
        return None

    def _wide(self) -> _Frame:
        if self._wide_frame is None:
            self._wide_frame = self._read_frame(self.path)
        return self._wide_frame

    def _series_for(self, tag: SensorTag) -> Series:
        if self._is_directory_layout():
            tag_file = self._tag_file(tag)
            if tag_file is None:
                raise ValueError(f"No file for tag {tag.name!r} under {self.path!r}")
            frame = self._read_frame(tag_file)
            column = self.value_column or next(iter(frame.columns), None)
            if column not in frame.columns:
                raise ValueError(f"Value column {column!r} not present in {tag_file!r}")
            return Series(tag.name, frame.stamps, frame.columns[column], frame.tz)
        frame = self._wide()
        column = self._column_for(tag)
        if column not in frame.columns:
            raise ValueError(
                f"Tag {tag.name!r} (column {column!r}) not present in {self.path!r} (columns: {list(frame.columns)})"
            )
        return Series(tag.name, frame.stamps, frame.columns[column], frame.tz)

    def load_series(self, train_start_date, train_end_date, tag_list):
        _window_check(train_start_date, train_end_date)
        start_ns, end_ns = datetime_ns(train_start_date), datetime_ns(train_end_date)
        for tag in normalize_sensor_tags(tag_list):
            yield self._series_for(tag).window(start_ns, end_ns)


class ListBackedDataProvider(GordoBaseDataProvider):
    """Series held in memory, each windowed to ``[start, end)``."""

    @capture_args
    def __init__(self, series: Optional[List[Series]] = None, **kwargs):
        self.series = series or []

    def load_series(self, train_start_date, train_end_date, tag_list):
        by_name = {s.name: s for s in self.series}
        start_ns, end_ns = datetime_ns(train_start_date), datetime_ns(train_end_date)
        for tag in normalize_sensor_tags(tag_list):
            yield by_name[tag.name].window(start_ns, end_ns)


class InfluxDataProvider(GordoBaseDataProvider):
    """The JAX package's Influx reader, kept so a config naming it loads;
    reading raises: the port has no Influx client."""

    @capture_args
    def __init__(self, measurement: str, value_name: str = "Value", tag_key: str = "tag",
                 fields_are_tags: bool = False, where_tags: Optional[Dict[str, str]] = None,
                 uri: Optional[str] = None, api_key: Optional[str] = None,
                 api_key_header: str = "Ocp-Apim-Subscription-Key", client=None, **kwargs):
        self.measurement = measurement

    def load_series(self, train_start_date, train_end_date, tag_list):
        raise NotImplementedError(
            "InfluxDataProvider is not ported to gordo_tpu_torch: it needs an Influx client and a network; "
            "export the data as CSV and use FileDataProvider"
        )


PROVIDERS = {
    cls.__name__: cls
    for cls in (RandomDataProvider, FileDataProvider, ListBackedDataProvider, InfluxDataProvider)
}
