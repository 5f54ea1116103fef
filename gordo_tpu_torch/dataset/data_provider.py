"""
Data providers, ``gordo_tpu/dataset/data_provider.py`` in numpy: each
yields one :class:`~.series.Series` per requested tag.

- :class:`RandomDataProvider`: the seeded synthetic source of the
  examples and tests, bit for bit the JAX provider's (the tag name's
  sha256 seeds a ``RandomState``; stamps are a ``linspace`` of the
  window's UTC nanoseconds, in the start date's time zone).
- :class:`FileDataProvider`: CSV and parquet files (``utils/parquet.py``),
  one wide file of tag columns or a directory of one file per tag; naive
  stamps are read in ``tz``; readings in ``[start, end)``.
- :class:`ListBackedDataProvider`: series held in memory.
- :class:`InfluxDataProvider`: InfluxDB 1.x over HTTP (``influx.py``),
  one query a tag, the JAX provider's InfluxQL.

``to_dict`` writes the JAX package's class paths, so an artifact's
``metadata.json`` reads the same from either package.
"""

import abc
import csv
import hashlib
import os
from datetime import timezone
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..utils import parquet
from ..utils.args import capture_args
from .influx import InfluxQueryClient
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


def _numeric(column: "parquet.ParquetColumn") -> np.ndarray:
    """A parquet column as float64 (NaN for a null); a column of another
    kind stays as it is and fails if a tag reads it."""
    if column.kind in ("float64", "float32", "int64", "int32", "bool") and column.values.dtype != object:
        return column.values.astype(np.float64)
    return column.values


def _float(text: str) -> float:
    text = text.strip()
    return float(text) if text else np.nan


class FileDataProvider(GordoBaseDataProvider):
    """
    Tag readings from CSV or parquet files: ``path`` is one wide file
    whose columns are tags (stamps in ``timestamp_column``, default a
    parquet file's datetime index, else the first column), or a
    directory of ``<tag>.csv``/``<tag>.parquet`` files, each a
    ``timestamp_column`` and a ``value_column`` (default the first two).
    ``tag_column_map`` maps a config tag name to its column or file name;
    naive stamps are read in ``tz`` (default UTC).
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
            return self._read_parquet(path)
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

    def _read_parquet(self, path: str) -> _Frame:
        """A parquet file by the JAX provider's rules: the stamps are the
        pandas index when it holds datetimes, else ``timestamp_column``,
        else the first column; naive stamps are read in ``tz``."""
        with open(path, "rb") as f:
            try:
                frame = parquet.read_frame(f.read())
            except parquet.ParquetDecodeError as exc:
                raise ValueError(f"{path!r}: {exc}") from None
        columns = dict(zip((str(label) for label in frame.labels), frame.columns))
        ts_col = self.timestamp_column
        if ts_col is None and (frame.index is None or frame.index.kind != "timestamp"):
            ts_col = next(iter(columns), None)
        if ts_col is None:
            stamps = frame.index
        elif ts_col not in columns:
            raise ValueError(f"Timestamp column {ts_col!r} not present in {path!r} (columns: {list(columns)})")
        else:
            stamps = columns.pop(ts_col)
        if stamps.kind == "timestamp":
            if (stamps.values == np.iinfo(np.int64).min).any():
                raise ValueError(f"{path!r}: the time stamps hold nulls")
            ns = parquet.timestamp_ns(stamps)
            if stamps.tz is not None:
                tz = timezone.utc if stamps.tz.upper() == "UTC" else resolve_tz(stamps.tz)
            else:  # wall-clock stamps, read in ``tz``
                tz = resolve_tz(self.tz)
                naive = (ns // 1000).astype("datetime64[us]").astype(object).tolist()
                ns = np.array([datetime_ns(d.replace(tzinfo=tz)) for d in naive], np.int64) + ns % 1000
        elif stamps.kind == "string":
            ns, tz = self._stamps(list(stamps.values), path)
        else:
            raise ValueError(f"{path!r}: the time stamps are {stamps.kind}, not datetimes")
        order = np.argsort(ns, kind="stable")
        values = {name: _numeric(column)[order] for name, column in columns.items()}
        return _Frame(ns[order], values, tz)

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
            return Series(tag.name, frame.stamps, _readings(frame.columns[column], tag_file), frame.tz)
        frame = self._wide()
        column = self._column_for(tag)
        if column not in frame.columns:
            raise ValueError(
                f"Tag {tag.name!r} (column {column!r}) not present in {self.path!r} (columns: {list(frame.columns)})"
            )
        return Series(tag.name, frame.stamps, _readings(frame.columns[column], self.path), frame.tz)

    def load_series(self, train_start_date, train_end_date, tag_list):
        _window_check(train_start_date, train_end_date)
        start_ns, end_ns = datetime_ns(train_start_date), datetime_ns(train_end_date)
        for tag in normalize_sensor_tags(tag_list):
            yield self._series_for(tag).window(start_ns, end_ns)


def _readings(values: np.ndarray, path: str) -> np.ndarray:
    if values.dtype != np.float64:
        raise ValueError(f"A tag's column in {path!r} is not numeric ({values.dtype})")
    return values


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
    """
    Tag series from an InfluxDB 1.x database, the JAX provider
    (``gordo_tpu/dataset/data_provider.py:312-470``) over HTTP: one
    ``SELECT`` a tag, the same InfluxQL byte for byte.

    - sensor layout (default): one ``measurement`` whose rows name their
      sensor in the Influx tag ``tag_key``, readings in field
      ``value_name``;
    - field layout (``fields_are_tags``): the sensor names are the
      measurement's fields (what the prediction forwarder writes).

    ``where_tags`` adds ``"key" = 'value'`` conditions. ``client`` is any
    object whose ``query(q)`` answers ``{measurement: (ns stamps,
    values)}``; otherwise ``uri`` (``<user>:<password>@<host>:<port>/<db>``)
    makes an :class:`~.influx.InfluxQueryClient`, with ``api_key`` in the
    ``api_key_header`` header when it is set.
    """

    @capture_args
    def __init__(self, measurement: str, value_name: str = "Value", tag_key: str = "tag",
                 fields_are_tags: bool = False, where_tags: Optional[Dict[str, str]] = None,
                 uri: Optional[str] = None, api_key: Optional[str] = None,
                 api_key_header: str = "Ocp-Apim-Subscription-Key", client=None, **kwargs):
        self.measurement = measurement
        self.value_name = value_name
        self.tag_key = tag_key
        self.fields_are_tags = fields_are_tags
        self.where_tags = where_tags or {}
        self.uri = uri
        self.api_key = api_key
        self.api_key_header = api_key_header
        self.influx_client = client
        if self.influx_client is None and uri:
            headers = {api_key_header: api_key} if api_key else None
            self.influx_client = InfluxQueryClient.from_uri(uri, headers=headers)

    def _require_client(self):
        if self.influx_client is None:
            raise ValueError("InfluxDataProvider has no client; pass uri=... or client=...")
        return self.influx_client

    @staticmethod
    def _escape(identifier: str) -> str:
        """An InfluxQL string literal's text: backslashes first, then
        quotes, so a value cannot close the literal."""
        return identifier.replace("\\", "\\\\").replace("'", "\\'")

    @staticmethod
    def _identifier(name: str) -> str:
        """A double-quoted InfluxQL identifier: backslashes first, then
        double quotes escaped, so a name cannot close its quotes. An
        ordinary name is quoted as the JAX provider quotes it."""
        return '"' + str(name).replace("\\", "\\\\").replace('"', '\\"') + '"'

    def query_text(self, tag: SensorTag, start_ns: int, end_ns: int) -> str:
        """The InfluxQL the JAX provider writes for ``tag`` over
        ``[start_ns, end_ns)``, every identifier escaped (the JAX provider
        quotes its identifiers unescaped, ``ROADMAP.md`` fault 5)."""
        conditions = [f"time >= {start_ns} AND time < {end_ns}"]
        if self.fields_are_tags:
            field = tag.name
        else:
            field = self.value_name
            conditions.append(f"{self._identifier(self.tag_key)} = '{self._escape(tag.name)}'")
        for key, value in self.where_tags.items():
            conditions.append(f"{self._identifier(key)} = '{self._escape(str(value))}'")
        return (f"SELECT {self._identifier(field)} FROM {self._identifier(self.measurement)} "
                f"WHERE {' AND '.join(conditions)}")

    def _query_series(self, tag: SensorTag, train_start_date, train_end_date) -> Series:
        client = self._require_client()
        start_ns, end_ns = datetime_ns(train_start_date), datetime_ns(train_end_date)
        result = client.query(self.query_text(tag, start_ns, end_ns))
        found = result.get(self.measurement) if hasattr(result, "get") else None
        if found is None or len(found[0]) == 0:
            raise ValueError(
                f"No data for tag {tag.name!r} in measurement {self.measurement!r} over "
                f"[{train_start_date}, {train_end_date})"
            )
        stamps, values = np.asarray(found[0], np.int64), np.asarray(found[1], np.float64)
        order = np.argsort(stamps, kind="stable")
        return Series(tag.name, stamps[order], values[order], timezone.utc)

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self.influx_client is not None or bool(self.uri)

    def load_series(self, train_start_date, train_end_date, tag_list):
        _window_check(train_start_date, train_end_date)
        for tag in normalize_sensor_tags(tag_list):
            yield self._query_series(tag, train_start_date, train_end_date)


PROVIDERS = {
    cls.__name__: cls
    for cls in (RandomDataProvider, FileDataProvider, ListBackedDataProvider, InfluxDataProvider)
}
