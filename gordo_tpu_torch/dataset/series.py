"""
Time series without pandas: a tag's readings as int64 UTC nanoseconds
and float64 values, with the time zone its stamps are read in kept
beside them; and the time arithmetic the dataset layer needs (aware
datetimes to and from nanoseconds, offset strings such as ``10min``).
"""

import datetime
import re
import zoneinfo
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
NS_PER = {
    "ns": 1, "us": 1_000, "ms": 1_000_000, "s": 10**9, "min": 60 * 10**9, "h": 3600 * 10**9, "d": 86400 * 10**9,
}
#: the spellings of the configs (and pandas' offset aliases) for each unit
_UNITS = {
    "ns": "ns", "N": "ns", "us": "us", "U": "us", "ms": "ms", "L": "ms", "s": "s", "S": "s", "sec": "s",
    "min": "min", "T": "min", "m": "min", "h": "h", "H": "h", "hour": "h", "D": "d", "d": "d", "day": "d",
}
_DURATION = re.compile(r"\s*(\d+(?:\.\d*)?)?\s*([A-Za-z]+)\s*")


@dataclass
class Series:
    """One tag's readings: ``stamps`` (int64 UTC ns, ascending), ``values``
    (float64) and the ``tz`` its stamps are read in."""

    name: str
    stamps: np.ndarray
    values: np.ndarray
    tz: datetime.tzinfo

    def __len__(self) -> int:
        return len(self.stamps)

    def window(self, start_ns: int, end_ns: int) -> "Series":
        """The readings in ``[start_ns, end_ns)``."""
        keep = (self.stamps >= start_ns) & (self.stamps < end_ns)
        return Series(self.name, self.stamps[keep], self.values[keep], self.tz)


def normalize_frequency(resolution: str) -> str:
    """
    The legacy offset aliases (``10T``, ``1H``) in the modern spelling, as
    ``gordo_tpu/dataset/datasets.py::normalize_frequency``.

    >>> normalize_frequency("10T"), normalize_frequency("1H"), normalize_frequency("30s")
    ('10min', '1h', '30s')
    """
    for legacy, modern in (("T", "min"), ("H", "h"), ("S", "s"), ("L", "ms")):
        if resolution.endswith(legacy):
            return resolution[: -len(legacy)] + modern
    return resolution


def duration_ns(text: str) -> int:
    """
    An offset string as nanoseconds, as ``pd.Timedelta`` reads the ones
    configs use.

    >>> [duration_ns(s) // 10**9 for s in ("10min", "10T", "2min", "1H", "8h", "30s", "1D")]
    [600, 600, 120, 3600, 28800, 30, 86400]
    """
    match = _DURATION.fullmatch(str(text))
    unit = _UNITS.get(match.group(2)) if match else None
    if unit is None:
        raise ValueError(f"Unsupported duration {text!r}: use a number and one of {sorted(set(_UNITS))}")
    count = float(match.group(1)) if match.group(1) else 1.0
    return int(round(count * NS_PER[unit]))


def parse_datetime(value: Any) -> datetime.datetime:
    """A datetime from a ``datetime`` or an ISO string (naive stays naive)."""
    if isinstance(value, datetime.datetime):
        return value
    if isinstance(value, datetime.date):
        return datetime.datetime(value.year, value.month, value.day)
    text = str(value).strip()
    if text.endswith(("Z", "z")):
        text = text[:-1] + "+00:00"
    return datetime.datetime.fromisoformat(text)


def datetime_ns(value: datetime.datetime) -> int:
    """An aware datetime as UTC nanoseconds since the epoch."""
    delta = value - EPOCH
    return (delta.days * 86400 + delta.seconds) * 10**9 + delta.microseconds * 1000


def ns_datetime(ns: int, tz: datetime.tzinfo) -> datetime.datetime:
    """UTC nanoseconds as a datetime in ``tz`` (to the microsecond)."""
    return (EPOCH + datetime.timedelta(microseconds=int(ns) // 1000)).astimezone(tz)


def resolve_tz(tz: Any) -> datetime.tzinfo:
    """A time zone from its name (``UTC``, ``Europe/Oslo``), an offset
    (``+01:00``) or a ``tzinfo``."""
    if isinstance(tz, datetime.tzinfo):
        return tz
    if tz in (None, "UTC", "utc", "Z"):
        return datetime.timezone.utc
    match = re.fullmatch(r"([-+])(\d\d):?(\d\d)", str(tz))
    if match:
        delta = datetime.timedelta(hours=int(match.group(2)), minutes=int(match.group(3)))
        return datetime.timezone(-delta if match.group(1) == "-" else delta)
    return zoneinfo.ZoneInfo(str(tz))


def local_midnight_ns(ns: int, tz: datetime.tzinfo) -> int:
    """The UTC nanoseconds of midnight, in ``tz``, of the day ``ns`` falls on."""
    local = ns_datetime(ns, tz)
    midnight = datetime.datetime(local.year, local.month, local.day, tzinfo=tz)
    return datetime_ns(midnight)


def tz_of(value: Optional[datetime.datetime]) -> datetime.tzinfo:
    """The time zone of an aware datetime (UTC for a naive one)."""
    if value is None or value.tzinfo is None:
        return datetime.timezone.utc
    return value.tzinfo
