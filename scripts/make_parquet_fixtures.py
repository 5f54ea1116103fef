#!/usr/bin/env python3
"""
Writes the parquet fixtures of ``tests/data/parquet/`` with pyarrow, and
beside each file an ``.npz`` of the numbers it holds, so that the port's
reader can be checked where pyarrow is not installed (``chip_smoke.py``'s
``[ingress]`` reads ``tags/`` on the card's machine).

    python3 scripts/make_parquet_fixtures.py

Needs pandas and pyarrow. Each file is under 64 KB:

- ``snappy-dict-v1.parquet``: pyarrow's defaults (SNAPPY, dictionary
  pages, data page v1), 20 tags of 288 ten-minute rows read to 0.1, a
  UTC microsecond index;
- ``gzip-v2-plain.parquet``: data page v2, GZIP, no dictionary, a naive
  millisecond index, a float32 and a float64 column with nulls;
- ``none-small-pages.parquet``: UNCOMPRESSED, row groups of 50 rows and
  pages of 256 bytes, an Oslo nanosecond index;
- ``range-index.parquet``: a RangeIndex, a ``time`` column and an int64
  column;
- ``tags/tag-00.parquet`` and ``tags/tag-01.parquet``: one tag each,
  SNAPPY with dictionary pages, ``chip_smoke.TRAIN_ROWS`` ten-minute rows
  from ``chip_smoke.TRAIN_START`` read to 0.1 (the per-tag files of
  ``[ingress]``'s ``file-tags-000``).

The ``.npz`` holds ``index`` (int64 UTC nanoseconds, wall-clock ones for
a naive index, or the RangeIndex's positions), ``names`` (the numeric
columns), ``values`` (their float64 values, ``[rows, columns]``, NaN for
a null) and ``stamps:<name>`` for a timestamp column (int64 UTC
nanoseconds). The data is seeded, so a rerun writes the same numbers.
"""

import os

import numpy as np
import pandas as pd

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "tests", "data", "parquet")
TRAIN_ROWS = 2000  # chip_smoke.TRAIN_ROWS
TRAIN_START = "2020-01-01T00:00:00+00:00"  # chip_smoke.TRAIN_START
LIMIT = 64 * 1024


def readings(seed, rows, n_tags, decimals=1):
    """Sensor-like readings (a level, a daily sine, noise) read to
    ``decimals``: few distinct values, as a quantised sensor gives."""
    rng = np.random.RandomState(seed)
    t = np.arange(rows)[:, None]
    level = rng.uniform(20, 80, n_tags)
    values = level + 5 * np.sin(2 * np.pi * t / 144 + rng.uniform(0, 2 * np.pi, n_tags)) + rng.standard_normal(
        (rows, n_tags))
    return np.round(values, decimals)


def write(frame, name, **options):
    path = os.path.join(OUT, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    frame.to_parquet(path, **options)
    size = os.path.getsize(path)
    assert size < LIMIT, f"{name} is {size} bytes"
    if isinstance(frame.index, pd.DatetimeIndex):
        index = frame.index.as_unit("ns").asi8
    else:
        index = frame.index.to_numpy(np.int64)
    names, columns, stamps = [], [], {}
    for column in frame.columns:
        values = frame[column]
        if isinstance(values.dtype, pd.DatetimeTZDtype) or values.dtype.kind == "M":
            stamps[f"stamps:{column}"] = pd.DatetimeIndex(values).as_unit("ns").asi8
        else:
            names.append(str(column))
            columns.append(values.to_numpy(np.float64))
    np.savez(os.path.splitext(path)[0] + ".npz", index=index, names=np.array(names), values=np.column_stack(columns),
             **stamps)
    print(f"{name}: {size} bytes, {len(frame)} rows x {len(frame.columns)} columns")


def main():
    index = pd.date_range("2020-01-01", periods=288, freq="10min", tz="UTC")
    wide = pd.DataFrame(readings(1, 288, 20), index=index, columns=[f"tag-{j:02d}" for j in range(20)])
    write(wide, "snappy-dict-v1.parquet")

    naive = pd.date_range("2020-02-01", periods=400, freq="5min", unit="ms")
    rng = np.random.RandomState(2)
    mixed = pd.DataFrame({"f32": rng.randn(400).astype(np.float32), "f64": rng.randn(400)}, index=naive)
    mixed.iloc[[3, 77], 0] = np.nan
    mixed.iloc[[5], 1] = np.nan
    write(mixed, "gzip-v2-plain.parquet", compression="gzip", use_dictionary=False, data_page_version="2.0")

    oslo = pd.date_range("2020-03-28", periods=300, freq="17min", tz="Europe/Oslo", unit="ns")
    small = pd.DataFrame(readings(3, 300, 3, decimals=3), index=oslo, columns=["a", "b", "c"])
    write(small, "none-small-pages.parquet", compression="none", row_group_size=50, data_page_size=256)

    stamps = pd.date_range("2020-04-01", periods=120, freq="h", tz="UTC")
    ranged = pd.DataFrame({"time": stamps, "count": np.arange(120, dtype=np.int64) * 3,
                           "value": readings(4, 120, 1)[:, 0]})
    write(ranged, "range-index.parquet")

    train = pd.date_range(TRAIN_START, periods=TRAIN_ROWS, freq="10min")
    for j in range(2):
        per_tag = pd.DataFrame({"value": readings(10 + j, TRAIN_ROWS, 1)[:, 0]}, index=train)
        write(per_tag, os.path.join("tags", f"tag-{j:02d}.parquet"), compression="snappy", use_dictionary=True)


if __name__ == "__main__":
    main()
