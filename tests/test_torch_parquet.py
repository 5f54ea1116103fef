"""The port's parquet (``gordo_tpu_torch/utils/parquet.py``, its Thrift and
snappy codecs, ``server/wire/parquet_codec.py``, ``server/multipart.py``)
against pyarrow and the JAX package, on the CPU.

- The reader against ``pyarrow.parquet.read_table(...).to_pandas()`` on
  files pyarrow writes: compression none, snappy and gzip; dictionary
  pages on and off; data pages v1 and v2; small row groups and pages;
  f32, f64 and int64 columns with nulls, strings; UTC, Oslo and naive
  indexes in ms, us and ns; a RangeIndex file with a timestamp column.
  Values equal to the bit (NaN where pyarrow has NaN), the index to the
  tick, the labels equal.
- pyarrow reads the port's writer back to the frame pandas writes for the
  same data (``assert_frame_equal``: dtypes, index unit and zone, labels).
- What is not read raises ``ParquetDecodeError``: zstd, lz4 and brotli
  pages, DELTA_BINARY_PACKED and BYTE_STREAM_SPLIT, a nested column; and
  the routes answer 400.
- The snappy codec round-trips with pyarrow's both ways (a hypothesis
  property) and decodes pyarrow's own snappy blocks; malformed blocks
  raise. The Thrift codec round-trips and reads the compact types the
  parquet structs do not use (a newer writer's fields are skipped).
- The committed fixtures under ``tests/data/parquet/`` decode to the
  numbers written beside them.
- ``FileDataProvider`` on parquet: the JAX dataset and the port's give the
  same ``X``, ``y`` and index on a wide file (the index, a
  ``timestamp_column``, a ``tag_column_map``), a naive file and a per-tag
  directory (rtol 1e-12, as ``tests/test_torch_dataset.py``).
- The two apps over ``tests/test_torch_serving.py``'s collection answer
  the same parquet requests (a raw body on ``/prediction``, a multipart
  form with ``X`` and ``y`` on ``/anomaly/prediction``, ``?format=parquet``
  and an ``Accept`` that prefers parquet): the same frame by
  ``pd.read_parquet``, dtypes and index unit equal, numbers within the
  forward's rtol 1e-5 / atol 1e-6 and the anomaly columns' derived bound
  (``tests/test_torch_arrow.py``); 406 on the fleet route in both; the
  JAX client with ``use_parquet=True`` scores a machine on the port.
- ``examples/config-file-data.yaml``, its path pointed at a parquet file
  in a temporary directory, builds one machine on the port on the CPU
  (epochs cut from 10 to 2, the month cut to four days).
"""

import io
import json
import os
import struct
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.multipart import form_files
from gordo_tpu_torch.server.wire import (
    dataframe_from_parquet_bytes,
    dataframe_into_parquet_bytes,
    table_from_parquet_bytes,
)
from gordo_tpu_torch.utils import parquet, snappy
from gordo_tpu_torch.utils.parquet import ParquetDecodeError
from gordo_tpu_torch.utils.thrift_compact import read_struct, write_struct
from tests.test_torch_dataset import _assert_same_data, _both
from tests.test_torch_serving import (  # noqa: F401 - module fixtures, made again for this module
    PROJECT,
    TAGS,
    WSGISession,
    _frame,
    clients,
    collections,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "parquet"
RTOL, ATOL = 1e-5, 1e-6
FORWARD_COLUMNS = ("start", "end", "model-input", "model-output")


def _pyarrow_bytes(frame: pd.DataFrame, **kwargs) -> bytes:
    buf = io.BytesIO()
    frame.to_parquet(buf, **kwargs)
    return buf.getvalue()


def _assert_reads_as_pyarrow(data: bytes):
    """The port's frame equals pyarrow's reading: labels, index, values."""
    want = pq.read_table(io.BytesIO(data)).to_pandas()
    got = parquet.read_frame(data)
    assert got.labels == list(want.columns)
    for label, column in zip(got.labels, got.columns):
        expected = want[label]
        if expected.dtype.kind in "fiub":
            assert column.values.dtype == expected.dtype, label
            np.testing.assert_array_equal(column.values, expected.to_numpy(), err_msg=str(label))
        elif isinstance(expected.dtype, pd.DatetimeTZDtype) or expected.dtype.kind == "M":
            np.testing.assert_array_equal(parquet.timestamp_ns(column), pd.DatetimeIndex(expected).as_unit("ns").asi8)
        else:
            assert [None if v is None or v != v else v for v in column.values] == [
                None if v is None or v != v else v for v in expected.tolist()], label
    if isinstance(want.index, pd.DatetimeIndex):
        assert got.index.kind == "timestamp" and got.index.unit == want.index.unit
        np.testing.assert_array_equal(parquet.timestamp_ns(got.index), want.index.as_unit("ns").asi8)
        assert (got.index.tz is None) == (want.index.tz is None)
        if want.index.tz is not None:
            assert got.index.tz == str(want.index.tz)
    else:
        np.testing.assert_array_equal(got.index.values, want.index.to_numpy())
    return got


def _mixed_frame(rows: int, seed: int, index: pd.Index) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    frame = pd.DataFrame({
        "f64": rng.randn(rows),
        "f32": rng.randn(rows).astype(np.float32),
        "i64": rng.randint(-1000, 1000, rows).astype(np.int64),
        "repeats": np.round(rng.rand(rows) * 4) / 4,  # few values: dictionary pages
        "text": [f"row-{i % 7}" for i in range(rows)],
    }, index=index)
    frame.loc[frame.index[3], "f64"] = np.nan
    frame.loc[frame.index[5], "f32"] = np.nan
    return frame


WRITER_OPTIONS = {
    "default": {},
    "none": {"compression": "none"},
    "gzip": {"compression": "gzip"},
    "plain": {"use_dictionary": False},
    "v2": {"data_page_version": "2.0"},
    "v2-gzip-plain": {"data_page_version": "2.0", "compression": "gzip", "use_dictionary": False},
    "small-groups": {"row_group_size": 97, "data_page_size": 512},
    "small-groups-v2": {"row_group_size": 50, "data_page_size": 256, "data_page_version": "2.0"},
}


@pytest.mark.parametrize("options", list(WRITER_OPTIONS))
def test_reader_matches_pyarrow(options):
    index = pd.date_range("2020-01-01", periods=600, freq="10min", tz="UTC")
    frame = _mixed_frame(600, 1, index)
    _assert_reads_as_pyarrow(_pyarrow_bytes(frame, **WRITER_OPTIONS[options]))


def test_int_column_with_nulls_reads_as_float():
    table = pa.table({"n": pa.array([1, None, 3], pa.int64()), "b": pa.array([True, None, False])})
    buf = io.BytesIO()
    pq.write_table(table, buf)
    got = parquet.read_table(buf.getvalue())
    np.testing.assert_array_equal(got.columns[0].values, [1.0, np.nan, 3.0])
    assert got.columns[1].values.tolist() == [True, None, False]


@pytest.mark.parametrize("tz", ["UTC", "Europe/Oslo", None])
@pytest.mark.parametrize("unit", ["ms", "us", "ns"])
def test_index_zones_and_units(tz, unit):
    index = pd.date_range("2020-03-28", periods=120, freq="37min", tz=tz, unit=unit)
    got = _assert_reads_as_pyarrow(_pyarrow_bytes(_mixed_frame(120, 2, index)))
    assert got.index.unit == unit


def test_range_index_with_a_timestamp_column():
    stamps = pd.date_range("2020-01-01", periods=50, freq="h", tz="UTC")
    frame = pd.DataFrame({"time": stamps, "value": np.arange(50.0)})
    got = _assert_reads_as_pyarrow(_pyarrow_bytes(frame))
    assert got.index.kind == "range" and got.columns[0].kind == "timestamp"


@pytest.mark.parametrize("codec", ["zstd", "lz4", "brotli"])
def test_other_codecs_raise(codec):
    data = _pyarrow_bytes(pd.DataFrame({"a": np.arange(10.0)}), compression=codec)
    with pytest.raises(ParquetDecodeError, match=codec.upper()):
        parquet.read_table(data)


@pytest.mark.parametrize("encoding", ["DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT"])
def test_other_encodings_raise(encoding):
    table = pa.table({"a": pa.array(np.arange(40, dtype=np.int64))})
    buf = io.BytesIO()
    pq.write_table(table, buf, use_dictionary=False, column_encoding={"a": encoding})
    with pytest.raises(ParquetDecodeError, match=encoding):
        parquet.read_table(buf.getvalue())


def test_nested_column_raises():
    buf = io.BytesIO()
    pq.write_table(pa.table({"a": pa.array([[1.0], [2.0, 3.0]])}), buf)
    with pytest.raises(ParquetDecodeError, match="ested|epeated"):
        parquet.read_table(buf.getvalue())


@pytest.mark.parametrize("data", [b"", b"PAR1", b"PAR1" + bytes(20) + b"PAR1", b"not parquet at all"])
def test_malformed_raises(data):
    with pytest.raises(ParquetDecodeError):
        parquet.read_table(data)


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_files_raise_only_decode_errors(seed):
    """Seeded corruptions of a file raise ``ParquetDecodeError`` or read:
    nothing else escapes."""
    data = bytearray(_pyarrow_bytes(_mixed_frame(80, 3, pd.RangeIndex(80))))
    rng = np.random.RandomState(seed)
    for _ in range(40):
        corrupt = bytearray(data)
        for position in rng.randint(4, len(data) - 4, 3):
            corrupt[position] = rng.randint(256)
        try:
            parquet.read_frame(bytes(corrupt))
        except ParquetDecodeError:
            pass


# -- the writer -----------------------------------------------------------------------------

WRITER_INDEXES = {
    "utc-us": lambda n: pd.date_range("2020-01-01", periods=n, freq="10min", tz="UTC"),
    "utc-ns": lambda n: pd.date_range("2020-01-01", periods=n, freq="10min", tz="UTC", unit="ns"),
    "oslo-ms": lambda n: pd.date_range("2020-03-29", periods=n, freq="13min", tz="Europe/Oslo", unit="ms"),
    "naive-us": lambda n: pd.date_range("2020-01-01", periods=n, freq="10min"),
}


@pytest.mark.parametrize("kind", list(WRITER_INDEXES))
def test_pyarrow_reads_the_writer(kind):
    """The port's bytes, read by pyarrow, are the frame pandas writes for
    the same data: dtypes, index unit and zone, two-level labels."""
    index = WRITER_INDEXES[kind](300)
    rng = np.random.RandomState(4)
    labels = [("start", ""), ("end", ""), ("model-input", "tag-1"), ("model-output", "tag-1"),
              ("total-anomaly-unscaled", "")]
    columns = [[str(t) for t in index], [None] * len(index), rng.randn(len(index)),
               rng.randn(len(index)).astype(np.float32), np.where(np.arange(len(index)) < 4, np.nan, 1.5)]
    ticks = index.asi8 if index.tz is not None else index.asi8
    data = parquet.write_frame(labels, columns, ticks, index.unit, None if index.tz is None else str(index.tz))
    expected = pd.DataFrame(dict(zip(labels, columns)), index=index)
    expected.columns = pd.MultiIndex.from_tuples(labels)
    want = pd.read_parquet(io.BytesIO(_pyarrow_bytes(expected)))
    got = pd.read_parquet(io.BytesIO(data))
    pd.testing.assert_frame_equal(got, want, check_freq=False)
    assert got.index.unit == index.unit
    back = _assert_reads_as_pyarrow(data)
    assert back.labels == labels


def test_writer_flat_columns_and_range_index():
    frame = pd.DataFrame({"a": np.arange(5.0), "b": np.arange(5, dtype=np.int64), "c": np.arange(5) % 2 == 0})
    data = parquet.write_frame(list(frame.columns), [frame[c].to_numpy() for c in frame.columns], None)
    pd.testing.assert_frame_equal(pd.read_parquet(io.BytesIO(data)), frame)


# -- snappy and thrift ----------------------------------------------------------------------


@settings(max_examples=80, deadline=None)
@given(st.binary(max_size=3000), st.integers(0, 40))
def test_snappy_round_trips(data, repeats):
    """The port's blocks read by pyarrow, and pyarrow's blocks (copies,
    overlapping ones among them, on the repeated inputs) read by the port."""
    data = data * (repeats + 1)
    block = snappy.compress(data)
    assert snappy.decompress(block) == data
    assert pa.decompress(block, decompressed_size=len(data), codec="snappy", asbytes=True) == data
    assert snappy.decompress(pa.compress(data, codec="snappy", asbytes=True)) == data


@pytest.mark.parametrize("seed", range(3))
def test_snappy_decodes_pyarrow_blocks(seed):
    rng = np.random.RandomState(seed)
    for data in (rng.randint(0, 4, 5000).astype(np.uint8).tobytes(), rng.randn(3000).tobytes(),
                 np.repeat(rng.randn(40), 50).tobytes(), b"abcabcab" * 700, bytes(70000)):
        assert snappy.decompress(pa.compress(data, codec="snappy", asbytes=True)) == data


@pytest.mark.parametrize("block", [b"\x05\x00a", b"\x04\x0d\x01", b"\x80", b"\x03\x08ab", b"\xff\xff\xff\x7f\x00a"])
def test_snappy_malformed_raises(block):
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(block)


def test_thrift_round_trips():
    fields = [(1, "i32", -5), (2, "i64", 2**40), (3, "binary", b"\x00\xff"), (5, "i16", -300),
              (20, "bool", False), (21, ("list", "i32"), list(range(-3, 30))),
              (22, ("list", "struct"), [[(1, "binary", "x")], []]), (40, "struct", [(1, "bool", True)])]
    decoded, end = read_struct(write_struct(fields) + b"tail")
    assert decoded == {1: -5, 2: 2**40, 3: b"\x00\xff", 5: -300, 20: False, 21: list(range(-3, 30)),
                       22: [{1: b"x"}, {}], 40: {1: True}}
    assert end == len(write_struct(fields))
    # what the reader skips but a newer writer may send: doubles, bytes, sets, maps, bool lists
    other = bytes([0x17]) + struct.pack("<d", 0.25) + bytes([0x13, 0x7F, 0x1A, 0x25, 0x01, 0x02, 0x1B, 0x01, 0x55,
                                                              0x04, 0x08, 0x19, 0x21, 0x01, 0x02, 0x00])
    assert read_struct(other)[0] == {1: 0.25, 2: 127, 3: [-1, 1], 4: {2: 4}, 5: [True, False]}


# -- the committed fixtures -----------------------------------------------------------------


def test_fixtures_decode_to_their_numbers():
    """Each file under ``tests/data/parquet/`` (written by
    ``scripts/make_parquet_fixtures.py`` with pyarrow) decodes to the
    numbers in its ``.npz`` twin, and pyarrow reads it alike."""
    files = sorted(FIXTURES.glob("*.parquet")) + sorted(FIXTURES.glob("*/*.parquet"))
    assert len(files) >= 5
    for path in files:
        data = path.read_bytes()
        assert len(data) < 64 * 1024
        expected = np.load(path.with_suffix(".npz"))
        frame = parquet.read_frame(data)
        np.testing.assert_array_equal(parquet.timestamp_ns(frame.index) if frame.index.kind == "timestamp"
                                      else frame.index.values, expected["index"])
        numeric = [(str(label), c) for label, c in zip(frame.labels, frame.columns) if c.kind != "timestamp"]
        assert [name for name, _ in numeric] == list(expected["names"])
        np.testing.assert_array_equal(np.column_stack([c.values for _, c in numeric]), expected["values"])
        for label, column in zip(frame.labels, frame.columns):
            if column.kind == "timestamp":
                np.testing.assert_array_equal(parquet.timestamp_ns(column), expected[f"stamps:{label}"])
        _assert_reads_as_pyarrow(data)


# -- FileDataProvider -----------------------------------------------------------------------


def _file_config(path, **provider):
    return {
        "train_start_date": "2020-01-01T05:00:00+00:00",
        "train_end_date": "2020-01-03T17:00:00+00:00",
        "tag_list": ["TAG A", "tag b", "tag-c"],
        "data_provider": {"type": "FileDataProvider", "path": str(path), **provider},
    }


def _wide_frame(naive=False):
    rng = np.random.RandomState(3)
    stamps = pd.date_range("2020-01-01", periods=3 * 24 * 20, freq="3min", tz=None if naive else "UTC")
    frame = pd.DataFrame({"col-a": 10 + rng.randn(len(stamps)), "tag b": 5 * rng.rand(len(stamps)),
                          "tag-c": rng.randn(len(stamps)).cumsum()}, index=stamps)
    frame.iloc[200:450, 2] = np.nan
    return frame.iloc[rng.permutation(len(frame))]  # rows out of order: both sort


@pytest.mark.parametrize("layout", ["index", "timestamp-column", "naive-index", "string-stamps"])
def test_file_provider_wide_parquet(tmp_path, layout):
    frame = _wide_frame(naive=layout == "naive-index")
    provider = {"tag_column_map": {"TAG A": "col-a"}}
    if layout == "timestamp-column":
        frame = frame.rename_axis("time").reset_index()
        provider["timestamp_column"] = "time"
    elif layout == "string-stamps":
        frame = frame.rename_axis("time").reset_index()
        frame["time"] = frame["time"].map(pd.Timestamp.isoformat)
    path = tmp_path / "plant.parquet"
    frame.to_parquet(path)
    X = _assert_same_data(*_both(_file_config(path, **provider)))
    assert 0 < len(X) < 360


def test_file_provider_parquet_tag_directory(tmp_path):
    """One parquet file a tag (the index, a ``ts`` column, a naive file) and
    a CSV beside them, with a column map."""
    rng = np.random.RandomState(5)
    for name, offset, kind in (("TAG A", 0, "index"), ("tag b", 7, "naive"), ("other-c", 13, "column")):
        stamps = pd.date_range("2020-01-01", periods=1500, freq="4min", tz=None if kind == "naive" else "UTC")
        stamps = stamps + pd.Timedelta(minutes=offset)
        frame = pd.DataFrame({"value": 20 + rng.randn(len(stamps))}, index=stamps)
        if kind == "column":
            frame = frame.rename_axis("ts").reset_index()
        frame.to_parquet(tmp_path / f"{name}.parquet", compression="gzip" if kind == "naive" else "snappy")
    config = _file_config(tmp_path, tag_column_map={"tag-c": "other-c"})
    _assert_same_data(*_both(config))


def test_file_provider_parquet_refusal_names_the_file(tmp_path):
    path = tmp_path / "plant.parquet"
    _wide_frame().to_parquet(path, compression="zstd")
    from gordo_tpu_torch.dataset import GordoBaseDataset

    with pytest.raises(ValueError, match="ZSTD"):
        GordoBaseDataset.from_dict(_file_config(path)).get_data()


def test_file_data_example_builds_on_the_port(tmp_path):
    """``examples/config-file-data.yaml`` with its path pointed at a parquet
    file written here: one machine built on the CPU. Cuts: epochs 10 to 2,
    the month's window to four days (576 ten-minute rows)."""
    from gordo_tpu_torch.cli import cli

    text = (REPO / "examples" / "config-file-data.yaml").read_text()
    data = tmp_path / "plant-a.parquet"
    idx = pd.date_range("2020-01-01", "2020-01-05", freq="10min", tz="UTC")
    rng = np.random.RandomState(6)
    pd.DataFrame({f"plant-tag-{i}": rng.rand(len(idx)) for i in (1, 2, 3)}, index=idx).to_parquet(data)
    text = (text.replace("/data/plant-a.parquet", str(data)).replace("epochs: 10", "epochs: 2")
            .replace("train_end_date: 2020-02-01T00:00:00+00:00", "train_end_date: 2020-01-05T00:00:00+00:00"))
    assert str(data) in text and "epochs: 2" in text and "2020-01-05T00:00:00" in text
    config_path = tmp_path / "config.yaml"
    config_path.write_text(text)
    shard = tmp_path / "shard.json"
    assert cli.main(["normalize", str(config_path), "proj", "--output", str(shard)]) == 0
    out = tmp_path / "out" / "1"
    code, builder = cli.build_fleet(str(shard), str(out), "cpu")
    assert code == 0
    with open(out / "plant-a-compressor" / "metadata.json") as f:
        metadata = json.load(f)
    assert metadata["metadata"]["build_metadata"]["dataset"]["dataset_meta"]["row_count"] == 576


# -- the routes -----------------------------------------------------------------------------


def _request_frame(tags, rows, seed, unit="us"):
    frame = pd.DataFrame(_frame(tags, rows, seed))
    frame.index = pd.to_datetime(frame.index, format="ISO8601").as_unit(unit)
    return frame.sort_index()


def _read_frame(body: bytes) -> pd.DataFrame:
    return pd.read_parquet(io.BytesIO(body))


def _same_frame(expected: pd.DataFrame, got: pd.DataFrame, atol: float = ATOL):
    """The same labels, dtypes, index (unit and zone), strings and nulls;
    numbers within the forward's tolerance (RTOL, ``atol``), the columns
    past the forward within the error the forward carries into them (the
    error scaler's ``scale_`` is at most 10 here)."""
    assert list(got.columns) == list(expected.columns)
    assert got.dtypes.tolist() == expected.dtypes.tolist()
    pd.testing.assert_index_equal(got.index, expected.index)
    outputs = expected.xs("model-output", axis=1, level=0).to_numpy(np.float64)
    derived = (atol + RTOL * float(np.nanmax(np.abs(outputs)))) * 10.0
    for label in expected.columns:
        want, have = expected[label].to_numpy(), got[label].to_numpy()
        if want.dtype.kind != "f":
            assert [None if v != v else v for v in have.tolist()] == [None if v != v else v for v in want.tolist()]
            continue
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=atol if label[0] in FORWARD_COLUMNS else derived,
                                   err_msg=str(label))


def _multipart(X: pd.DataFrame, y=None):
    data = {"X": (io.BytesIO(jax_server_utils.dataframe_into_parquet_bytes(X)), "X")}
    if y is not None:
        data["y"] = (io.BytesIO(jax_server_utils.dataframe_into_parquet_bytes(y)), "y")
    return data


@pytest.mark.parametrize("unit", ["us", "ns"])
@pytest.mark.parametrize("name", ["machine-1", "machine-3"])
def test_raw_parquet_prediction_matches_jax(clients, name, unit):
    """A raw ``application/x-parquet`` body on ``/prediction`` answered as
    parquet: the same frame as the JAX app's."""
    X = _request_frame(TAGS[name], 24, seed=100, unit=unit)
    url = f"/gordo/v0/{PROJECT}/{name}/prediction"
    body = jax_server_utils.dataframe_into_parquet_bytes(X)
    expected, got = [client.post(url, data=body, content_type="application/x-parquet",
                                 query_string={"format": "parquet"}) for client in clients]
    assert (got.status_code, got.mimetype) == (expected.status_code, expected.mimetype) == (
        200, "application/octet-stream")
    want, have = _read_frame(expected.get_data()), _read_frame(got.get_data())
    assert have.index.unit == unit
    _same_frame(want, have)
    table = table_from_parquet_bytes(got.get_data())
    assert table.unit == unit and [(c.group, c.sub) for c in table.columns] == list(have.columns)


@pytest.mark.parametrize("how", ["format", "accept"])
@pytest.mark.parametrize("name", ["machine-1", "machine-2"])
def test_multipart_anomaly_matches_jax(clients, name, how):
    """A multipart form of parquet ``X`` and ``y`` on
    ``/anomaly/prediction``, parquet asked for by ``?format`` or by
    ``Accept``: the same frame as the JAX app's, every anomaly column."""
    X, y = _request_frame(TAGS[name], 30, seed=101), _request_frame(TAGS[name], 30, seed=102)
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    kwargs = ({"query_string": {"format": "parquet"}} if how == "format"
              else {"headers": {"Accept": "application/x-parquet, application/json;q=0.5"}})
    expected, got = [client.post(url, data=_multipart(X, y), **kwargs) for client in clients]
    assert got.status_code == expected.status_code == 200
    want, have = _read_frame(expected.get_data()), _read_frame(got.get_data())
    assert "tag-anomaly-scaled" in have.columns.get_level_values(0)
    _same_frame(want, have)
    stages = dict(entry.split(";dur=") for entry in got.headers["Server-Timing"].split(", "))
    assert {"data_decode", "inference", "serialize"} <= set(stages)


def test_multipart_json_answer_matches_json_request(clients):
    """A multipart parquet request answered as JSON equals the JSON
    request's answer on the port, and the JAX app's keys."""
    name = "machine-2"
    X, y = _frame(TAGS[name], 20, seed=103), _frame(TAGS[name], 20, seed=104)
    frames = [pd.DataFrame(f) for f in (X, y)]
    for f in frames:
        f.index = pd.to_datetime(f.index, format="ISO8601")
        f.sort_index(inplace=True)
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    expected, got = [client.post(url, data=_multipart(*frames)) for client in clients]
    via_json = clients[1].post(url, json={"X": X, "y": y})
    assert got.status_code == expected.status_code == via_json.status_code == 200
    assert json.loads(got.get_data())["data"] == json.loads(via_json.get_data())["data"]
    assert json.loads(expected.get_data())["data"].keys() == json.loads(got.get_data())["data"].keys()


@pytest.mark.parametrize("case", ["no-x", "bad-x", "zstd", "fleet"])
def test_parquet_refusals_match_jax(clients, case):
    """No ``X`` file (400 both), a body that is not parquet (400 from the
    port), a zstd body (400 from the port, which does not read it), and
    parquet asked of the fleet route (406 both)."""
    name = "machine-1"
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    X = _request_frame(TAGS[name], 10, seed=105)
    if case == "fleet":
        responses = [client.post(f"/gordo/v0/{PROJECT}/prediction/fleet", json={"X": {name: _frame(TAGS[name], 5, 1)}},
                                 query_string={"format": "parquet"}) for client in clients]
        assert [r.status_code for r in responses] == [406, 406]
        assert json.loads(responses[1].get_data()) == json.loads(responses[0].get_data())
        return
    if case == "no-x":
        responses = [client.post(url, data={"y": (io.BytesIO(b"x"), "y")}) for client in clients]
        assert [r.status_code for r in responses] == [400, 400]
        assert json.loads(responses[1].get_data()) == json.loads(responses[0].get_data())
        return
    body = b"PAR1 not a parquet file PAR1" if case == "bad-x" else _pyarrow_bytes(X, compression="zstd")
    got = clients[1].post(url, data=body, content_type="application/x-parquet")
    assert got.status_code == 400 and got.mimetype == "application/json"
    if case == "zstd":
        assert "ZSTD" in json.loads(got.get_data())["message"]


def test_request_frame_round_trip():
    """The port's request frame written and read back by the port, and by
    pyarrow to the frame pandas writes."""
    X = _request_frame(TAGS["machine-1"], 12, seed=106, unit="ms")
    frame = dataframe_from_parquet_bytes(jax_server_utils.dataframe_into_parquet_bytes(X))
    assert frame.columns == list(X.columns) and frame.unit == "ms"
    np.testing.assert_array_equal(frame.values, X.to_numpy())
    data = dataframe_into_parquet_bytes(frame)
    pd.testing.assert_frame_equal(pd.read_parquet(io.BytesIO(data)), X, check_freq=False)


class ParquetSession(WSGISession):
    """``WSGISession`` with the ``files=`` upload the JAX client's parquet
    requests send."""

    def post(self, url, params=None, json=None, files=None, **kwargs):
        from urllib.parse import urlsplit

        from tests.test_torch_serving import _WSGIResponse

        if files is None:
            return super().post(url, params=params, json=json, **kwargs)
        data = {name: (io.BytesIO(payload), name) for name, payload in files.items()}
        return _WSGIResponse(self.client.post(urlsplit(url).path, query_string=params or {}, data=data))


def test_jax_client_with_parquet_scores_on_the_port(collections):
    """The JAX client as shipped with ``use_parquet=True`` (multipart
    parquet out, ``?format=parquet``, the answer read with pyarrow) scores a
    machine on the port: the frame the JAX app gives it, and to the bit
    the numbers the same client gets from the port over JSON.

    The client sends the machine's own ``RandomDataProvider`` readings, up
    to ~60 where the other tests here send values in [-0.5, 1.5], and the
    forward's f32 error grows with its input: against the JAX app the
    forward's columns are held at RTOL and ATOL times the largest input."""
    from gordo_tpu.client.client import Client as GordoClient
    from gordo_tpu.server import build_app as jax_build_app

    jax_dir, port_dir = collections
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = jax_dir
    try:
        sessions = [ParquetSession(jax_build_app(config={"EXPECTED_MODELS": []})),
                    ParquetSession(build_app(port_dir, device="cpu"))]
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous
    start, end = pd.Timestamp("2020-01-01T06:00:00+00:00"), pd.Timestamp("2020-01-01T12:00:00+00:00")
    results = []
    for session, use_parquet in ((sessions[0], True), (sessions[1], True), (sessions[1], False)):
        client = GordoClient(PROJECT, session=session, use_parquet=use_parquet, batch_size=20)
        (result,) = client.predict(start, end, targets=["machine-1"])
        assert not result.error_messages, result.error_messages
        results.append(result.predictions)
    want, have, via_json = results
    assert len(have) > 20
    scale = float(np.abs(have["model-input"].to_numpy()).max())
    assert scale > 10
    _same_frame(want, have, atol=ATOL * scale)
    # the JSON route names a scalar group's sub by the group
    assert [(g, "" if s == g else s) for g, s in via_json.columns] == list(have.columns)
    np.testing.assert_array_equal(via_json.index.as_unit("ns").asi8, have.index.as_unit("ns").asi8)
    numeric = [i for i, c in enumerate(have.columns) if have[c].dtype.kind == "f"]
    np.testing.assert_array_equal(via_json.iloc[:, numeric].to_numpy(np.float64),
                                  have.iloc[:, numeric].to_numpy(np.float64))


def test_multipart_parser_reads_requests_bodies():
    """The form ``requests`` encodes for ``files=`` (no part Content-Type)."""
    import requests

    prepared = requests.Request("POST", "http://localhost/x", files={"X": b"PAR1x", "y": b"PAR1\r\n--y"},
                                data={"note": "hi"}).prepare()
    assert form_files(prepared.body, prepared.headers["Content-Type"]) == {"X": b"PAR1x", "y": b"PAR1\r\n--y"}
