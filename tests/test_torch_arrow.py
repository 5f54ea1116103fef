"""The port's Arrow IPC wire format against the JAX package's, on the CPU.

- ``wire/arrow_codec.py::encode_table``: the port's bytes, read by
  pyarrow, equal (``check_metadata=True``) the table JAX's encoder writes
  for the same columns: UTC, naive, Oslo and ``+01:00`` datetime indexes
  in four units and an int index; string ``start``, an all-``None``
  ``end`` (pyarrow's ``null``), f32, f64, int64 and bool columns, NaN as a
  value; ``gordo:meta``;
- ``decode_frames`` and ``decode_response`` on JAX's ``encode_request``
  bodies (with and without ``y``), on pyarrow's multi-batch streams, on
  columns with nulls (a NaN-filled copy) and on JAX's responses; a
  null-free numeric column of a one-batch body is a view of it;
- what the codec does not read (compressed bodies, dictionaries, other
  types, nanoseconds below the microsecond) and malformed bodies raise
  ``ArrowDecodeError``, and the app answers 400 with a JSON error body;
  seeded corruptions of a body raise nothing else;
- ``pack_streams`` byte-equal to JAX's, and ``unpack_streams``' refusals;
- the port's app against the JAX app, Arrow in and out on
  ``/prediction``, ``/anomaly/prediction``, the fleet route and stream
  ingest (the collection of ``tests/test_torch_serving.py``): the same
  status, content type, schema and envelope, and the frames within
  rtol 1e-5 / atol 1e-6 for the forward's columns and the forward's error
  carried through for the columns past it (``tests/test_torch_engine.py``);
  the index unit written back is JAX's: the request's for an Arrow body,
  the ISO parse's (``us``) for a JSON one;
- a negotiation table of ``Accept`` headers on which both servers select
  the same format (parquet a file on the per-model routes, 406 on the
  fleet route).
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from gordo_tpu.server.wire import arrow_codec as jax_arrow
from gordo_tpu.server.wire.columns import WireColumn as JaxColumn, WireTable as JaxTable
from gordo_tpu_torch.server.wire import arrow_codec
from gordo_tpu_torch.server.wire.assemble import WireColumn, WireTable
from tests.test_torch_serving import (  # noqa: F401 - module fixtures, made again for this module
    PROJECT,
    REVISION,
    TAGS,
    _frame,
    clients,
    collections,
    stream_clients,
)

RTOL, ATOL = 1e-5, 1e-6
ARROW = "application/vnd.apache.arrow.stream"
FORWARD_COLUMNS = ("start", "end", "model-input", "model-output")


def _read(body: bytes) -> pa.Table:
    return pa.ipc.open_stream(body).read_all()


# -- encode_table ---------------------------------------------------------------------------

INDEXES = {
    "utc-us": lambda: pd.date_range("2020-01-01", periods=6, freq="10min", tz="UTC"),
    "utc-ns": lambda: pd.date_range("2020-01-01", periods=6, freq="10min", tz="UTC", unit="ns"),
    "utc-s": lambda: pd.date_range("2020-01-01", periods=6, freq="10min", tz="UTC", unit="s"),
    "naive-ms": lambda: pd.date_range("2020-01-01", periods=6, freq="10min", unit="ms"),
    "oslo": lambda: pd.date_range("2020-06-01", periods=6, freq="h", tz="Europe/Oslo"),
    "offset": lambda: pd.DatetimeIndex(pd.to_datetime(
        [f"2020-01-01T0{i}:00:00+01:00" for i in range(6)], format="ISO8601")),
    "int": lambda: pd.Index(np.arange(10, 16, dtype=np.int64)),
}


def _port_index(index: pd.Index):
    """A pandas index as the port's: datetimes (or ints) and the unit."""
    if isinstance(index, pd.DatetimeIndex):
        return list(index.to_pydatetime()), index.unit
    return index.tolist(), None


def _columns(index: pd.Index, with_nan: bool):
    rng = np.random.RandomState(0)
    out32 = rng.rand(len(index), 2).astype(np.float32)
    total = rng.rand(len(index))
    if with_nan:
        total[1] = np.nan
    starts = [t.isoformat() for t in index] if isinstance(index, pd.DatetimeIndex) else [None] * len(index)
    return [
        ("start", "", starts),
        ("end", "", [None] * len(index)),
        ("model-output", "tag/1", out32[:, 0]),
        ("model-output", "tag-2", out32[:, 1]),
        ("total-anomaly-unscaled", "", total),
        ("counts", "", np.arange(len(index), dtype=np.int64)),
        ("flags", "", np.arange(len(index)) % 2 == 0),
    ]


@pytest.mark.parametrize("kind", list(INDEXES))
def test_encode_table_matches_jax(kind):
    """pyarrow reads the port's stream as the table JAX's encoder writes:
    schema, field and schema metadata, values; NaN stays a value."""
    index = INDEXES[kind]()
    columns = _columns(index, with_nan=False)
    extra = {"time-seconds": "0.0123", "revision": REVISION}
    expected = _read(jax_arrow.encode_table(JaxTable(index, [JaxColumn(*c) for c in columns]), extra))
    values, unit = _port_index(index)
    got = _read(arrow_codec.encode_table(WireTable(values, [WireColumn(*c) for c in columns], unit), extra))
    assert got.schema.equals(expected.schema, check_metadata=True), (got.schema, expected.schema)
    assert got.equals(expected, check_metadata=True)
    # NaN is a value: no nulls, the same bits (Table.equals holds NaN != NaN)
    nan_columns = _columns(index, with_nan=True)
    expected = _read(jax_arrow.encode_table(JaxTable(index, [JaxColumn(*c) for c in nan_columns])))
    got = _read(arrow_codec.encode_table(WireTable(values, [WireColumn(*c) for c in nan_columns], unit)))
    assert got.schema.equals(expected.schema, check_metadata=True)
    assert got.column("total-anomaly-unscaled").null_count == 0
    np.testing.assert_array_equal(got.column("total-anomaly-unscaled").to_numpy(),
                                  expected.column("total-anomaly-unscaled").to_numpy())


def test_encode_table_unit_defaults_to_the_iso_parse():
    """A table without a unit (a JSON request's) writes ``us``, the unit of
    the JAX server's ISO-parsed index."""
    keys = [f"2020-03-01T00:{10 * i:02d}:00+00:00" for i in range(3)]
    parsed = pd.to_datetime(pd.Index(keys), format="ISO8601")
    expected = _read(jax_arrow.encode_table(JaxTable(parsed, [JaxColumn("x", "", np.ones(3))])))
    got = _read(arrow_codec.encode_table(WireTable(list(parsed.to_pydatetime()), [WireColumn("x", "", np.ones(3))])))
    assert got.schema.field("__index__").type == expected.schema.field("__index__").type == pa.timestamp("us", "UTC")


# -- decode_frames / decode_response -----------------------------------------------------------


@pytest.mark.parametrize("kind", list(INDEXES))
@pytest.mark.parametrize("with_y", [False, True], ids=["x", "xy"])
def test_decode_frames_of_jax_requests(kind, with_y):
    """JAX's ``encode_request`` bodies: the x and y columns, their dtypes,
    and the index with its unit; a column is a view of the body."""
    index = INDEXES[kind]()
    rng = np.random.RandomState(1)
    X = pd.DataFrame(rng.rand(len(index), 3).astype(np.float32), index=index, columns=["a", "b", "c"])
    y = pd.DataFrame(rng.rand(len(index), 2), index=index, columns=["a", "b"]) if with_y else None
    body = jax_arrow.encode_request(X, y)
    x_cols, y_cols, got_index = arrow_codec.decode_frames(body)
    jax_x, jax_y, jax_index = jax_arrow.decode_frames(body)
    assert list(x_cols) == list(jax_x) and list(y_cols) == list(jax_y)
    for mine, theirs in ((x_cols, jax_x), (y_cols, jax_y)):
        for name, values in theirs.items():
            assert mine[name].dtype == values.dtype
            np.testing.assert_array_equal(mine[name], values)
    assert not x_cols["a"].flags.owndata  # a view of the body
    assert (got_index.values, got_index.unit) == _port_index(jax_index)
    frame = arrow_codec.frame_from_columns(x_cols, got_index, ["c", "a"])
    assert frame.columns == ["c", "a"] and frame.values.dtype == np.float32
    np.testing.assert_array_equal(frame.values, X[["c", "a"]].to_numpy())


def test_decode_frames_sorts_and_numbers_rows():
    """A shuffled index is sorted with its rows; a body without an index
    numbers its rows; a full-width positional rename is taken and a
    narrower body refused with JAX's message."""
    index = pd.date_range("2020-01-01", periods=5, freq="min", tz="UTC")[[3, 0, 4, 1, 2]]
    X = pd.DataFrame({"a": np.arange(5.0), "b": np.arange(5.0) * 2}, index=index)
    frame = arrow_codec.frame_from_columns(*_xi(jax_arrow.encode_request(X)), ["x", "y"])
    assert frame.index == sorted(index.to_pydatetime()) and frame.columns == ["x", "y"]
    np.testing.assert_array_equal(frame.values[:, 0], [1.0, 3.0, 4.0, 0.0, 2.0])
    table = pa.table({"a": [1.0, 2.0]})
    frame = arrow_codec.frame_from_columns(*_xi(_ipc(table)), ["a"])
    assert frame.index == [0, 1] and frame.unit is None
    with pytest.raises(arrow_codec.FrameError, match=r"Unexpected features: was expecting \['a', 'b', 'c'\]"):
        arrow_codec.frame_from_columns(*_xi(_ipc(table)), ["a", "b", "c"])


def _xi(body):
    x_cols, _, index = arrow_codec.decode_frames(body)
    return x_cols, index


def _ipc(*batches, schema=None, options=None) -> bytes:
    if isinstance(batches[0], pa.Table):
        schema = batches[0].schema
        batches = batches[0].to_batches()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, schema or batches[0].schema, options=options) as writer:
        for batch in batches:
            writer.write_batch(batch)
    return sink.getvalue().to_pybytes()


def test_decode_multi_batch_and_nulls_as_pyarrow():
    """Two batches are concatenated; nulls are NaN in a float copy (ints
    become float64), ``None`` in strings, bools and a null column."""
    schema = pa.schema([
        pa.field("__index__", pa.timestamp("us", "UTC"), metadata={b"gordo:role": b"index"}),
        pa.field("f32", pa.float32()), pa.field("i64", pa.int64()), pa.field("s", pa.string()),
        pa.field("b", pa.bool_()), pa.field("n", pa.null()), pa.field("t", pa.float64(), metadata={b"gordo:role": b"y"}),
    ])
    times = pd.date_range("2020-01-01", periods=6, freq="min", tz="UTC")
    data = {
        "f32": pa.array([1.0, None, 3.0, 4.0, None, 6.0], pa.float32()),
        "i64": pa.array([1, 2, None, 4, 5, 6], pa.int64()),
        "s": pa.array(["a", None, "ccc", "", "é", None]),
        "b": pa.array([True, False, None, True, True, False]),
        "n": pa.nulls(6),
        "t": pa.array(np.linspace(0, 1, 6)),
    }
    table = pa.Table.from_arrays([pa.array(times)] + list(data.values()), schema=schema)
    body = _ipc(*table.slice(0, 2).to_batches(), *table.slice(2).to_batches(), schema=schema)
    x_cols, y_cols, index = arrow_codec.decode_frames(body)
    jax_x, jax_y, jax_index = jax_arrow.decode_frames(body)
    assert index.values == list(jax_index.to_pydatetime())
    for name, values in {**jax_x, **jax_y}.items():
        mine = {**x_cols, **y_cols}[name]
        assert mine.dtype == values.dtype, name
        if values.dtype == object:
            assert mine.tolist() == values.tolist(), name
        else:
            np.testing.assert_array_equal(mine, values, err_msg=name)


def test_decode_response_of_jax_responses():
    """JAX's response stream decodes to the same columns under their
    (group, sub), the index with its unit and the envelope."""
    index = INDEXES["utc-ns"]()
    columns = _columns(index, with_nan=True)
    body = jax_arrow.encode_table(JaxTable(index, [JaxColumn(*c) for c in columns]), {"revision": "7"})
    table, extra = arrow_codec.decode_response(body)
    frame, jax_extra = jax_arrow.decode_response(body)
    assert extra == jax_extra == {"revision": "7"}
    assert (table.index, table.unit) == (list(frame.index.to_pydatetime()), "ns")
    assert [(c.group, c.sub) for c in table.columns] == list(frame.columns)
    for column in table.columns:
        expected = frame[(column.group, column.sub)].to_numpy()
        if expected.dtype == object:
            assert list(column.values) == list(expected)
        else:
            assert column.values.dtype == expected.dtype
            np.testing.assert_array_equal(column.values, expected)


def _compressed() -> bytes:
    return _ipc(pa.table({"a": np.arange(100.0)}), options=pa.ipc.IpcWriteOptions(compression="zstd"))


REFUSED = {
    "compressed": (_compressed, "BodyCompression"),
    "dictionary": (lambda: _ipc(pa.table({"a": pa.array(["x", "y", "x"]).dictionary_encode()})), "Dictionary"),
    "list-type": (lambda: _ipc(pa.table({"a": pa.array([[1.0], [2.0]])})), "Arrow type List"),
    "sub-microsecond": (lambda: _ipc(pa.table({"__index__": pa.array(np.array([1, 2], "datetime64[ns]")),
                                               "a": [1.0, 2.0]})), "Nanosecond"),
    "schema-only": (lambda: _schema_only(), "Empty Arrow IPC body"),
    "garbage": (lambda: b"ARROW1\x00", "Malformed"),
    "truncated": (lambda: _ipc(pa.table({"a": np.arange(10.0)}))[:-40], "Malformed"),
    "no-x": (lambda: _ipc(pa.table({"__index__": pa.array([1, 2])})), 'Cannot predict without "X"'),
}


def _schema_only() -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, pa.schema([("a", pa.float64())])):
        pass
    return sink.getvalue().to_pybytes()


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_bodies(case, clients):
    """Each body raises ``ArrowDecodeError`` naming what is not read; on
    ``/prediction`` the port answers 400 with a JSON error body."""
    make, message = REFUSED[case]
    body = make()
    with pytest.raises(arrow_codec.ArrowDecodeError, match=message):
        arrow_codec.decode_frames(body)
    _, port_client = clients
    response = port_client.post(f"/gordo/v0/{PROJECT}/machine-1/prediction", data=body, content_type=ARROW)
    assert response.status_code == 400 and response.mimetype == "application/json"
    assert message in json.loads(response.get_data())["message"]


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_bodies_raise_only_decode_errors(seed):
    """A body with a few bytes overwritten (sizes, offsets, text, types)
    decodes or raises ``ArrowDecodeError`` (400), never another error."""
    import random

    table = pa.table({"__index__": pa.array(np.arange(5)), "s": pa.array(["ab", None, "c", "", "é"]),
                      "n": pa.nulls(5), "a": np.linspace(0, 1, 5), "b": [True, False, None, True, False]})
    body = _ipc(table)
    rng = random.Random(seed)
    for _ in range(250):
        corrupt = bytearray(body)
        for _ in range(rng.randrange(1, 6)):
            corrupt[rng.randrange(len(corrupt))] = rng.randrange(256)
        try:
            arrow_codec.decode_frames(bytes(corrupt))
        except arrow_codec.ArrowDecodeError:
            pass


# -- the fleet container ----------------------------------------------------------------------


def test_pack_streams_byte_equal_to_jax():
    entries = {"machine-1": b"\x01\x02", "naïve": b"", "m" * 300: bytes(range(256))}
    for extra in (None, {"errors": {"x": {"status": 404}}, "revision": "1", "t": pd.Timestamp("2020-01-01")}):
        packed = arrow_codec.pack_streams(entries, extra)
        assert packed == jax_arrow.pack_streams(entries, extra)
        assert arrow_codec.unpack_streams(packed) == jax_arrow.unpack_streams(packed)


@pytest.mark.parametrize("body,message", [
    (b"GDTAF", "Not a gordo Arrow fleet container"),
    (b"NOTGDT\x00\x00\x00\x00", "Not a gordo Arrow fleet container"),
    (b"GDTAF1\x01\x00\x00\x00\x05\x00\x00\x00ab", "Malformed fleet container|Truncated"),
    (b"GDTAF1\x01\x00\x00\x00\x01\x00\x00\x00a\xff\x00\x00\x00\x00\x00\x00\x00", "Truncated fleet container entry"),
])
def test_unpack_streams_refusals_match_jax(body, message):
    for codec in (arrow_codec, jax_arrow):
        with pytest.raises(codec.ArrowDecodeError, match=message):
            codec.unpack_streams(body)


# -- the apps -----------------------------------------------------------------------------------


def _request_frame(tags, rows, seed, unit="us", dtype=np.float64):
    """A request frame as a pandas frame: a shuffled UTC index in
    ``unit``, a NaN reading."""
    frame = pd.DataFrame(_frame(tags, rows, seed)).astype(dtype)
    frame.index = pd.to_datetime(frame.index, format="ISO8601").as_unit(unit)
    return frame


def _derived_atol(expected: pa.Table) -> float:
    """The forward's error carried through the columns past it."""
    outputs = [expected.column(i).to_numpy() for i, f in enumerate(expected.schema)
               if (f.metadata or {}).get(b"gordo:group") == b"model-output"]
    largest = max(float(np.nanmax(np.abs(o))) for o in outputs)
    return (ATOL + RTOL * largest) * 10.0  # the error scaler's scale_ is at most 10 here


def _same_table(expected: pa.Table, got: pa.Table, drop_meta=("time-seconds",)):
    """The same schema (field metadata exact, ``gordo:meta`` but for
    ``drop_meta``), strings and nulls exact, numbers within tolerance."""
    assert got.schema.remove_metadata().equals(expected.schema.remove_metadata()), (got.schema, expected.schema)
    for f_got, f_exp in zip(got.schema, expected.schema):
        assert f_got.metadata == f_exp.metadata, f_got.name
    meta = [{k: v for k, v in json.loads((t.schema.metadata or {}).get(b"gordo:meta", b"{}")).items()
             if k not in drop_meta} for t in (expected, got)]
    assert meta[1] == meta[0]
    derived = _derived_atol(expected) if any(f.name.startswith("model-output") for f in expected.schema) else ATOL
    for i, field in enumerate(expected.schema):
        want, have = expected.column(i).to_numpy(), got.column(i).to_numpy()
        if want.dtype.kind != "f":
            assert have.tolist() == want.tolist(), field.name
            continue
        group = (field.metadata or {}).get(b"gordo:group", b"").decode()
        atol = ATOL if group in FORWARD_COLUMNS else derived
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=atol, err_msg=field.name)


def _both(clients, url, body, content_type=ARROW, accept=ARROW, **kwargs):
    headers = {"Accept": accept} if accept else {}
    return [client.post(url, data=body, content_type=content_type, headers=headers, **kwargs) for client in clients]


@pytest.mark.parametrize("unit", ["us", "ns", "s"])
@pytest.mark.parametrize("route,name", [
    ("prediction", "machine-1"), ("prediction", "machine-3"),
    ("anomaly/prediction", "machine-1"), ("anomaly/prediction", "machine-2"),
])
def test_arrow_routes_match_jax(clients, route, name, unit):
    """Arrow in, Arrow out on the per-model routes: the same status,
    content type, schema (the request's index unit written back), envelope
    and frames; the port decodes its own answer to pyarrow's reading."""
    X = _request_frame(TAGS[name], 24, seed=70, unit=unit, dtype=np.float32)
    y = _request_frame(TAGS[name], 24, seed=71, unit=unit) if route.startswith("anomaly") else None
    url = f"/gordo/v0/{PROJECT}/{name}/{route}"
    expected, got = _both(clients, url, jax_arrow.encode_request(X, y))
    assert (got.status_code, got.mimetype) == (expected.status_code, expected.mimetype) == (200, ARROW)
    assert got.headers["revision"] == expected.headers["revision"] == REVISION
    want, have = _read(expected.get_data()), _read(got.get_data())
    assert have.schema.field("__index__").type == pa.timestamp(unit, "UTC")
    _same_table(want, have)
    table, extra = arrow_codec.decode_response(got.get_data())
    assert extra["revision"] == REVISION and table.unit == unit
    assert table.index == list(have.column("__index__").to_pandas().dt.to_pydatetime())
    stages = dict(entry.split(";dur=") for entry in got.headers["Server-Timing"].split(", "))
    assert {"data_decode", "inference", "serialize"} <= set(stages)


@pytest.mark.parametrize("direction", ["json-in", "arrow-in"])
def test_arrow_and_json_mix(clients, direction):
    """A JSON body answered as Arrow writes the ISO parse's unit (``us``);
    an Arrow body answered as JSON equals the JSON body's JSON answer."""
    name = "machine-2"
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    X, y = _frame(TAGS[name], 20, seed=72), _frame(TAGS[name], 20, seed=73)
    if direction == "json-in":
        expected, got = _both(clients, url, json.dumps({"X": X, "y": y}), content_type="application/json")
        assert got.status_code == expected.status_code == 200
        want, have = _read(expected.get_data()), _read(got.get_data())
        assert have.schema.field("__index__").type == want.schema.field("__index__").type == pa.timestamp("us", "UTC")
        _same_table(want, have)
        return
    frames = [pd.DataFrame(f) for f in (X, y)]
    for f in frames:
        f.index = pd.to_datetime(f.index, format="ISO8601")
    body = jax_arrow.encode_request(frames[0], frames[1].loc[frames[0].index])  # y rides X's index
    expected, got = _both(clients, url, body, accept="application/json")
    _, via_json = _both(clients, url, json.dumps({"X": X, "y": y}), content_type="application/json", accept=None)
    assert got.status_code == expected.status_code == via_json.status_code == 200
    answer = json.loads(got.get_data())
    assert answer["data"] == json.loads(via_json.get_data())["data"]
    assert json.loads(expected.get_data())["data"].keys() == answer["data"].keys()


@pytest.mark.parametrize("full", [False, True], ids=["lean", "full"])
def test_arrow_fleet_matches_jax(clients, full):
    """A ``GDTAF1`` container in and out: the same machines, errors and
    revision in the trailer, each machine's table as JAX's."""
    streams = {name: jax_arrow.encode_request(_request_frame(tags, 22 + 3 * i, seed=80 + i))
               for i, (name, tags) in enumerate(TAGS.items())}
    streams["machine-2"] = jax_arrow.encode_request(_request_frame(TAGS["machine-2"], 25, seed=84),
                                                    _request_frame(TAGS["machine-2"], 25, seed=85))
    streams["no-such-machine"] = streams["machine-1"]
    streams["machine-3"] = b"not arrow"
    body = jax_arrow.pack_streams(streams, {"full": full})
    expected, got = _both(clients, f"/gordo/v0/{PROJECT}/prediction/fleet", body)
    assert (got.status_code, got.mimetype) == (expected.status_code, expected.mimetype) == (200, ARROW)
    want, want_extra = jax_arrow.unpack_streams(expected.get_data())
    have, have_extra = arrow_codec.unpack_streams(got.get_data())
    assert list(have) == list(want) == ["machine-1", "machine-2"]
    assert have_extra["revision"] == want_extra["revision"] == REVISION
    statuses = {k: v["status"] for k, v in have_extra["errors"].items()}
    assert statuses == {k: v["status"] for k, v in want_extra["errors"].items()} == {
        "machine-3": 400, "no-such-machine": 404}
    assert have_extra["errors"]["no-such-machine"] == want_extra["errors"]["no-such-machine"]
    for name in want:
        _same_table(_read(want[name]), _read(have[name]))
    assert any(n.startswith("anomaly-confidence/") for n in _read(have["machine-1"]).column_names) == full


def test_arrow_stream_ingest_matches_jax(stream_clients):
    """Stream ingest of Arrow containers: the same acks, per-machine errors
    and events as the JAX server's."""
    from tests.test_torch_serving import _events, _same_events

    url = f"/gordo/v0/{PROJECT}/stream/arrow-1/ingest"
    batches = [
        {"machine-1": _request_frame(TAGS["machine-1"], 20, seed=90), "machine-3": _request_frame(TAGS["machine-3"], 9, seed=91),
         "no-such-machine": _request_frame(TAGS["machine-1"], 4, seed=92)},
        {"machine-1": _request_frame(TAGS["machine-1"], 12, seed=93)},
    ]
    for i, batch in enumerate(batches):
        streams = {name: jax_arrow.encode_request(frame) for name, frame in batch.items()}
        if i == 0:
            streams["machine-2"] = b"\x00\x01"  # a bad body errors alone (the messages are each codec's)
        expected, got = _both(stream_clients, url, jax_arrow.pack_streams(streams), accept=None)
        assert got.status_code == expected.status_code == 200
        want, have = json.loads(expected.get_data()), json.loads(got.get_data())
        for ack in (want, have):
            ack["errors"].get("machine-2", {}).pop("error", None)
        assert have == want
    _same_events(_events(stream_clients[0], "arrow-1", 6), _events(stream_clients[1], "arrow-1", 6))
    for body in (b"ARROW1\x00", jax_arrow.pack_streams({})):
        statuses = [r.status_code for r in _both(stream_clients, url, body, accept=None)]
        assert statuses == [400, 400]


NEGOTIATION = [
    (ARROW, "arrow"),
    (f"{ARROW};q=0.5, application/json", "json"),
    (f"application/json;q=0.5, {ARROW}", "arrow"),
    (f"{ARROW}, application/x-parquet", "arrow"),
    (f"application/x-parquet;q=0.9, {ARROW};q=0.5", "parquet"),
    (f"*/*, {ARROW}", "json"),
    (f"application/*;q=0.2, {ARROW};q=0.1", "json"),
    (f"{ARROW};q=0", "406"),
    ("text/csv", "406"),
]


@pytest.mark.parametrize("accept,chosen", NEGOTIATION)
@pytest.mark.parametrize("route", ["anomaly", "fleet"])
def test_negotiation_with_arrow(clients, accept, chosen, route):
    """Both servers select the same format for each ``Accept`` header:
    parquet answers a file on the anomaly route and 406 on the fleet
    route."""
    X = _frame(TAGS["machine-1"], 8, seed=95)
    url, payload = {
        "anomaly": (f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction", {"X": X, "y": X}),
        "fleet": (f"/gordo/v0/{PROJECT}/prediction/fleet", {"X": {"machine-1": X}}),
    }[route]
    expected, got = _both(clients, url, json.dumps(payload), content_type="application/json", accept=accept)
    types = {"json": "application/json", "arrow": ARROW, "parquet": "application/octet-stream"}
    if chosen == "406" or (chosen == "parquet" and route == "fleet"):
        assert got.status_code == expected.status_code == 406
    else:
        assert got.status_code == expected.status_code == 200
        assert got.mimetype == expected.mimetype == types[chosen]
