"""The port's raw-column device transfer (``gordo_tpu_torch/ingest/``)
against the JAX package's (``gordo_tpu/ingest/transfer.py``), on the CPU.

- ``RawColumns`` (columns or a matrix: rows, width, nbytes, the staged
  matrix) equal to JAX's;
- ``to_device`` on both rungs, with row padding and an f64 column: the
  dlpack rung's tensor equal to the host rung's to the bit, and both equal
  to JAX's ``to_device`` (which casts and pads alike); the dlpack rung
  reads the wire columns in place (no host matrix made); a non-contiguous
  column takes the host rung and counts its reason, as in JAX;
- ``ingest_stats()`` with JAX's keys and counts;
- the knobs: ``compiled_enabled`` and ``dlpack_enabled`` (on the CPU the
  dlpack rung never engages unless asked for, as JAX's on a CPU backend);
- the Arrow and parquet decodes keep ``ctx.ingest`` only under JAX's
  conditions (an index in order, names keying into the columns), and
  their frame stays unstacked: its columns are the wire columns;
- an Arrow anomaly request through the port's serving engine: the answer
  of the dlpack rung (forced on, since the CPU never takes it by itself)
  equal to the host rung's to the bit and to the JAX app's within the
  port's f32 tolerance (``tests/test_torch_arrow.py``), the rung counted;
  with ``GORDO_TPU_INGEST_COMPILED=0`` the bucket is host-transformed and
  the answer agrees with the compiled one within the same tolerance.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from gordo_tpu.ingest import transfer as jax_transfer
from gordo_tpu.server.wire import arrow_codec as jax_arrow
from gordo_tpu_torch import ingest
from gordo_tpu_torch.ingest import transfer
from gordo_tpu_torch.server import fleet_store
from gordo_tpu_torch.server import utils as server_utils
from gordo_tpu_torch.server.views import base as views_base
from gordo_tpu_torch.serve import engine as serve_engine
from tests.test_torch_arrow import ARROW, _read, _request_frame, _same_table
from tests.test_torch_serving import (  # noqa: F401 - module fixtures, made again for this module
    PROJECT,
    TAGS,
    clients,
    collections,
)


def _columns(rows=37, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(rows).astype(np.float32), rng.rand(rows), (rng.rand(rows) * 100).astype(np.int64),
            rng.rand(rows).astype(np.float32)]


@pytest.fixture(autouse=True)
def _fresh_stats():
    transfer.reset_ingest_stats()
    jax_transfer.reset_ingest_stats()
    yield
    transfer.reset_ingest_stats()
    jax_transfer.reset_ingest_stats()


@pytest.mark.parametrize("kind", ["columns", "matrix"])
def test_raw_columns_match_jax(kind):
    cols = _columns()
    if kind == "columns":
        port, jax = transfer.RawColumns.from_columns(cols), jax_transfer.RawColumns.from_columns(cols)
    else:
        matrix = np.column_stack(cols)
        port, jax = transfer.RawColumns.from_matrix(matrix), jax_transfer.RawColumns.from_matrix(matrix)
    assert (port.rows, port.width, port.nbytes) == (jax.rows, jax.width, jax.nbytes)
    host = port.host_matrix()
    assert host.dtype == np.float32 and host.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(host, jax.host_matrix())
    assert port.host_matrix() is host  # made once


@pytest.mark.parametrize("padded", [None, 64], ids=["exact", "padded"])
def test_to_device_rungs_bit_equal_and_match_jax(padded):
    """Both rungs give the same bits (an f64 and an int column cast on the
    host first), zero-padded rows; JAX's transfer gives the same values."""
    cols = _columns()
    raw = transfer.RawColumns.from_columns(cols)
    fast = transfer.to_device(raw, padded, dlpack=True, device="cpu")
    host = transfer.to_device(raw, padded, dlpack=False, device="cpu")
    assert fast.dtype == torch.float32 and tuple(fast.shape) == (padded or 37, 4)
    assert torch.equal(fast, host)
    assert not fast[37:].any()
    jax_raw = jax_transfer.RawColumns.from_columns(cols)
    np.testing.assert_array_equal(fast.numpy(), np.asarray(jax_transfer.to_device(jax_raw, padded, dlpack=True)))
    np.testing.assert_array_equal(host.numpy(), np.asarray(jax_transfer.to_device(jax_raw, padded, dlpack=False)))
    stats = transfer.ingest_stats()
    assert stats == {"dlpack_transfers": 1, "host_transfers": 1, "dlpack_columns": 4,
                     "fallback_reasons": {"disabled": 1}}
    assert stats == jax_transfer.ingest_stats()


def test_dlpack_rung_shares_the_wire_buffer():
    """The wire columns are gathered straight into the staging buffer: no
    host matrix is made, and a read-only column (a view of an immutable
    body) is read in place too."""
    col = np.arange(8, dtype=np.float32)
    frozen = np.frombuffer(col.tobytes(), np.float32)
    assert not frozen.flags.writeable
    raw = transfer.RawColumns.from_columns([col, frozen])
    out = transfer.to_device(raw, 10, dlpack=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.concatenate([np.stack([col, col], axis=1), np.zeros((2, 2))]))
    assert raw._host is None
    assert transfer.ingest_stats()["dlpack_transfers"] == 1
    host = np.full((3, 9, 2), np.nan, np.float32)
    transfer.stage(raw, host[1], dlpack=True)
    np.testing.assert_array_equal(host[1], out.numpy()[:9])
    assert np.isnan(host[0]).all() and np.isnan(host[2]).all() and raw._host is None


def test_refusals_take_the_host_rung_and_count_their_reason():
    """A non-contiguous f32 column and a column of strings raise inside the
    rung: each takes the whole request to the host rung, with its reason
    counted, and JAX counts the non-contiguous one alike."""
    base = np.arange(40, dtype=np.float32)
    strided = transfer.RawColumns.from_columns([base[::2], base[1::2]])
    out = transfer.to_device(strided, dlpack=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.stack([base[::2], base[1::2]], axis=1))
    jax_transfer.to_device(jax_transfer.RawColumns.from_columns([base[::2], base[1::2]]), dlpack=True)
    assert transfer.ingest_stats() == jax_transfer.ingest_stats() == {
        "dlpack_transfers": 0, "host_transfers": 1, "dlpack_columns": 0, "fallback_reasons": {"ValueError": 1}}
    texts = transfer.RawColumns.from_columns([np.array(["1.5", "2"]), np.array([3.0, 4.0])])
    out = transfer.to_device(texts, dlpack=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), [[1.5, 3.0], [2.0, 4.0]])
    assert transfer.ingest_stats()["fallback_reasons"] == {"ValueError": 1, "TypeError": 1}
    # a payload without columns (a JSON request's matrix)
    transfer.to_device(transfer.RawColumns.from_matrix(np.ones((3, 2))), dlpack=True, device="cpu")
    assert transfer.ingest_stats()["fallback_reasons"]["no_columns"] == 1


def test_knobs(monkeypatch):
    assert ingest.compiled_enabled() and not ingest.dlpack_enabled("cpu")
    if torch.cuda.is_available():  # pragma: no cover - the card's machine
        assert ingest.dlpack_enabled("cuda")
    monkeypatch.setenv(ingest.INGEST_COMPILED_ENV, "0")
    monkeypatch.setenv(ingest.INGEST_DLPACK_ENV, "0")
    assert not ingest.compiled_enabled() and not ingest.dlpack_enabled("cuda")


class _Ctx:
    ingest = None


@pytest.mark.parametrize("case", ["ordered", "shuffled", "renamed"])
def test_arrow_stash_under_jax_conditions(collections, case):
    """``ctx.ingest`` holds X's wire columns (views of the body, in the
    model's tag order) for an index in order; nothing for a shuffled one
    (the decode sorts rows) or a positional rename (X's names do not key
    into the wire columns)."""
    from gordo_tpu_torch.server.fleet_store import FleetModelStore

    store = FleetModelStore(collections[1], torch.device("cpu"))
    resolution = store.fleet(collections[1]).resolution("machine-1")
    tags = TAGS["machine-1"]
    X = _request_frame(tags, 12, seed=3, dtype=np.float32)
    if case == "ordered":
        X = X.sort_index()
    if case == "renamed":
        X = X.sort_index()
        X.columns = [f"other-{i}" for i in range(len(tags))]
    ctx = _Ctx()
    frame, _ = views_base.arrow_frames(bytearray(jax_arrow.encode_request(X, None)), resolution, ctx=ctx)
    if case != "ordered":
        assert ctx.ingest is None
        return
    assert ctx.ingest.rows == 12 and ctx.ingest.width == len(tags)
    assert all(np.shares_memory(a, b) for a, b in zip(ctx.ingest.columns, frame.arrays()))
    np.testing.assert_array_equal(ctx.ingest.host_matrix(), np.asarray(frame.values, np.float32))


def test_parquet_stash(collections):
    from gordo_tpu_torch.server.fleet_store import FleetModelStore

    store = FleetModelStore(collections[1], torch.device("cpu"))
    resolution = store.fleet(collections[1]).resolution("machine-1")
    X = _request_frame(TAGS["machine-1"], 10, seed=4).sort_index()
    buf = io.BytesIO()
    pq.write_table(pa.Table.from_pandas(X), buf)
    ctx = _Ctx()
    frame, _ = views_base.parquet_frames(buf.getvalue(), None, resolution, ctx)
    np.testing.assert_array_equal(ctx.ingest.host_matrix(), np.asarray(frame.values, np.float32))
    # extra columns are dropped: the stash follows X's names
    ctx = _Ctx()
    server_utils.stash_raw_columns(ctx, {"b": np.ones(3), "a": np.zeros(3), "c": np.ones(3)}, [1, 2, 3], ["a", "b"])
    assert ctx.ingest.host_matrix().tolist() == [[0.0, 1.0]] * 3


@pytest.fixture
def engine_client(collections, monkeypatch):
    """A port app with its serving engine (batches of one, flushed at once)."""
    from werkzeug.test import Client

    from gordo_tpu_torch.server import build_app

    monkeypatch.setenv("GORDO_TPU_BATCHING", "1")
    app = build_app(collections[1], device="cpu",
                    serve_config=serve_engine.ServeConfig(max_size=1))
    yield Client(app), app
    app.engine.shutdown()


def _anomaly(client, name, X, y):
    response = client.post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction", data=jax_arrow.encode_request(X, y),
                           content_type=ARROW, headers={"Accept": ARROW})
    assert response.status_code == 200, response.get_data()
    return response.get_data()


def _bit_equal(a: pa.Table, b: pa.Table) -> None:
    """The same schema and every column the same bits (NaN where NaN;
    ``Table.equals`` holds NaN != NaN)."""
    assert a.schema.remove_metadata().equals(b.schema.remove_metadata())
    for i, field in enumerate(a.schema):
        x, y = a.column(i).to_numpy(), b.column(i).to_numpy()
        if x.dtype.kind == "f":
            assert x.tobytes() == y.tobytes(), field.name
        else:
            assert x.tolist() == y.tolist(), field.name


def _force_dlpack(monkeypatch, on: bool):
    """The rung the app takes: on the CPU the dlpack rung is taken only
    when asked for, so the test asks through the modules' knob readers."""
    for module in (serve_engine, fleet_store):
        monkeypatch.setattr(module, "dlpack_enabled", lambda device, _on=on: _on)


@pytest.mark.parametrize("name", ["machine-1", "machine-2"])
def test_arrow_answers_through_engine_equal_across_rungs_and_match_jax(clients, engine_client, monkeypatch, name):
    client, app = engine_client
    tags = TAGS[name]
    X = _request_frame(tags, 24, seed=80, dtype=np.float32).sort_index()
    y = _request_frame(tags, 24, seed=81).sort_index()
    _force_dlpack(monkeypatch, True)
    fast = _anomaly(client, name, X, y)
    stats = app.engine.stats()
    assert stats["requests"] >= 1 and stats["launches"] >= 1
    assert stats["ingest"]["dlpack_transfers"] == 1 and stats["ingest"]["dlpack_columns"] == len(tags)
    assert stats["ingest"]["compiled"] is True
    _force_dlpack(monkeypatch, False)
    host = _anomaly(client, name, X, y)
    assert transfer.ingest_stats()["host_transfers"] == 1
    _bit_equal(_read(fast), _read(host))
    expected = clients[0].post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction",
                               data=jax_arrow.encode_request(X, y), content_type=ARROW, headers={"Accept": ARROW})
    _same_table(_read(expected.get_data()), _read(fast))


def test_compiled_off_host_transforms(clients, engine_client, monkeypatch):
    """``GORDO_TPU_INGEST_COMPILED=0``: the bucket is host-transformed (no
    plan in K1) and answers as the compiled bucket does, within the port's
    f32 tolerance; the JAX app with the knob off answers alike."""
    client, app = engine_client
    tags = TAGS["machine-1"]
    X = _request_frame(tags, 24, seed=82, dtype=np.float32).sort_index()
    y = _request_frame(tags, 24, seed=83).sort_index()
    compiled = _anomaly(client, "machine-1", X, y)
    monkeypatch.setenv(ingest.INGEST_COMPILED_ENV, "0")
    fleet = app.store.fleet(app.store.collection_dir)
    spec = fleet.loaded_specs()["machine-1"]
    assert fleet.host_transformed(spec) and fleet.ingest_plan(spec) is None
    hosted = _anomaly(client, "machine-1", X, y)
    _same_table(_read(compiled), _read(hosted))
    expected = clients[0].post(f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction",
                               data=jax_arrow.encode_request(X, y), content_type=ARROW, headers={"Accept": ARROW})
    _same_table(_read(expected.get_data()), _read(hosted))
