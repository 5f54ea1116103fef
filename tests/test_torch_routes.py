"""Units of the port's JSON serving surface against the JAX package's on
the CPU: the smoothing of the ``smooth-*`` columns (numpy against
pandas), the ``Accept`` header's qualities (against werkzeug's parse),
the ``EXPECTED_MODELS`` reader (against ``yaml.safe_load``), the
builder droppings a revision listing skips, and the store's revision
bound. The routes themselves are held to the JAX server in
``tests/test_torch_serving.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from werkzeug.test import EnvironBuilder
from werkzeug.wrappers import Request

from gordo_tpu.serializer import serializer as jax_serializer
from gordo_tpu.server.wire import assemble as jax_assemble
from gordo_tpu.server.wire import negotiate as jax_negotiate
from gordo_tpu_torch import serializer
from gordo_tpu_torch.server.app import parse_expected_models
from gordo_tpu_torch.server.fleet_store import FleetModelStore
from gordo_tpu_torch.server.wire import assemble, negotiate


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("shape", [(40,), (40, 3)], ids=["1d", "2d"])
@pytest.mark.parametrize("method", ["smm", "sma", "ewma"])
def test_smooth_matches_pandas(method, shape, nan):
    """The port's numpy ``_smooth`` against the JAX package's pandas one,
    NaN where pandas has NaN, at rtol 1e-12 elsewhere."""
    values = np.random.RandomState(len(shape) + 2 * nan).rand(*shape) * 3
    if nan:
        values.flat[[0, 9]] = np.nan  # before any reading, and inside the series
    model = SimpleNamespace(window=6, smoothing_method=method)
    expected = jax_assemble._smooth(model, values)
    got = assemble._smooth(model, values)
    assert got.shape == expected.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expected))
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0)


def test_smooth_short_and_unknown():
    model = SimpleNamespace(window=6, smoothing_method="sma")
    assert np.isnan(assemble._smooth(model, np.ones((4, 2)))).all()
    with pytest.raises(ValueError, match="smoothing_method"):
        assemble._smooth(SimpleNamespace(window=6, smoothing_method="median"), np.ones(8))


@pytest.mark.parametrize(
    "header",
    [
        "application/json",
        "text/csv",
        "*/*;q=0.1, text/html",
        "application/*;q=0.5, application/x-parquet;q=0.4",
        "application/vnd.apache.arrow.stream;q=0.9, application/json;q=0.3",
        "application/x-parquet, application/json",
        "application/json;q=2, text/csv",
        "application/json;q=abc",
        "application/json; charset=utf-8",
        "APPLICATION/JSON;Q=0.7",
    ],
)
def test_accept_qualities_match_werkzeug(header):
    request = Request(EnvironBuilder(headers={"Accept": header}).get_environ())
    assert negotiate.accept_qualities(header) == jax_negotiate._accept_qualities(request)


@pytest.mark.parametrize(
    "raw",
    ['["machine-1", "machine-2"]', "[machine-1, machine-2]", "[ a ,b-2 ]", "[]", "[x.y_z]"],
)
def test_expected_models_as_yaml_reads_them(raw):
    assert parse_expected_models(raw) == yaml.safe_load(raw)


@pytest.mark.parametrize(
    "raw", ["", "machine-1", '{"a": 1}', "[1, 2]", "[true, a]", "[2020-01-01]", "[a b]", "[a, , b]", "[.5]", "[null]"]
)
def test_expected_models_refuses_what_it_would_guess(raw):
    with pytest.raises(ValueError, match="EXPECTED_MODELS"):
        parse_expected_models(raw)


def test_expected_models_unset_is_empty():
    assert parse_expected_models(None) == []


@pytest.mark.parametrize(
    "name",
    ["machine-1", "build_state.json", ".build_state.json.events", "build_trace.jsonl.2", "serve_trace-41.jsonl",
     "serve_trace-41.jsonl.3", "fleet_health-7.d", "fleet_health.d", "rollups", "slos.toml", "slo_state.json",
     ".machine-1.tmp-ab12", ".hidden", "build_status.json", "fleet_health-3.json"],
)
def test_builder_droppings_match_jax(name):
    assert serializer.is_builder_dropping(name) == jax_serializer.is_builder_dropping(name)
    assert serializer.is_staging_dir(name) == jax_serializer.is_staging_dir(name)


def test_list_model_dirs_skips_droppings(tmp_path):
    for entry in ("machine-1", "rollups", "fleet_health-3.d", ".machine-2.tmp-1", "machine-0"):
        (tmp_path / entry).mkdir()
    (tmp_path / "build_state.json").write_text("{}")
    assert serializer.list_model_dirs(str(tmp_path)) == jax_serializer.list_model_dirs(str(tmp_path)) == [
        "machine-0", "machine-1"]


@pytest.mark.parametrize("raw,bound", [(None, 2), ("3", 3), ("0", 2), ("-1", 2), ("many", 2)])
def test_n_cached_revisions(monkeypatch, tmp_path, raw, bound):
    if raw is None:
        monkeypatch.delenv("N_CACHED_REVISIONS", raising=False)
    else:
        monkeypatch.setenv("N_CACHED_REVISIONS", raw)
    assert FleetModelStore(str(tmp_path), torch.device("cpu")).max_revisions == bound

