"""The port's dataset layer (``gordo_tpu_torch/dataset/``, numpy) against
the JAX package's (``gordo_tpu/dataset/``, pandas) on the same configs.

``RandomDataProvider`` is bit for bit the JAX provider (stamps and values
``np.array_equal``). ``TimeSeriesDataset.get_data``: stamps equal as
int64 UTC nanoseconds, column names equal, values within rtol 1e-12 (a
bin's mean sums its readings in another order than pandas; measured
agreement is about 1e-15 relative). ``get_metadata()`` and ``to_dict()``
equal, their floats within the same rtol. Cases: the three
``examples/config.yaml`` machines (+01:00, +02:00 at 2min, +00:00), a
+05:30 machine at 1h (local-midnight bins fall on the half hour in UTC),
a list of aggregations, ``ffill``, a gap longer than the interpolation
limit, ``known_filter_periods``, the thresholds, and
``n_samples_threshold``; ``FileDataProvider`` on a wide CSV and a per-tag
directory (a naive-stamp file, a ``tag_column_map``)."""

import copy
import math

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.dataset.data_provider import RandomDataProvider as JaxRandomDataProvider
from gordo_tpu.dataset.datasets import GordoBaseDataset as JaxDataset
from gordo_tpu.dataset.exceptions import InsufficientDataError as JaxInsufficientDataError
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict_from_yaml
from gordo_tpu_torch.dataset import GordoBaseDataset, InsufficientDataError, RandomDataProvider, SensorTag
from gordo_tpu_torch.dataset.series import datetime_ns, parse_datetime

RTOL = 1e-12
RANDOM = {"type": "RandomDataProvider"}


def _close(got, want, path="") -> None:
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}/{i}")
    elif isinstance(want, float) and not math.isnan(want):
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)
    else:
        assert got == want or (got != got and want != want), (path, got, want)


def _both(config):
    return JaxDataset.from_dict(copy.deepcopy(config)), GordoBaseDataset.from_dict(copy.deepcopy(config))


def _assert_same_data(jax_dataset, dataset):
    X, y = jax_dataset.get_data()
    PX, Py, index = dataset.get_data()
    x_names, y_names = dataset.column_names()
    assert (x_names, y_names) == (list(X.columns), list(y.columns))
    np.testing.assert_array_equal([datetime_ns(i) for i in index], X.index.as_unit("ns").asi8)
    assert [i.isoformat() for i in index] == [i.isoformat() for i in X.index]
    np.testing.assert_allclose(PX, X.to_numpy(np.float64), rtol=RTOL)
    np.testing.assert_allclose(Py, y.to_numpy(np.float64), rtol=RTOL)
    _close(dataset.get_metadata(), jax_dataset.get_metadata())
    assert dataset.to_dict() == jax_dataset.to_dict()
    return PX


@pytest.mark.parametrize("tag", ["GRA-TAG 1", "t1", "ctag-07"])
@pytest.mark.parametrize("window", [("2016-11-07T09:11:30+01:00", "2016-11-14T03:01:00+01:00"),
                                    ("2020-01-01T00:00:00+05:30", "2020-01-09T00:00:00+05:30")])
def test_random_provider_is_bit_exact(tag, window):
    start, end = (parse_datetime(w) for w in window)
    kwargs = {"min_size": 200, "max_size": 900}
    (want,) = JaxRandomDataProvider(**kwargs).load_series(pd.Timestamp(start), pd.Timestamp(end), [tag])
    (got,) = RandomDataProvider(**kwargs).load_series(start, end, [SensorTag(tag)])
    np.testing.assert_array_equal(got.stamps, want.index.as_unit("ns").asi8)
    np.testing.assert_array_equal(got.values, want.to_numpy())
    assert got.tz.utcoffset(None) == want.index.tz.utcoffset(None)


@pytest.mark.parametrize("path", ["examples/config.yaml", "examples/config-file-data.yaml"])
def test_example_machines(path):
    """Each machine of the example configs, as both packages' normalized
    configs make them (the file-data example's CSV is not in the repo:
    its datasets are compared on their dicts)."""
    jax_config = JaxNormalizedConfig(jax_get_dict_from_yaml(path), "proj")
    from gordo_tpu_torch.workflow.config_elements.normalized_config import NormalizedConfig
    from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml

    config = NormalizedConfig(get_dict_from_yaml(path), "proj")
    for jax_machine, machine in zip(jax_config.machines, config.machines, strict=True):
        assert machine.dataset.to_dict() == jax_machine.dataset.to_dict()
        if "FileDataProvider" not in str(machine.dataset.to_dict()["data_provider"]):
            _assert_same_data(jax_machine.dataset, machine.dataset)


def _random(**extra):
    return {
        "train_start_date": "2020-01-01T00:00:00+00:00",
        "train_end_date": "2020-01-08T00:00:00+00:00",
        "tag_list": ["t1", "t2", "t3"],
        "data_provider": RANDOM,
        **extra,
    }


@pytest.mark.parametrize(
    "config",
    [
        _random(train_start_date="2020-01-01T03:17:00+05:30", train_end_date="2020-01-12T00:00:00+05:30",
                resolution="1h"),
        _random(resolution="30min", aggregation_methods=["mean", "max", "min", "std"],
                data_provider={"type": "RandomDataProvider", "min_size": 2000, "max_size": 3000}),
        _random(resolution="10T", interpolation_method="ffill", interpolation_limit="30min",
                data_provider={"type": "RandomDataProvider", "min_size": 60, "max_size": 80}),
        _random(known_filter_periods=[["2020-01-02T00:00:00+00:00", "2020-01-03T12:00:00+00:00"]],
                target_tag_list=["t2"]),
        _random(low_threshold=-30.0, high_threshold=30.0),
        _random(type="RandomDataset", resolution="2min", tags=["a", "b"], data_provider=None),
    ],
    ids=["plus-0530-1h", "aggregations", "ffill", "known-filter-periods", "thresholds", "random-dataset"],
)
def test_time_series_dataset_cases(config):
    if config.get("data_provider") is None:
        config.pop("data_provider")
        config.pop("tag_list")
    jax_dataset, dataset = _both(config)
    X = _assert_same_data(jax_dataset, dataset)
    assert len(X) > 10


def test_plus_0530_bins_fall_on_the_half_hour():
    _, dataset = _both(_random(train_start_date="2020-01-01T03:17:00+05:30",
                               train_end_date="2020-01-12T00:00:00+05:30", resolution="1h"))
    _, _, index = dataset.get_data()
    assert {datetime_ns(i) // 60_000_000_000 % 60 for i in index} == {30}
    assert {i.minute for i in index} == {0}


def test_n_samples_threshold_raises():
    jax_dataset, dataset = _both(_random(n_samples_threshold=10**6))
    with pytest.raises(JaxInsufficientDataError):
        jax_dataset.get_data()
    with pytest.raises(InsufficientDataError, match="below threshold"):
        dataset.get_data()


def _write_wide(path, naive=False):
    rng = np.random.RandomState(3)
    stamps = pd.date_range("2020-01-01", periods=3 * 24 * 20, freq="3min", tz=None if naive else "UTC")
    frame = pd.DataFrame({"time": stamps.strftime("%Y-%m-%d %H:%M:%S") if naive else stamps.map(pd.Timestamp.isoformat),
                          "col-a": 10 + rng.randn(len(stamps)), "tag b": 5 * rng.rand(len(stamps)),
                          "tag-c": rng.randn(len(stamps)).cumsum()})
    frame.loc[200:450, "tag-c"] = np.nan  # a gap of 12.5 hours, beyond the 8-hour limit
    frame.to_csv(path, index=False, float_format="%.17g")


def _file_config(path, **extra):
    return {
        "train_start_date": "2020-01-01T05:00:00+00:00",
        "train_end_date": "2020-01-03T17:00:00+00:00",
        "tag_list": ["TAG A", "tag b", "tag-c"],
        "data_provider": {"type": "FileDataProvider", "path": str(path), "timestamp_column": "time",
                          "tag_column_map": {"TAG A": "col-a"}},
        **extra,
    }


@pytest.mark.parametrize("naive", [False, True], ids=["aware", "naive"])
def test_file_provider_wide_csv(tmp_path, naive):
    path = tmp_path / "plant.csv"
    _write_wide(path, naive)
    jax_dataset, dataset = _both(_file_config(path, aggregation_methods=["mean", "median", "last"]))
    X = _assert_same_data(jax_dataset, dataset)
    assert 0 < len(X) < 360  # of 60 hours' bins, the gap's beyond the interpolation limit are gone


def test_file_provider_tag_directory(tmp_path):
    """One file a tag: ``<name>.csv`` of ``ts,value``; one file naive
    (read in ``tz``), one with a column map."""
    rng = np.random.RandomState(5)
    for name, offset, naive in (("TAG A", 0, False), ("tag b", 7, True), ("other-c", 13, False)):
        stamps = pd.date_range("2020-01-01", periods=1500, freq="4min", tz="UTC") + pd.Timedelta(minutes=offset)
        text = stamps.strftime("%Y-%m-%dT%H:%M:%S") if naive else stamps.map(pd.Timestamp.isoformat)
        pd.DataFrame({"ts": text, "value": 20 + rng.randn(len(stamps))}).to_csv(
            tmp_path / f"{name}.csv", index=False, float_format="%.17g")
    config = _file_config(tmp_path)
    config["data_provider"] = {"type": "FileDataProvider", "path": str(tmp_path), "tag_column_map": {"tag-c": "other-c"}}
    _assert_same_data(*_both(config))


def test_no_common_rows_is_insufficient_data(tmp_path):
    """Two tags whose readings do not overlap: the join leaves no row."""
    for name, start in (("TAG A", "2020-01-01"), ("tag b", "2020-01-03"), ("tag-c", "2020-01-01")):
        stamps = pd.date_range(start, periods=100, freq="10min", tz="UTC")
        pd.DataFrame({"ts": stamps.map(pd.Timestamp.isoformat), "value": np.arange(100.0)}).to_csv(
            tmp_path / f"{name}.csv", index=False)
    config = _file_config(tmp_path, train_start_date="2020-01-01T00:00:00+00:00",
                          train_end_date="2020-01-05T00:00:00+00:00")
    config["data_provider"] = {"type": "FileDataProvider", "path": str(tmp_path)}
    jax_dataset, dataset = _both(config)
    with pytest.raises(JaxInsufficientDataError):
        jax_dataset.get_data()
    with pytest.raises(InsufficientDataError):
        dataset.get_data()


@pytest.mark.parametrize("source", ["parquet", "influx", "row_filter"])
def test_parquet_and_influx_raise_not_implemented(tmp_path, source):
    """The three inputs the port once refused (``NotImplementedError``)
    now read what the JAX dataset reads: a wide parquet file, an InfluxDB
    read (the JAX side over ``tests/dataset/test_influx_provider.py``'s
    fake client, the port over HTTP to a server answering from it) and a
    ``row_filter``."""
    if source == "parquet":
        _write_wide(tmp_path / "plant.csv")
        frame = pd.read_csv(tmp_path / "plant.csv")
        frame["time"] = pd.to_datetime(frame["time"], format="ISO8601")
        frame.to_parquet(tmp_path / "plant.parquet")
        _assert_same_data(*_both(_file_config(tmp_path / "plant.parquet")))
    elif source == "influx":
        from gordo_tpu.dataset.data_provider import InfluxDataProvider as JaxInfluxDataProvider
        from tests.test_torch_influx import InfluxServer, RecordingClient, _seed, _uri

        fake = RecordingClient()
        _seed(fake, ["t1", "t2", "t3"], n=9 * 144)
        server = InfluxServer(fake)
        try:
            config = _random(train_start_date="2020-01-01T00:00:00+00:00",
                             train_end_date="2020-01-08T00:00:00+00:00")
            jax_dataset = JaxDataset.from_dict({**config, "data_provider": JaxInfluxDataProvider(
                measurement="sensors", client=fake)})
            dataset = GordoBaseDataset.from_dict({**config, "data_provider": {
                "type": "InfluxDataProvider", "measurement": "sensors", "uri": _uri(server)}})
            X, y = jax_dataset.get_data()
            PX, Py, index = dataset.get_data()
        finally:
            server.close()
        np.testing.assert_array_equal([datetime_ns(i) for i in index], X.index.as_unit("ns").asi8)
        np.testing.assert_allclose(PX, X.to_numpy(np.float64), rtol=RTOL)
        np.testing.assert_allclose(Py, y.to_numpy(np.float64), rtol=RTOL)
    else:
        jax_dataset, dataset = _both(_random(row_filter="t1 > 0 & t2 < t3 + 100"))
        _assert_same_data(jax_dataset, dataset)
        assert dataset.get_metadata()["filtered_rows"] == jax_dataset.get_metadata()["filtered_rows"]
