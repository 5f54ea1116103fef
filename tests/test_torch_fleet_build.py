"""The port's fleet build (``gordo_tpu_torch/parallel/fleet_build.py``)
against the JAX package's (``gordo_tpu/parallel/fleet_build.py``), end to
end on the CPU, and the scikit-learn stand-ins it uses against
scikit-learn.

Three machines of ``RandomDataset`` rows (the arrays the JAX machines
fetch themselves), two sharing a spec and a fit config, the third with
the reference's class paths, a row-shuffling detector, a validation
split and ``EarlyStopping`` (restore-best); both builds draw JAX's
randomness (the port through an injected source that derives init and
permutations as the JAX trainer does). Compared: feature and aggregate
thresholds, per fold too; every CV score key and value; the split
positions; final params; the ``metadata.json`` keys and the training
summary; then both apps' ``/anomaly/prediction`` over the two
collections.

Tolerances, measured on the CPU (torch 2.13, jax 0.9): params within
6e-8 (atol 1e-5), thresholds within 2e-7 relative (rtol 1e-5). CV
scores rtol 1e-5, atol 1e-5: the JAX builder's scikit-learn metrics run
in float32 on a float32 scaler's output, the port's numpy ones in
float64, 4e-7 relative apart. Served answers rtol 1e-5, atol 1e-5 (the
reconstruction of ~30-unit readings from params 6e-8 apart).
"""

import functools
import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.parallel import fleet_build as jax_fleet_build
from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu_torch import serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import metrics
from gordo_tpu_torch.models.anomaly.diff import rolling_min_max
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.model_selection import TimeSeriesSplit, shuffle_indices
from gordo_tpu_torch.parallel import fleet_build as port_fleet_build
from gordo_tpu_torch.server import build_app

PROJECT = "fleet-build-test"
REVISION = "1700000000000"
PARAM_ATOL, RTOL, ATOL = 1e-5, 1e-5, 1e-5

DATASET = {
    "type": "RandomDataset",
    "train_start_date": "2020-01-01T00:00:00+00:00",
    "train_end_date": "2020-01-05T00:00:00+00:00",
}
DETECTOR = {
    "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 2}},
        ]}}
    }
}
REFERENCE_DETECTOR = {
    "gordo.machine.model.anomaly.diff.DiffBasedAnomalyDetector": {
        "shuffle": True,
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo.machine.model.models.KerasAutoEncoder": {
                "kind": "feedforward_hourglass",
                "encoding_layers": 2,
                "epochs": 3,
                "validation_split": 0.1,
                "callbacks": [{"tensorflow.keras.callbacks.EarlyStopping": {
                    "monitor": "val_loss", "patience": 1, "min_delta": 10.0, "restore_best_weights": True}}],
            }},
        ]}},
    }
}
CONFIGS = [
    {"name": "m-a", "model": DETECTOR, "dataset": {**DATASET, "tag_list": ["t1", "t2", "t3"]}},
    {"name": "m-b", "model": DETECTOR, "dataset": {**DATASET, "tag_list": ["t4", "t5", "t6"]}},
    {"name": "m-c", "model": REFERENCE_DETECTOR, "dataset": {**DATASET, "tag_list": ["t7", "t8"]}},
]


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return jax_init(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX fleet trainer's randomness, for the port's trainer."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{name: (jax model, jax metadata.json, port model, port metadata.json)}``
    and the two collection directories."""
    root = tmp_path_factory.mktemp("fleet-build")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    jax_machines = [JaxMachine.from_config(c, project_name=PROJECT) for c in CONFIGS]
    jax_results = jax_fleet_build(jax_machines, output_dir=str(jax_dir))
    port_machines = []
    for config, machine in zip(CONFIGS, jax_machines):
        X, y = machine.dataset.get_data()
        port_machines.append(Machine.from_config(
            {**config, "dataset": machine.dataset.to_dict()}, PROJECT,
            data=(X.to_numpy(), y.to_numpy()), index=list(X.index),
        ))
    builder = port_fleet_build.FleetBuilder(port_machines, device="cpu", random=JaxRandom())
    forward = builder.trainer.predict_bucket
    builder.forwards = []  # the shape of each CV scoring forward

    def counted(spec, stacked, X):
        builder.forwards.append(X.shape)
        return forward(spec, stacked, X)

    builder.trainer.predict_bucket = counted
    port_results = builder.build(output_dir=str(port_dir))
    assert builder.build_errors == {}
    out = {}
    for (jax_model, machine), (port_model, _) in zip(jax_results, port_results):
        with open(jax_dir / machine.name / "metadata.json") as f:
            jax_meta = json.load(f)
        out[machine.name] = (jax_model, jax_meta, port_model, serializer.load_metadata(str(port_dir / machine.name)))
    return out, str(jax_dir), str(port_dir), builder


NAMES = [c["name"] for c in CONFIGS]


@pytest.mark.parametrize("name", NAMES)
def test_thresholds_match_jax(builds, name):
    jax_model, _, model, _ = builds[0][name]
    np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float), rtol=RTOL)
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
    assert model.aggregate_thresholds_per_fold_.keys() == jax_model.aggregate_thresholds_per_fold_.keys()
    np.testing.assert_allclose(list(model.aggregate_thresholds_per_fold_.values()),
                               list(jax_model.aggregate_thresholds_per_fold_.values()), rtol=RTOL)
    expected = jax_model.feature_thresholds_per_fold_.to_dict()
    assert list(model.feature_thresholds_per_fold_) == list(expected)
    for tag, folds in expected.items():
        assert list(model.feature_thresholds_per_fold_[tag]) == list(folds)
        np.testing.assert_allclose(list(model.feature_thresholds_per_fold_[tag].values()), list(folds.values()),
                                   rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_cv_scores_and_splits_match_jax(builds, name):
    _, jax_meta, _, meta = builds[0][name]
    jax_cv = jax_meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    cv = meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    assert list(cv) == list(jax_cv)
    assert cv["splits"] == jax_cv["splits"]
    assert list(cv["scores"]) == list(jax_cv["scores"])
    assert len(cv["scores"]) == 4 * (len(CONFIGS[NAMES.index(name)]["dataset"]["tag_list"]) + 1)
    for key, folds in jax_cv["scores"].items():
        assert list(cv["scores"][key]) == list(folds), key
        np.testing.assert_allclose(list(cv["scores"][key].values()), list(folds.values()), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_final_params_match_jax(builds, name):
    jax_model, _, model, _ = builds[0][name]
    jax_params = jax_model.base_estimator.steps[-1][1].params_
    params = model.base_estimator.estimator.params_
    assert list(params) == list(jax_params)
    for key, layer in jax_params.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(params[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_metadata_json_matches_jax(builds, name):
    _, jax_meta, _, meta = builds[0][name]
    assert list(meta) == list(jax_meta)
    for key in ("name", "project_name", "model", "dataset", "evaluation", "runtime"):
        assert meta[key] == jax_meta[key], key
    assert meta["metadata"]["user_defined"] == jax_meta["metadata"]["user_defined"]
    build, jax_build = meta["metadata"]["build_metadata"], jax_meta["metadata"]["build_metadata"]
    assert list(build) == list(jax_build)
    assert list(build["model"]) == list(jax_build["model"])
    assert build["model"]["model_offset"] == jax_build["model"]["model_offset"] == 0
    assert set(build["model"]["model_meta"]) == set(jax_build["model"]["model_meta"])
    assert build["model"]["model_meta"]["history"]["params"] == jax_build["model"]["model_meta"]["history"]["params"]
    training, jax_training = build["model"]["training"], jax_build["model"]["training"]
    assert list(training) == list(jax_training)
    for key, value in jax_training.items():
        if isinstance(value, float):
            np.testing.assert_allclose(training[key], value, rtol=RTOL, err_msg=key)
        else:
            assert training[key] == value, key
    assert list(build["robustness"]) == list(jax_build["robustness"])
    drift, jax_drift = build["drift_baseline"], jax_build["drift_baseline"]
    assert (drift["tags"], drift["n_samples"]) == (jax_drift["tags"], jax_drift["n_samples"])
    np.testing.assert_allclose(drift["feature_means"], jax_drift["feature_means"], rtol=1e-7)
    np.testing.assert_allclose(drift["feature_stds"], jax_drift["feature_stds"], rtol=1e-7)


def test_early_stopping_and_shuffle_reached_the_build(builds):
    """m-c's EarlyStopping stopped its final fit after two of three
    epochs, on both sides, and its detector trained on shuffled rows."""
    _, jax_meta, model, meta = builds[0]["m-c"]
    training = meta["metadata"]["build_metadata"]["model"]["training"]
    assert (training["epochs_run"], training["epochs_configured"], training["early_stop_epoch"]) == (2, 3, 2)
    assert training["final_val_loss"] is not None
    assert model.shuffle and jax_meta["metadata"]["build_metadata"]["model"]["model_meta"]["shuffle"]


def test_one_forward_per_spec_group(builds):
    """m-a and m-b share a spec: CV scoring ran two forwards in all, and
    the trainer trained one bucket per spec for the CV and for the final
    fit (fold members of one machine share its bucket)."""
    builder = builds[3]
    assert [shape[0] for shape in builder.forwards] == [6, 3]
    assert [shape[2] for shape in builder.forwards] == [3, 2]
    assert [f["members"] for f in builder.trainer.fits] == [6, 3, 2, 1]
    assert set(builder.phase_seconds) >= {"plan", "stage", "cv_train", "cv_predict", "cv_score", "final_fit",
                                          "assemble", "dump"}


@pytest.fixture(scope="module")
def clients(builds):
    _, jax_dir, port_dir, _ = builds
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = jax_dir
    try:
        yield Client(jax_build_app(config={"EXPECTED_MODELS": []})), Client(build_app(port_dir, device="cpu"))
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous


def _assert_same(expected, got, path="data"):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and list(got) == list(expected), path
        for key in expected:
            _assert_same(expected[key], got[key], f"{path}/{key}")
    elif isinstance(expected, float) and isinstance(got, float):
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == expected, path


@pytest.mark.parametrize("name", NAMES)
def test_served_anomalies_match_jax(clients, name, builds):
    jax_client, port_client = clients
    tags = CONFIGS[NAMES.index(name)]["dataset"]["tag_list"]
    rng = np.random.RandomState(NAMES.index(name))
    index = [f"2020-03-01T{i // 6:02d}:{i % 6 * 10:02d}:00+00:00" for i in range(24)]
    values = 20 + 15 * rng.rand(len(tags), len(index))
    frame = {tag: dict(zip(index, values[t].tolist())) for t, tag in enumerate(tags)}
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    answers = [c.post(url, data=json.dumps({"X": frame, "y": frame}), content_type="application/json")
               for c in (jax_client, port_client)]
    assert [a.status_code for a in answers] == [200, 200]
    expected, got = (json.loads(a.get_data())["data"] for a in answers)
    assert "anomaly-confidence" in got
    _assert_same(expected, got)


# -- the scikit-learn stand-ins ----------------------------------------------------


@pytest.mark.parametrize("n,splits", [(10, 3), (577, 3), (2000, 3), (101, 5), (9, 2)])
def test_time_series_split_matches_sklearn(n, splits):
    from sklearn.model_selection import TimeSeriesSplit as SkTimeSeriesSplit

    X = np.zeros((n, 2))
    for (train, test), (sk_train, sk_test) in zip(
        TimeSeriesSplit(splits).split(X), SkTimeSeriesSplit(splits).split(X), strict=True
    ):
        np.testing.assert_array_equal(train, sk_train)
        np.testing.assert_array_equal(test, sk_test)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(metrics.METRICS))
def test_metrics_match_sklearn(name, dtype):
    import sklearn.metrics

    rng = np.random.RandomState(4)
    y_true = rng.randn(60, 5).astype(dtype)
    y_pred = (y_true + 0.3 * rng.randn(60, 5)).astype(dtype)
    y_true[:, 1] = 2.0  # a constant column with error
    y_pred[:, 3] = y_true[:, 3]  # a perfect column
    y_true[:, 4] = y_pred[:, 4] = 1.0  # constant and perfect
    expected = getattr(sklearn.metrics, name)(y_true, y_pred, multioutput="raw_values")
    got = metrics.METRICS[name](y_true, y_pred)
    assert got.dtype == expected.dtype
    np.testing.assert_allclose(got, expected, rtol=1e-5 if dtype is np.float32 else 1e-12, atol=1e-6)


def test_metric_names_resolve():
    assert metrics.metrics_from_list(None) == list(metrics.METRICS.values())
    assert metrics.metrics_from_list(["sklearn.metrics.r2_score", "mean_squared_error"]) == [
        metrics.r2_score, metrics.mean_squared_error]
    with pytest.raises(NotImplementedError, match="max_error"):
        metrics.metrics_from_list(["max_error"])


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 0), (577, 0), (2000, 3)])
def test_shuffle_indices_match_sklearn(n, seed):
    from sklearn.utils import shuffle

    np.testing.assert_array_equal(shuffle_indices(n, seed), shuffle(np.arange(n), random_state=seed))


@pytest.mark.parametrize("case", ["plain", "nan-runs", "all-nan-column", "short"])
def test_rolling_min_max_matches_pandas_and_jax(case):
    rng = np.random.RandomState(2)
    values = rng.rand(40, 3)
    if case == "nan-runs":
        values[[3, 17, 18], 0] = np.nan
    elif case == "all-nan-column":
        values[:, 2] = np.nan
    elif case == "short":
        values = values[:4]
    expected = pd.DataFrame(values).rolling(6).min().max().to_numpy()
    got = rolling_min_max(values, 6)
    np.testing.assert_allclose(got, expected, equal_nan=True)
    np.testing.assert_allclose(got, JaxFleetBuilder._rolling_min_max(values, 6), equal_nan=True)
    np.testing.assert_allclose(rolling_min_max(values[:, 0], 6),
                               pd.Series(values[:, 0]).rolling(6).min().max(), equal_nan=True)


# -- the definition reader ---------------------------------------------------------


def test_definitions_are_read_as_strings():
    model = serializer.from_definition(REFERENCE_DETECTOR, device="cpu")
    estimator = model.base_estimator.estimator
    assert model.shuffle and estimator.kind == "feedforward_hourglass"
    callback = estimator.kwargs["callbacks"][0]
    assert isinstance(callback, EarlyStopping)
    assert (callback.monitor, callback.patience, callback.min_delta, callback.restore_best_weights) == (
        "val_loss", 1, 10.0, True)
    cv = serializer.from_definition({"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 4}}, device="cpu")
    assert isinstance(cv, TimeSeriesSplit) and cv.n_splits == 4
    default = serializer.from_definition("gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector", device="cpu")
    assert default.base_estimator.kind == "feedforward_hourglass"


@pytest.mark.parametrize(
    "definition,message",
    [
        ({"sklearn.decomposition.PCA": {"n_components": 2}}, "sklearn.decomposition.PCA"),
        ({"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": {"n_splits": 5}}, "n_splits"),
        ({"gordo.machine.model.anomaly.diff.DiffBasedKFCVAnomalyDetector": {"cv": "KFold"}}, "cv"),
        ({"gordo_tpu.models.JaxRawModelRegressor": {"kind": {"spec": []}}}, "JaxRawModelRegressor"),
        ({"gordo_tpu.models.JaxAutoEncoder": {"kind": "lstm_model"}}, "lstm_model"),
        ({"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_model", "callbacks": [
            {"tensorflow.keras.callbacks.ReduceLROnPlateau": {}}]}}, "ReduceLROnPlateau"),
        ({"sklearn.preprocessing.MinMaxScaler": {"clip": True}}, "clip"),
    ],
)
def test_unsupported_definitions_raise(definition, message):
    with pytest.raises(NotImplementedError, match=message):
        serializer.from_definition(definition, device="cpu")


def test_machine_checks_its_data():
    config = CONFIGS[0]
    with pytest.raises(ValueError, match="tags"):
        Machine.from_config(config, PROJECT, data=(np.zeros((5, 2)), None))
    with pytest.raises(ValueError, match="not a valid name"):
        Machine.from_config({**config, "name": "Bad_Name"}, PROJECT, data=(np.zeros((5, 3)), None))
    machine = Machine.from_config(config, PROJECT, data=(np.zeros((5, 3)), None))
    assert machine.dataset.y is machine.dataset.X and machine.dataset.to_dict()["resolution"] == "10min"


def _seeded_machines():
    rng = np.random.RandomState(7)
    return [Machine.from_config(c, PROJECT, data=(20 + 10 * rng.rand(120, len(c["dataset"]["tag_list"])), None))
            for c in CONFIGS]


@pytest.mark.parametrize("match,failed", [("m-b::fold*", {"m-b"}), ("m-b", {"m-a", "m-b"})], ids=["cv", "final-fit"])
def test_host_error_fails_only_its_machines(match, failed):
    """A host error escaping the trainer (a ValueError raised for m-b's
    members): in CV the chunk is halved until m-b's folds fail alone, and
    m-a builds as it does in a clean build; in the final fit it fails the
    config group, which m-a shares, as the JAX builder does. m-c, with a
    config of its own, always builds."""
    from gordo_tpu_torch.utils.faults import FaultRule, inject

    clean = {machine.name: model for model, machine in port_fleet_build.fleet_build(_seeded_machines(), device="cpu")}
    builder = port_fleet_build.FleetBuilder(_seeded_machines(), device="cpu")
    with inject(FaultRule("device_program", match=match, times=None, exc=ValueError)):
        results = builder.build()
    assert set(builder.build_errors) == failed
    assert all(isinstance(exc, ValueError) for exc in builder.build_errors.values())
    built = {machine.name: (model, machine) for model, machine in results}
    assert set(built) == set(NAMES) - failed
    for name, (model, _) in built.items():
        np.testing.assert_allclose(model.feature_thresholds_, clean[name].feature_thresholds_, rtol=RTOL)
        np.testing.assert_allclose(model.aggregate_threshold_, clean[name].aggregate_threshold_, rtol=RTOL)
    if match == "m-b::fold*":  # the chunk of m-a's and m-b's six folds halved twice
        assert builder.robustness["bucket_bisects"] >= 2
        assert built["m-a"][1].metadata["build_metadata"]["robustness"]["bucket_bisects"] >= 2
    else:
        assert builder.robustness["bucket_bisects"] == 0


def test_fleet_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    machine = Machine.from_config(CONFIGS[0], PROJECT, data=(np.zeros((5, 3)), None))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fleet_build.fleet_build([machine])


# -- KFCV: KFold folds, stitched errors, smoothed quantile thresholds --------------

KFCV_DETECTOR = {
    "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": {
        "window": 12,
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 2}},
        ]}},
    }
}
KFCV_CONFIGS = [
    {"name": "k-a", "model": KFCV_DETECTOR, "dataset": {**DATASET, "tag_list": ["t1", "t2", "t3"]}},
    {"name": "k-b", "model": KFCV_DETECTOR, "dataset": {**DATASET, "tag_list": ["t4", "t5", "t6"]}},
]


@pytest.fixture(scope="module")
def kfcv_builds(tmp_path_factory):
    """Both packages' builds of two KFCV machines (the port's from the
    same config dicts, its dataset fetching its own rows), JAX's
    randomness injected; ``{name: (jax model, jax metadata, model,
    metadata)}`` and the port's builder."""
    root = tmp_path_factory.mktemp("kfcv")
    jax_results = jax_fleet_build([JaxMachine.from_config(c, project_name=PROJECT) for c in KFCV_CONFIGS],
                                  output_dir=str(root / "jax"))
    builder = port_fleet_build.FleetBuilder([Machine.from_config(c, PROJECT) for c in KFCV_CONFIGS], device="cpu",
                                            random=JaxRandom())
    port_results = builder.build(output_dir=str(root / "port"))
    assert builder.build_errors == {}
    out = {}
    for (jax_model, machine), (model, _) in zip(jax_results, port_results, strict=True):
        with open(root / "jax" / machine.name / "metadata.json") as f:
            jax_meta = json.load(f)
        out[machine.name] = (jax_model, jax_meta, model, serializer.load_metadata(str(root / "port" / machine.name)))
    return out, builder, root


@pytest.mark.parametrize("name", [c["name"] for c in KFCV_CONFIGS])
def test_kfcv_build_matches_jax(kfcv_builds, name):
    """KFCV thresholds (the 0.99 quantile of 12-row rolling medians of the
    stitched fold errors) rtol 1e-5; every CV score rtol/atol 1e-5; the
    split metadata equal; final params atol 1e-5; ``model_meta``'s keys."""
    jax_model, jax_meta, model, meta = kfcv_builds[0][name]
    assert type(model).__name__ == "DiffBasedKFCVAnomalyDetector" and model.window == 12
    np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float), rtol=RTOL)
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
    jax_cv = jax_meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    cv = meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    assert cv["splits"] == jax_cv["splits"] and len(cv["splits"]) == 5 * 4
    assert list(cv["scores"]) == list(jax_cv["scores"])
    for key, folds in jax_cv["scores"].items():
        assert list(cv["scores"][key]) == list(folds), key
        np.testing.assert_allclose(list(cv["scores"][key].values()), list(folds.values()), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    jax_params = jax_model.base_estimator.steps[-1][1].params_
    for key, layer in jax_params.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(model.base_estimator.estimator.params_[key][leaf].numpy(), np.asarray(value),
                                       atol=PARAM_ATOL)
    model_meta, jax_model_meta = (m["metadata"]["build_metadata"]["model"]["model_meta"] for m in (meta, jax_meta))
    assert set(model_meta) == set(jax_model_meta)
    assert model_meta["threshold-percentile"] == jax_model_meta["threshold-percentile"] == 0.99


def test_kfcv_scoring_is_one_forward_per_spec_group(kfcv_builds):
    """Both machines share a spec: their 10 fold models are scored by one
    forward (one K1 launch on a card) of 10 members x 116 rows."""
    builder = kfcv_builds[1]
    assert [f["members"] for f in builder.trainer.fits] == [10, 2]
    assert set(builder.phase_seconds) >= {"data_fetch", "cv_predict", "cv_finalize"}


# -- from a YAML config: NormalizedConfig, the shard, the data fetch ---------------


def _trimmed_example() -> str:
    """``examples/config.yaml`` with 2 epochs and ct-23-0002's window cut to two days."""
    with open("examples/config.yaml") as f:
        text = f.read()
    return text.replace("epochs: 5", "epochs: 2").replace("2018-05-27T15:05:50+02:00", "2018-05-22T15:05:50+02:00")


@pytest.fixture(scope="module")
def config_builds(tmp_path_factory):
    """``examples/config.yaml`` (trimmed) built by both packages from the
    YAML text, through each one's ``NormalizedConfig`` and shard."""
    import io

    from gordo_tpu.cli.cli import _load_fleet_machines as jax_load_fleet_machines
    from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
    from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
    from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict
    from gordo_tpu_torch.cli.cli import load_fleet_machines
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = tmp_path_factory.mktemp("from-config")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    text = _trimmed_example()
    jax_shard = jax_machines_yaml(JaxNormalizedConfig(jax_get_dict(io.StringIO(text)), PROJECT).machines)
    jax_machines = jax_load_fleet_machines(jax_shard)
    jax_results = jax_fleet_build(jax_machines, output_dir=str(jax_dir))
    machines = load_fleet_machines(normalize(io.StringIO(text), PROJECT))
    builder = port_fleet_build.FleetBuilder(machines, device="cpu", random=JaxRandom())
    port_results = builder.build(output_dir=str(port_dir))
    assert builder.build_errors == {} and len(port_results) == len(jax_results) == 3
    return jax_machines, machines, jax_results, port_results, jax_dir, port_dir


def test_config_build_fetches_the_same_rows(config_builds):
    """Each machine's rows, fetched by each package's dataset: values
    rtol 1e-12, stamps equal."""
    jax_machines, machines = config_builds[:2]
    for jax_machine, machine in zip(jax_machines, machines, strict=True):
        X, _ = jax_machine.dataset.get_data()
        PX, _, index = machine.dataset.get_data()
        np.testing.assert_allclose(PX, X.to_numpy(np.float64), rtol=1e-12)
        assert [i.isoformat() for i in index] == [i.isoformat() for i in X.index]


def test_config_build_matches_jax(config_builds):
    """Thresholds rtol 1e-5, CV scores rtol/atol 1e-5, the split metadata
    equal; ``metadata.json``'s ``dataset`` equal key for key and
    ``build_metadata.dataset.dataset_meta`` (``x_hist`` included) equal,
    its floats within rtol 1e-12."""
    *_, jax_results, port_results, jax_dir, port_dir = config_builds
    for (jax_model, machine), (model, _) in zip(jax_results, port_results):
        np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float),
                                   rtol=RTOL)
        np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
        with open(jax_dir / machine.name / "metadata.json") as f:
            jax_meta = json.load(f)
        meta = serializer.load_metadata(str(port_dir / machine.name))
        assert meta["dataset"] == jax_meta["dataset"]
        jax_build, build = jax_meta["metadata"]["build_metadata"], meta["metadata"]["build_metadata"]
        assert list(build["dataset"]) == list(jax_build["dataset"])
        assert build["dataset"]["query_duration_sec"] > 0
        _assert_same(jax_build["dataset"]["dataset_meta"], build["dataset"]["dataset_meta"])
        jax_cv, cv = jax_build["model"]["cross_validation"], build["model"]["cross_validation"]
        assert cv["splits"] == jax_cv["splits"]
        for key, folds in jax_cv["scores"].items():
            np.testing.assert_allclose(list(cv["scores"][key].values()), list(folds.values()), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_config_build_serves_alike(config_builds, monkeypatch):
    """Both apps' ``/anomaly/prediction`` for each machine, on its own last
    48 fetched rows, rtol/atol 1e-5."""
    jax_machines, _, _, _, jax_dir, port_dir = config_builds
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
    both = Client(jax_build_app(config={"EXPECTED_MODELS": []})), Client(build_app(str(port_dir), device="cpu"))
    for machine in jax_machines:
        X, _ = machine.dataset.get_data()
        rows = X.iloc[-48:]
        frame = {tag: {t.isoformat(): float(v) for t, v in rows[tag].items()} for tag in rows.columns}
        url = f"/gordo/v0/{PROJECT}/{machine.name}/anomaly/prediction"
        answers = [c.post(url, data=json.dumps({"X": frame, "y": frame}), content_type="application/json")
                   for c in both]
        assert [a.status_code for a in answers] == [200, 200], machine.name
        expected, got = (json.loads(a.get_data())["data"] for a in answers)
        _assert_same(expected, got)


def test_kfcv_build_serves_alike(kfcv_builds, monkeypatch):
    """Both apps' ``/anomaly/prediction`` for a KFCV machine (its confidences
    from the quantile thresholds), rtol/atol 1e-5."""
    root = kfcv_builds[2]
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(root / "jax"))
    both = Client(jax_build_app(config={"EXPECTED_MODELS": []})), Client(build_app(str(root / "port"), device="cpu"))
    rng = np.random.RandomState(11)
    index = [f"2020-03-01T{i // 6:02d}:{i % 6 * 10:02d}:00+00:00" for i in range(36)]
    frame = {tag: dict(zip(index, (20 + 15 * rng.rand(len(index))).tolist())) for tag in ("t1", "t2", "t3")}
    url = f"/gordo/v0/{PROJECT}/k-a/anomaly/prediction"
    answers = [c.post(url, data=json.dumps({"X": frame, "y": frame}), content_type="application/json") for c in both]
    assert [a.status_code for a in answers] == [200, 200]
    expected, got = (json.loads(a.get_data())["data"] for a in answers)
    assert "anomaly-confidence" in got and "smooth-total-anomaly-scaled" not in got
    _assert_same(expected, got)
