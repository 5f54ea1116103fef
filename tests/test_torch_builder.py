"""The port's sequential build (``gordo_tpu_torch/builder/``) against the JAX
package's (``gordo_tpu/builder/``), on the CPU.

Three machines of ``RandomDataset`` rows, each fetched by both packages
from the same config: a MinMax + feedforward_hourglass detector
cross-validated by ``TimeSeriesSplit(3)``, a ``DiffBasedKFCVAnomalyDetector``
(with the evaluation's splitter, as the JAX ``ModelBuilder`` passes it) and
an LSTM autoencoder detector with a smoothing window. The port draws JAX's
randomness through an injected source (``JaxRandom``: init from the second
half of ``split(PRNGKey(seed))``, permutations from the first, as the JAX
``fit_single`` splits its key). Compared: final and per-fold thresholds,
every CV score, the splits, final params, the ``metadata.json`` tree (times
and dates apart) and the cache key. Then the cache, the CV modes,
``local_build``, ``create_model_builder``, the score lines and the
``build`` command's exit codes and reports.

Tolerances are the fleet parity tests': thresholds rtol 1e-5, CV scores
rtol 1e-5 and atol 1e-5, params atol 1e-5.
"""

import functools
import json

import jax
import numpy as np
import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.builder import local_build as jax_local_build
from gordo_tpu.cli import gordo_tpu_cli
from gordo_tpu.cli.cli import get_all_score_strings as jax_score_strings
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.nn import init_feedforward as jax_init_feedforward
from gordo_tpu.models.nn import init_lstm as jax_init_lstm
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder, create_model_builder, local_build
from gordo_tpu_torch.cli.cli import get_all_score_strings, main
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.spec import LSTMSpec
from gordo_tpu_torch.parallel.fleet import FleetTrainer
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.utils import disk_registry

PROJECT = "builder-test"
PARAM_ATOL, RTOL, ATOL = 1e-5, 1e-5, 1e-5

DATASET = {
    "type": "RandomDataset",
    "train_start_date": "2020-01-01T00:00:00+00:00",
    "train_end_date": "2020-01-03T00:00:00+00:00",
}


def _pipeline(estimator):
    return {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", estimator]}}


HOURGLASS = {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 2}}
CONFIGS = {
    "detector": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": _pipeline(HOURGLASS)}},
    "kfcv": {"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": {
        "window": 12, "base_estimator": _pipeline(HOURGLASS)}},
    "lstm": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"window": 10, "base_estimator": _pipeline(
        {"gordo_tpu.models.estimators.JaxLSTMAutoEncoder": {
            "kind": "lstm_hourglass", "lookback_window": 4, "epochs": 1, "batch_size": 16}})}},
}
NAMES = list(CONFIGS)
TAGS = {"detector": ["t1", "t2", "t3"], "kfcv": ["t4", "t5"], "lstm": ["t6", "t7", "t8"]}


def machine_config(name, **extra):
    return {"name": f"m-{name}", "model": CONFIGS[name], "dataset": {**DATASET, "tag_list": TAGS[name]}, **extra}


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return (jax_init_lstm if isinstance(spec, LSTMSpec) else jax_init_feedforward)(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX ``fit_single``'s randomness, for the port's trainer."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{name: (jax model, jax metadata.json, port model, port metadata.json)}``."""
    root = tmp_path_factory.mktemp("builds")
    out = {}
    for name in NAMES:
        jax_model, _ = JaxModelBuilder(JaxMachine.from_config(machine_config(name), PROJECT)).build(
            output_dir=root / "jax" / name)
        model, _ = ModelBuilder(Machine.from_config(machine_config(name), PROJECT), device="cpu",
                                random=JaxRandom()).build(output_dir=root / "port" / name)
        with open(root / "jax" / name / "metadata.json") as f:
            jax_meta = json.load(f)
        out[name] = (jax_model, jax_meta, model, serializer.load_metadata(str(root / "port" / name)))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_thresholds_match_jax(builds, name):
    jax_model, _, model, _ = builds[name]
    np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float), rtol=RTOL)
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
    if name == "kfcv":
        assert not hasattr(model, "feature_thresholds_per_fold_")
        return
    assert list(model.aggregate_thresholds_per_fold_) == list(jax_model.aggregate_thresholds_per_fold_)
    np.testing.assert_allclose(list(model.aggregate_thresholds_per_fold_.values()),
                               list(jax_model.aggregate_thresholds_per_fold_.values()), rtol=RTOL)
    for attr in ("feature_thresholds_per_fold_", "smooth_feature_thresholds_per_fold_"):
        expected = getattr(jax_model, attr).to_dict()
        got = getattr(model, attr)
        assert list(got) == list(expected), attr
        for column, folds in expected.items():
            assert list(got[column]) == list(folds)
            np.testing.assert_allclose(list(got[column].values()), list(folds.values()), rtol=RTOL)
    if name == "lstm":
        np.testing.assert_allclose(model.smooth_feature_thresholds_, jax_model.smooth_feature_thresholds_, rtol=RTOL)
        np.testing.assert_allclose(model.smooth_aggregate_threshold_, jax_model.smooth_aggregate_threshold_,
                                   rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_cv_scores_and_splits_match_jax(builds, name):
    _, jax_meta, _, meta = builds[name]
    jax_cv = jax_meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    cv = meta["metadata"]["build_metadata"]["model"]["cross_validation"]
    assert list(cv) == list(jax_cv)
    assert cv["splits"] == jax_cv["splits"]
    assert list(cv["scores"]) == list(jax_cv["scores"])
    assert len(cv["scores"]) == 4 * (len(TAGS[name]) + 1)
    for key, folds in jax_cv["scores"].items():
        assert list(cv["scores"][key]) == list(folds), key
        np.testing.assert_allclose(list(cv["scores"][key].values()), list(folds.values()), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_final_params_match_jax(builds, name):
    jax_model, _, model, _ = builds[name]
    jax_params = jax_model.base_estimator.steps[-1][1].params_
    params = model.base_estimator.estimator.params_
    assert list(params) == list(jax_params)
    for key, layer in jax_params.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(params[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_metadata_json_matches_jax(builds, name):
    _, jax_meta, _, meta = builds[name]
    assert list(meta) == list(jax_meta)
    for key in ("name", "project_name", "model", "dataset", "evaluation", "runtime"):
        assert meta[key] == jax_meta[key], key
    assert meta["metadata"]["user_defined"] == jax_meta["metadata"]["user_defined"]
    build, jax_build = meta["metadata"]["build_metadata"], jax_meta["metadata"]["build_metadata"]
    assert list(build) == list(jax_build)
    assert list(build["model"]) == list(jax_build["model"])
    assert build["model"]["model_offset"] == jax_build["model"]["model_offset"] == (3 if name == "lstm" else 0)
    assert build["model"]["model_builder_version"] == jax_build["model"]["model_builder_version"]
    assert set(build["model"]["model_meta"]) == set(jax_build["model"]["model_meta"])
    assert build["model"]["model_meta"]["history"]["params"] == jax_build["model"]["model_meta"]["history"]["params"]
    training, jax_training = build["model"]["training"], jax_build["model"]["training"]
    assert list(training) == list(jax_training)
    for key, value in jax_training.items():
        if isinstance(value, float):
            np.testing.assert_allclose(training[key], value, rtol=RTOL, err_msg=key)
        else:
            assert training[key] == value, key
    assert build["dataset"]["dataset_meta"] == jax_build["dataset"]["dataset_meta"]
    assert build["robustness"] == jax_build["robustness"]
    drift, jax_drift = build["drift_baseline"], jax_build["drift_baseline"]
    assert (drift["tags"], drift["n_samples"]) == (jax_drift["tags"], jax_drift["n_samples"])
    np.testing.assert_allclose(drift["feature_means"], jax_drift["feature_means"], rtol=1e-7)
    np.testing.assert_allclose(drift["feature_stds"], jax_drift["feature_stds"], rtol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_score_strings_match_jax(builds, name):
    _, jax_meta, _, meta = builds[name]
    expected = [line.split("=") for line in jax_score_strings(JaxMachine.from_dict(jax_meta))]
    got = [line.split("=") for line in get_all_score_strings(Machine.from_dict(meta))]
    assert [key for key, _ in got] == [key for key, _ in expected]
    np.testing.assert_allclose([float(v) for _, v in got], [float(v) for _, v in expected], rtol=RTOL, atol=ATOL)


# -- the cache -----------------------------------------------------------------------


def test_cache_key_matches_jax_and_follows_the_config():
    """The key is the JAX builder's for the same config (both packages are
    at version 0.1.0); another tag, model or evaluation changes it."""
    key = ModelBuilder.calculate_cache_key(Machine.from_config(machine_config("detector"), PROJECT))
    assert key == JaxModelBuilder.calculate_cache_key(JaxMachine.from_config(machine_config("detector"), PROJECT))
    assert key == ModelBuilder(Machine.from_config(machine_config("detector"), PROJECT), device="cpu").cache_key
    others = [
        {**machine_config("detector"), "dataset": {**DATASET, "tag_list": ["t1", "t2", "t9"]}},
        machine_config("kfcv") | {"name": "m-detector"},
        machine_config("detector", evaluation={"cv_mode": "build_only"}),
    ]
    for config in others:
        assert ModelBuilder.calculate_cache_key(Machine.from_config(config, PROJECT)) != key
        assert ModelBuilder.calculate_cache_key(Machine.from_config(config, PROJECT)) == \
            JaxModelBuilder.calculate_cache_key(JaxMachine.from_config(config, PROJECT))


def test_cache_hit_trains_nothing(tmp_path, monkeypatch):
    register, first, second = tmp_path / "register", tmp_path / "first", tmp_path / "second"
    builder = ModelBuilder(Machine.from_config(machine_config("detector"), PROJECT), device="cpu")
    builder.build(output_dir=first, model_register_dir=register)
    assert builder.cached_model_path == str(register / "builds" / builder.cache_key)
    assert disk_registry.get_value(register, builder.cache_key) == builder.cached_model_path

    def refuse(*_args, **_kwargs):
        raise AssertionError("a cache hit trained")

    monkeypatch.setattr(FleetTrainer, "fit_single", refuse)
    hit = ModelBuilder(Machine.from_config(machine_config("detector"), PROJECT), device="cpu")
    model, machine = hit.build(output_dir=second, model_register_dir=register)
    assert hit.cached_model_path == builder.cached_model_path
    assert "date_of_retrieval" in machine.metadata["user_defined"]
    assert (second / "model.pkl").read_bytes() == (first / "model.pkl").read_bytes()
    assert model.aggregate_threshold_ == serializer.load(str(first), "cpu").aggregate_threshold_
    with pytest.raises(AssertionError, match="trained"):  # replace_cache forgets the key and builds
        ModelBuilder(Machine.from_config(machine_config("detector"), PROJECT), device="cpu").build(
            model_register_dir=register, replace_cache=True)


def test_stale_registry_key_is_deleted(tmp_path):
    builder = ModelBuilder(Machine.from_config(machine_config("detector"), PROJECT), device="cpu")
    disk_registry.write_key(tmp_path, builder.cache_key, str(tmp_path / "gone"))
    assert ModelBuilder.probe_cache(builder.machine, tmp_path) is None
    assert disk_registry.get_value(tmp_path, builder.cache_key) is not None  # the probe only reads
    assert builder.check_cache(tmp_path) is None
    assert disk_registry.get_value(tmp_path, builder.cache_key) is None


# -- the CV modes -----------------------------------------------------------------


def test_cross_val_only_fits_nothing():
    model, machine = ModelBuilder(Machine.from_config(
        machine_config("detector", evaluation={"cv_mode": "cross_val_only"}), PROJECT), device="cpu").build()
    built = machine.metadata["build_metadata"]["model"]
    assert model.base_estimator.estimator.params_ is None and model.aggregate_threshold_ is not None
    assert len(built["cross_validation"]["scores"]) == 16 and built["cross_validation"]["splits"]
    assert built["model_training_duration_sec"] is None and built["model_creation_date"] is None
    _, jax_machine = JaxModelBuilder(JaxMachine.from_config(
        machine_config("detector", evaluation={"cv_mode": "cross_val_only"}), PROJECT)).build()
    assert list(machine.metadata["build_metadata"]) == list(jax_machine.metadata.build_metadata.to_dict())
    assert machine.metadata["build_metadata"]["drift_baseline"]["n_samples"] == 0


def test_build_only_runs_no_cv():
    model, machine = ModelBuilder(Machine.from_config(
        machine_config("detector", evaluation={"cv_mode": "build_only"}), PROJECT), device="cpu").build()
    built = machine.metadata["build_metadata"]["model"]
    assert built["cross_validation"] == {"scores": {}, "cv_duration_sec": None, "splits": {}}
    assert model.aggregate_threshold_ is None and model.base_estimator.estimator.params_ is not None
    assert built["model_training_duration_sec"] > 0 and built["training"]["epochs_run"] == 2


# -- local_build, the builder class, the build command ----------------------------------

LOCAL_CONFIG = """
machines:
  - name: machine-a
    dataset:
      type: RandomDataset
      train_start_date: "2020-01-01T00:00:00+00:00"
      train_end_date: "2020-01-03T00:00:00+00:00"
      tag_list: [tag-1, tag-2]
    model:
      gordo_tpu.models.JaxAutoEncoder:
        kind: feedforward_hourglass
        encoding_layers: 1
        epochs: 1
"""


def test_local_build_matches_jax():
    (model, machine), = list(local_build(LOCAL_CONFIG, device="cpu", random=JaxRandom()))
    (jax_model, jax_machine), = list(jax_local_build(LOCAL_CONFIG))
    assert machine.name == jax_machine.name == "machine-a"
    X, _, _ = machine.dataset.get_data()
    assert model.predict(X).shape == (len(X), 2)
    for key, layer in jax_model.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(model.params_[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL)
    scores = machine.metadata["build_metadata"]["model"]["cross_validation"]["scores"]
    jax_scores = jax_machine.metadata.build_metadata.model.cross_validation.scores
    assert list(scores) == list(jax_scores)
    np.testing.assert_allclose(scores["r2-score"]["fold-mean"], jax_scores["r2-score"]["fold-mean"], rtol=RTOL)


class CountingBuilder(ModelBuilder):
    """A ``--model-builder-class`` plug-in."""


def test_create_model_builder():
    assert create_model_builder(None) is ModelBuilder
    assert create_model_builder(f"{__name__}.CountingBuilder") is CountingBuilder
    with pytest.raises(ValueError, match="not a subclass"):
        create_model_builder("gordo_tpu_torch.models.preprocessing.MinMaxScaler")


def test_build_command_builds_a_servable_artifact(tmp_path, capsys):
    out = tmp_path / "out"
    config = json.dumps({**machine_config("detector"), "project_name": PROJECT})
    code = main(["build", config, str(out), "--device", "cpu", "--print-cv-scores",
                 "--model-builder-class", f"{__name__}.CountingBuilder"])
    assert code == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 16 * 7 and lines[0].startswith("explained-variance-score-t1_fold-mean=")
    client = Client(build_app(str(tmp_path), device="cpu"))
    assert json.loads(client.get(f"/gordo/v0/{PROJECT}/models").get_data())["models"] == ["out"]


@pytest.mark.parametrize("dataset,code", [
    ({"train_start_date": "2020-01-01", "train_end_date": "2020-01-03"}, 100),
    ({"tag_list": []}, None),
], ids=["tz-naive-dates", "no-tags"])
def test_build_command_failures_match_jax(tmp_path, dataset, code):
    """A bad machine exits with the JAX command's code, and writes its
    report: the same type, the message the JAX one without its note on the
    reference project."""
    config = json.dumps({**machine_config("detector"), "project_name": PROJECT,
                         "dataset": {**DATASET, "tag_list": TAGS["detector"], **dataset}})
    reports = tmp_path / "jax.json", tmp_path / "port.json"
    jax_result = CliRunner().invoke(gordo_tpu_cli, ["build", config, str(tmp_path / "jax"),
                                                    "--exceptions-reporter-file", str(reports[0])])
    port_code = main(["build", config, str(tmp_path / "port"), "--device", "cpu",
                      "--exceptions-reporter-file", str(reports[1])])
    assert port_code == jax_result.exit_code != 0
    if code is not None:
        assert port_code == code
    report, jax_report = (json.loads(path.read_text()) for path in reports[::-1])
    assert list(report) == list(jax_report) == ["type", "message"]
    assert report["type"] == jax_report["type"]
    assert jax_report["message"].startswith(report["message"])


def test_build_command_refuses_model_parameters(tmp_path, capsys):
    """``--model-parameter`` is taken since the port renders templates; a
    name the templated model uses and no parameter gives is refused as the
    JAX command refuses it: exit 2, ``Model parameter missing value!``."""
    model = "gordo_tpu.models.JaxAutoEncoder:\n  kind: feedforward_hourglass\n  epochs: {{ epochs }}\n"
    config = json.dumps({**machine_config("detector"), "project_name": PROJECT, "model": model})
    code = main(["build", config, str(tmp_path / "port"), "--device", "cpu", "--model-parameter", "batch,3"])
    assert code == 2
    assert "ValueError: Model parameter missing value!" in capsys.readouterr().err
    jax = CliRunner().invoke(gordo_tpu_cli, ["build", config, str(tmp_path / "jax"), "--model-parameter", "batch,3"])
    assert jax.exit_code == code
